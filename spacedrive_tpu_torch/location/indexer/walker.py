"""Filesystem walk for the indexing pass.

Counterpart of `spacedrive_tpu/location/indexer/walker.py` with the parts
of `files/isolated_path.py` and `location/indexer/rules.py` it needs: a
breadth-first walk over a to-walk queue (ref:core/src/location/indexer/
walk.rs:119-200), per-entry rule application with the accept-by-children
state machine (walk.rs:476-586), ancestor backfill (walk.rs:616-661) and
the symlink skip. There is no library DB in this slice, so there are no
DB fetchers: every accepted entry is new.
"""

from __future__ import annotations

import enum
import os
import re
from dataclasses import dataclass
from typing import Sequence


# --- paths (files/isolated_path.py) ------------------------------------------


def separate_name_and_extension(filename: str) -> tuple[str, str]:
    """('archive.tar', 'gz') for 'archive.tar.gz'; hidden files like
    '.env' have no extension."""
    stem, dot, ext = filename.rpartition(".")
    if not dot or not stem or not ext:
        return filename, ""
    return stem, ext


@dataclass(frozen=True)
class WalkedEntry:
    """One accepted entry: where it is, and the stat facts the pass uses."""

    path: str
    relative_path: str  # "/"-separated, relative to the walk root
    is_dir: bool
    extension: str  # without the dot; "" for directories
    size_in_bytes: int
    inode: int


def _entry(root: str, path: str, is_dir: bool, st: os.stat_result) -> WalkedEntry:
    rel = os.path.relpath(path, root).replace(os.sep, "/")
    ext = "" if is_dir else separate_name_and_extension(os.path.basename(path))[1]
    return WalkedEntry(path, rel, is_dir, ext, 0 if is_dir else st.st_size, st.st_ino)


# --- rules (location/indexer/rules.py) ---------------------------------------


class RuleKind(enum.IntEnum):
    ACCEPT_FILES_BY_GLOB = 0
    REJECT_FILES_BY_GLOB = 1
    ACCEPT_IF_CHILDREN_DIRECTORIES_ARE_PRESENT = 2
    REJECT_IF_CHILDREN_DIRECTORIES_ARE_PRESENT = 3


def glob_to_regex(glob: str) -> str:
    """globset-syntax glob → anchored regex. `*` and `?` may cross `/`
    (globset's default literal_separator=false), `{a,b}` alternates,
    `[...]` is a class, `**/` also matches the empty prefix."""
    return _translate(glob) + r"\Z"


def _translate(glob: str) -> str:
    i, n = 0, len(glob)
    out: list[str] = []
    while i < n:
        c = glob[i]
        if c == "*":
            if glob[i:i + 2] == "**" and glob[i + 2:i + 3] == "/":
                out.append("(?:.*/)?")
                i += 3
            else:
                out.append(".*")
                i += 2 if glob[i:i + 2] == "**" else 1
        elif c == "?":
            out.append(".")
            i += 1
        elif c == "[":
            j = i + 1
            if j < n and glob[j] in "!^":
                j += 1
            if j < n and glob[j] == "]":
                j += 1
            while j < n and glob[j] != "]":
                j += 1
            if j >= n:
                out.append(re.escape(c))
                i += 1
            else:
                cls = glob[i + 1:j]
                if cls.startswith("!"):
                    cls = "^" + cls[1:]
                out.append(f"[{cls}]")
                i = j + 1
        elif c == "{":
            j = i + 1
            depth = 1
            while j < n and depth:
                if glob[j] == "{":
                    depth += 1
                elif glob[j] == "}":
                    depth -= 1
                j += 1
            if depth:
                out.append(re.escape(c))
                i += 1
            else:
                parts = _split_alternation(glob[i + 1:j - 1])
                out.append("(?:" + "|".join(_translate(p) for p in parts) + ")")
                i = j
        else:
            out.append(re.escape(c))
            i += 1
    return "".join(out)


def _split_alternation(inner: str) -> list[str]:
    parts, depth, cur = [], 0, []
    for ch in inner:
        if ch == "{":
            depth += 1
        elif ch == "}":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return parts


@dataclass
class RulePerKind:
    kind: RuleKind
    params: list[str]  # globs or child-dir names

    def __post_init__(self) -> None:
        self._res = [re.compile(glob_to_regex(g)) for g in self.params]

    def apply(self, path: str) -> bool:
        """Whether `path` passes: an accept-glob passes iff it matches, a
        reject-glob iff it does not; the children rules inspect the
        directory's entries (ref:rules/mod.rs:430-560)."""
        if self.kind in (RuleKind.ACCEPT_FILES_BY_GLOB, RuleKind.REJECT_FILES_BY_GLOB):
            p = path.replace(os.sep, "/")
            matched = any(r.match(p) for r in self._res)
            return matched if self.kind == RuleKind.ACCEPT_FILES_BY_GLOB else not matched
        has_child = _dir_has_children(path, set(self.params))
        if self.kind == RuleKind.ACCEPT_IF_CHILDREN_DIRECTORIES_ARE_PRESENT:
            return has_child
        return not has_child


def _dir_has_children(path: str, names: set[str]) -> bool:
    try:
        if not os.path.isdir(path):
            return False
        with os.scandir(path) as it:
            return any(e.name in names and e.is_dir(follow_symlinks=False) for e in it)
    except OSError:
        return False


def no_os_protected() -> list[RulePerKind]:
    """The one system rule a new location gets by default
    (ref:rules/seed.rs, "No OS protected")."""
    return [
        RulePerKind(
            RuleKind.REJECT_FILES_BY_GLOB,
            [
                "**/.spacedrive",
                "**/*~",
                "**/.fuse_hidden*",
                "**/.directory",
                "**/.Trash-*",
                "**/.nfs*",
                "/{dev,sys,proc}",
                "/{run,var,boot}",
                "**/lost+found",
            ],
        )
    ]


def _apply_all(rules: Sequence[RulePerKind], path: str) -> dict[RuleKind, list[bool]]:
    out: dict[RuleKind, list[bool]] = {}
    for rule in rules:
        out.setdefault(rule.kind, []).append(rule.apply(path))
    return out


# --- walk ----------------------------------------------------------------------


def walk(root: str | os.PathLike, rules: Sequence[RulePerKind] | None = None) -> list[WalkedEntry]:
    """Full recursive walk from `root` with `rules` (default: the
    location defaults, `no_os_protected`). Returns the accepted entries,
    directories included, in walk order; the root itself is not one."""
    root = os.path.normpath(os.fspath(root))
    rules = no_os_protected() if rules is None else list(rules)
    to_walk: list[tuple[str, bool | None]] = [(root, None)]
    indexed: dict[str, WalkedEntry] = {}
    while to_walk:
        path, parent_accepted_by_children = to_walk.pop(0)
        try:
            dir_entries = list(os.scandir(path))
        except OSError:
            continue
        for dirent in dir_entries:
            accept_by_children_dir = parent_accepted_by_children
            current = dirent.path
            per_kind = _apply_all(rules, current)
            if not all(per_kind.get(RuleKind.REJECT_FILES_BY_GLOB, [])):
                continue
            try:
                st = dirent.stat(follow_symlinks=False)
                if dirent.is_symlink():
                    continue  # symlinks hard-ignored (ref:walk.rs:540)
                is_dir = dirent.is_dir(follow_symlinks=False)
            except OSError:
                continue
            if is_dir:
                if not all(per_kind.get(RuleKind.REJECT_IF_CHILDREN_DIRECTORIES_ARE_PRESENT, [])):
                    continue
                accepts = per_kind.get(RuleKind.ACCEPT_IF_CHILDREN_DIRECTORIES_ARE_PRESENT)
                if accepts is not None:
                    if any(accepts):
                        accept_by_children_dir = True
                    if accept_by_children_dir is None:
                        accept_by_children_dir = False
                to_walk.append((current, accept_by_children_dir))
            accepts = per_kind.get(RuleKind.ACCEPT_FILES_BY_GLOB)
            if accepts is not None and not any(accepts):
                continue
            if accept_by_children_dir is None or accept_by_children_dir:
                indexed[current] = _entry(root, current, is_dir, st)
                # ancestor backfill up to (not including) the root
                ancestor = os.path.dirname(current)
                while ancestor != root and len(ancestor) > len(root) and ancestor not in indexed:
                    try:
                        indexed[ancestor] = _entry(root, ancestor, True, os.stat(ancestor))
                    except OSError:
                        pass
                    ancestor = os.path.dirname(ancestor)
    return list(indexed.values())
