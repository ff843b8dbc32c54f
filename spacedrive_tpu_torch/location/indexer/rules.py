"""Indexer rule engine.

Parity: ref:core/src/location/indexer/rules/mod.rs —
four rule kinds (:154-158), per-kind apply semantics (:430-560), and
the seeded system rules (`seed.rs:42-215`: no_os_protected, no_hidden,
no_git, only_images with fixed pub_ids uuid(0..3)).

Globs use globset syntax (``**``, ``*``, ``?``, ``[...]``, ``{a,b}``),
compiled to regexes here.

Counterpart of `spacedrive_tpu/location/indexer/rules.py`; the rule
code the port's walker carried before the library DB now lives here.
"""

from __future__ import annotations

import enum
import os
import re
import uuid
from dataclasses import dataclass, field
from typing import Sequence

from ...db.database import now_iso
from ...utils.msgpack_codec import packb, unpackb


class RuleKind(enum.IntEnum):
    ACCEPT_FILES_BY_GLOB = 0
    REJECT_FILES_BY_GLOB = 1
    ACCEPT_IF_CHILDREN_DIRECTORIES_ARE_PRESENT = 2
    REJECT_IF_CHILDREN_DIRECTORIES_ARE_PRESENT = 3


def glob_to_regex(glob: str) -> str:
    """globset-syntax glob -> regex string (anchored).

    Semantics follow the globset crate with its DEFAULT settings (the
    reference parses plain `Glob`s, ref:rules/mod.rs:187-195): `*` and
    `?` MAY cross `/` (literal_separator=false), so `*.jpg` matches any
    absolute path ending in .jpg and `**/.*` rejects anything under a
    hidden component; `{a,b}` alternates; `[...]` is a class; `**/`
    also matches the empty prefix.
    """
    return _translate(glob) + r"\Z"


def _translate(glob: str) -> str:
    i, n = 0, len(glob)
    out: list[str] = []
    while i < n:
        c = glob[i]
        if c == "*":
            if glob[i:i + 2] == "**" and glob[i + 2:i + 3] == "/":
                # "**/" -> any (possibly empty) directory prefix
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
                inner = glob[i + 1:j - 1]
                parts = _split_alternation(inner)
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


class GlobSet:
    """Compiled set of globs; matches if any matches. Like globset, a
    relative pattern matches the *full* path only — so system rules use
    `**/` prefixes to hit any depth."""

    def __init__(self, globs: Sequence[str]):
        self.globs = list(globs)
        self._res = [re.compile(glob_to_regex(g)) for g in globs]

    def is_match(self, path: str) -> bool:
        p = path.replace(os.sep, "/")
        return any(r.match(p) for r in self._res)


@dataclass
class RulePerKind:
    kind: RuleKind
    params: list[str]  # globs or child-dir names
    _glob_set: GlobSet | None = field(default=None, repr=False, compare=False)

    def __post_init__(self) -> None:
        if self.kind in (RuleKind.ACCEPT_FILES_BY_GLOB, RuleKind.REJECT_FILES_BY_GLOB):
            self._glob_set = GlobSet(self.params)

    def apply(self, path: str) -> tuple[RuleKind, bool]:
        """(kind, passed). Semantics per ref:rules/mod.rs:430-560:
        accept-glob passes iff it matches; reject-glob passes iff it
        does NOT match; children rules inspect the dir's entries."""
        if self.kind == RuleKind.ACCEPT_FILES_BY_GLOB:
            return self.kind, self._glob_set.is_match(path)
        if self.kind == RuleKind.REJECT_FILES_BY_GLOB:
            return self.kind, not self._glob_set.is_match(path)
        has_child = _dir_has_children(path, set(self.params))
        if self.kind == RuleKind.ACCEPT_IF_CHILDREN_DIRECTORIES_ARE_PRESENT:
            return self.kind, has_child
        return self.kind, not has_child


def _dir_has_children(path: str, names: set[str]) -> bool:
    try:
        if not os.path.isdir(path):
            return False
        with os.scandir(path) as it:
            for entry in it:
                if entry.name in names and entry.is_dir(follow_symlinks=False):
                    return True
    except OSError:
        return False
    return False


@dataclass
class IndexerRule:
    name: str
    rules: list[RulePerKind]
    default: bool = False
    pub_id: bytes = field(default_factory=lambda: uuid.uuid4().bytes)

    def apply(self, path: str) -> list[tuple[RuleKind, bool]]:
        return [r.apply(path) for r in self.rules]

    @staticmethod
    def apply_all(rules: Sequence["IndexerRule"], path: str) -> dict[RuleKind, list[bool]]:
        out: dict[RuleKind, list[bool]] = {}
        for rule in rules:
            for kind, ok in rule.apply(path):
                out.setdefault(kind, []).append(ok)
        return out

    # --- persistence (rules_per_kind column, msgpack) ---

    def serialize_rules(self) -> bytes:
        return packb(
            [{"kind": int(r.kind), "params": r.params} for r in self.rules]
        )

    @classmethod
    def deserialize(cls, name: str, raw: bytes, default: bool = False,
                    pub_id: bytes | None = None) -> "IndexerRule":
        rules = [
            RulePerKind(RuleKind(o["kind"]), o["params"])
            for o in unpackb(raw)
        ]
        return cls(name, rules, default, pub_id or uuid.uuid4().bytes)


# --- seeded system rules (ref:rules/seed.rs; fixed pub_ids, never reorder) ---

def no_os_protected() -> IndexerRule:
    return IndexerRule(
        "No OS protected",
        [
            RulePerKind(
                RuleKind.REJECT_FILES_BY_GLOB,
                [
                    "**/.spacedrive",
                    # linux (gitignore Global/Linux + FHS special dirs)
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
        ],
        default=True,
        pub_id=uuid.UUID(int=0).bytes,
    )


def no_hidden() -> IndexerRule:
    return IndexerRule(
        "No Hidden",
        [RulePerKind(RuleKind.REJECT_FILES_BY_GLOB, ["**/.*"])],
        default=False,
        pub_id=uuid.UUID(int=1).bytes,
    )


def no_git() -> IndexerRule:
    return IndexerRule(
        "No Git",
        [
            RulePerKind(
                RuleKind.REJECT_FILES_BY_GLOB,
                ["**/{.git,.gitignore,.gitattributes,.gitkeep,.gitconfig,.gitmodules}"],
            )
        ],
        default=False,
        pub_id=uuid.UUID(int=2).bytes,
    )


def only_images() -> IndexerRule:
    return IndexerRule(
        "Only Images",
        [
            RulePerKind(
                RuleKind.ACCEPT_FILES_BY_GLOB,
                ["*.{avif,bmp,gif,ico,jpeg,jpg,png,svg,tif,tiff,webp}"],
            )
        ],
        default=False,
        pub_id=uuid.UUID(int=3).bytes,
    )


def system_rules() -> list[IndexerRule]:
    """DO NOT REORDER (pub_ids are positional, ref:seed.rs:42)."""
    return [no_os_protected(), no_hidden(), no_git(), only_images()]


def seed_rules(db) -> None:
    """Upsert system rules into a library DB (ref:seed.rs:40-72)."""
    for rule in system_rules():
        existing = db.find_one("indexer_rule", pub_id=rule.pub_id)
        blob = rule.serialize_rules()
        if existing:
            db.update(
                "indexer_rule", {"pub_id": rule.pub_id},
                name=rule.name, rules_per_kind=blob,
                **{"default": int(rule.default)},
            )
        else:
            db.insert(
                "indexer_rule", pub_id=rule.pub_id, name=rule.name,
                rules_per_kind=blob, date_created=now_iso(),
                date_modified=now_iso(), **{"default": int(rule.default)},
            )


def load_rules_for_location(db, location_id: int) -> list[IndexerRule]:
    rows = db.query(
        "SELECT ir.* FROM indexer_rule ir "
        "JOIN indexer_rule_in_location iril ON iril.indexer_rule_id = ir.id "
        "WHERE iril.location_id = ?",
        (location_id,),
    )
    return [
        IndexerRule.deserialize(
            r["name"] or "", r["rules_per_kind"], bool(r["default"]), r["pub_id"]
        )
        for r in rows
    ]
