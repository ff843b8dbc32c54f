"""The port's filesystem walk and indexer rules against the JAX
package's walker and rules.

Exact: the same accepted entries (relative paths, kinds, sizes) for the
default rules and for the child-directory and glob rules, on the
reference's walk test tree.
"""

import os

import pytest

from spacedrive_tpu.files.isolated_path import IsolatedFilePathData
from spacedrive_tpu.location.indexer import rules as jrules
from spacedrive_tpu.location.indexer import walk as jwalk
from spacedrive_tpu_torch.files import isolated_path
from spacedrive_tpu_torch.location.indexer import rules, walker


@pytest.fixture()
def location(tmp_path):
    """The reference's prepare_location() tree, with sizes, a rejected
    editor backup, a hidden file and a symlink."""
    root = tmp_path
    for d in ("rust_project/.git", "rust_project/src", "rust_project/target/debug",
              "inner/node_project/.git", "inner/node_project/src",
              "inner/node_project/node_modules/react", "photos", "lost+found"):
        (root / d).mkdir(parents=True)
    for i, f in enumerate((
        "rust_project/Cargo.toml", "rust_project/src/main.rs", "rust_project/target/debug/main",
        "inner/node_project/package.json", "inner/node_project/src/App.tsx",
        "inner/node_project/node_modules/react/readme.md", "photos/photo1.png",
        "photos/photo2.jpg", "photos/photo3.jpeg", "photos/text.txt", "photos/notes.txt~",
        ".env", "archive.tar.gz", "lost+found/x",
    )):
        (root / f).write_bytes(b"x" * (i * 37))
    os.symlink(root / "photos" / "photo1.png", root / "link.png")
    return str(root)


def _jax_walk(root, rules):
    res = jwalk(
        root=root,
        indexer_rules=rules,
        iso_file_path_factory=lambda p, d: IsolatedFilePathData.new(1, root, p, d),
        file_paths_db_fetcher=lambda isos: [],
        to_remove_db_fetcher=lambda parent, isos: [],
    )
    assert not res.errors
    out = {}
    for e in res.walked:
        iso = e.iso_file_path
        size = 0 if iso.is_dir else e.metadata.size_in_bytes
        out[iso.relative_path] = (iso.is_dir, iso.extension, size)
    return out


def _port_walk(root, indexer_rules=None):
    """The port's walk as the library-less pass calls it: the root alone
    (default rules), or the root and a rule list."""
    res = walker.walk(root, indexer_rules)
    assert not res.errors
    out = {}
    for e in res.walked:
        iso = e.iso_file_path
        size = 0 if iso.is_dir else e.metadata.size_in_bytes
        out[iso.relative_path] = (iso.is_dir, iso.extension, size)
    return out


def test_default_rules_match_jax(location):
    got = _port_walk(location)
    assert got == _jax_walk(location, [jrules.no_os_protected()])
    assert "photos/notes.txt~" not in got and "lost+found" not in got
    assert "link.png" not in got  # symlinks are skipped
    assert got[".env"] == (False, "", 11 * 37)
    assert got["archive.tar.gz"] == (False, "gz", 12 * 37)


def test_child_directory_and_glob_rules_match_jax(location):
    port_rules = [
        rules.IndexerRule("r", [rules.RulePerKind(
            rules.RuleKind.ACCEPT_IF_CHILDREN_DIRECTORIES_ARE_PRESENT, [".git"])]),
        rules.IndexerRule("r", [rules.RulePerKind(
            rules.RuleKind.REJECT_FILES_BY_GLOB,
            ["{**/node_modules/*,**/node_modules}", "{**/target/*,**/target}"])]),
    ]
    jax_rules = [jrules.IndexerRule("r", [jrules.RulePerKind(p.kind.value, p.params)
                                          for p in r.rules])
                 for r in port_rules]
    got = _port_walk(location, port_rules)
    assert got == _jax_walk(location, jax_rules)
    assert "inner" in got and "rust_project/src/main.rs" in got
    assert not any("node_modules" in p or "target" in p or p.startswith("photos") for p in got)


@pytest.mark.parametrize("glob", ["**/*.{png,jpg}", "/{dev,sys,proc}", "**/.Trash-*",
                                  "a?c[!x]*", "**/lost+found", "{a,{b,c}}/*"])
def test_glob_translation_matches_jax(glob):
    assert rules.glob_to_regex(glob) == jrules.glob_to_regex(glob)


def test_separate_name_and_extension():
    split = isolated_path.separate_name_and_extension
    assert split("archive.tar.gz") == ("archive.tar", "gz")
    assert split(".env") == (".env", "")
    assert split("noext") == ("noext", "")
