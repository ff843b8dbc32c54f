"""`search.paths` ordered by size: the port's cached size order against the
JAX package's SQL, page by page.

Both packages' `search_paths` read one seeded library DB (the port's
`LibraryDb` writes it, the JAX `LibraryDb` opens the same file): 300
file_path rows with sizes drawn from a few values, so most sizes tie,
plus rows with no size blob, over two locations and a few extensions.
Every page of a walk in each direction, with and without filters, holds
the same rows in the same order with the same cursor. Then a row is
inserted, one deleted and one resized, through each package's
connection in turn, and the walks are equal again: the port's cached
order follows every write.
"""

import os
import types

import numpy as np
import pytest

import spacedrive_tpu.api.search as jsearch
from spacedrive_tpu.db import LibraryDb as JLibraryDb
from spacedrive_tpu_torch.api import search as psearch
from spacedrive_tpu_torch.db.database import LibraryDb, u64_blob


def _seed(db, rng, n=300):
    for loc in (1, 2):
        db.execute("INSERT INTO location (id, pub_id, name, path) VALUES (?, ?, ?, ?)",
                   (loc, os.urandom(16), f"loc{loc}", f"/data/loc{loc}"))
    sizes = [0, 1, 100, 4096, 102400, 102401, 1 << 20, 1 << 33]
    for i in range(n):
        size = None if i % 37 == 5 else int(rng.choice(sizes))
        _insert(db, i, size, loc=1 + (i % 2), ext=("jpg", "bin", "txt")[i % 3])


def _insert(db, i, size, loc=1, ext="bin"):
    db.execute(
        "INSERT INTO file_path (pub_id, is_dir, location_id, materialized_path, name, "
        "extension, size_in_bytes_bytes) VALUES (?, 0, ?, '/', ?, ?, ?)",
        (os.urandom(16), loc, f"f{i:04d}", ext, None if size is None else u64_blob(size)))


def _walk(search_paths, library, **arg):
    pages, cursor = [], None
    while True:
        out = search_paths(library, {**arg, "orderBy": "sizeInBytes", "take": 7,
                                     **({"cursor": cursor} if cursor else {})})
        pages.append(out)
        cursor = out["cursor"]
        if cursor is None:
            return pages


WALKS = [
    {},
    {"orderDir": "desc"},
    {"filter": {"extension": "jpg"}},
    {"filter": {"locationId": 2}, "orderDir": "desc"},
    {"filter": {"search": "f01"}},
]


@pytest.fixture()
def libraries(tmp_path):
    path = os.path.join(tmp_path, "library.db")
    pdb = LibraryDb(path)
    _seed(pdb, np.random.default_rng(0))
    jdb = JLibraryDb(path)
    yield types.SimpleNamespace(db=pdb), types.SimpleNamespace(db=jdb)
    jdb.close()
    pdb.close()


def _assert_walks_equal(plib, jlib):
    for arg in WALKS:
        got, want = _walk(psearch.search_paths, plib, **arg), _walk(jsearch.search_paths, jlib,
                                                                    **arg)
        assert got == want, arg
    # a whole walk holds every row once
    ids = [i for page in _walk(psearch.search_paths, plib) for i in
           (ref["__id"] for ref in page["items"])]
    assert sorted(ids) == sorted(r["id"] for r in plib.db.query("SELECT id FROM file_path"))


def test_pages_by_size_equal_jax(libraries):
    plib, jlib = libraries
    _assert_walks_equal(plib, jlib)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_pages_by_size_follow_insert_delete_and_resize(libraries, writer):
    plib, jlib = libraries
    _walk(psearch.search_paths, plib)  # the order is cached now
    db = plib.db if writer == "port" else jlib.db
    _insert(db, 9001, 4096, loc=1, ext="jpg")
    _assert_walks_equal(plib, jlib)
    first = plib.db.query("SELECT id FROM file_path ORDER BY id LIMIT 1")[0]["id"]
    db.execute("DELETE FROM file_path WHERE id = ?", (first,))
    _assert_walks_equal(plib, jlib)
    db.execute("UPDATE file_path SET size_in_bytes_bytes = ? WHERE id = ?",
               (u64_blob(7), first + 1))
    _assert_walks_equal(plib, jlib)


def test_a_cursor_of_another_type_takes_the_sql_path(libraries):
    """A cursor whose order value is no key string is JAX's SQL's to
    answer, and the answers stay equal."""
    plib, jlib = libraries
    for cursor in ([None, 3], [5, 3], ["0000", 10]):
        arg = {"orderBy": "sizeInBytes", "take": 5, "cursor": cursor}
        assert psearch.search_paths(plib, arg) == jsearch.search_paths(jlib, arg)


def test_the_size_order_is_cached_until_a_write(libraries, monkeypatch):
    """One build for each direction walked at rest; the first page after
    a write takes JAX's SQL and builds nothing, the next page builds."""
    plib, _ = libraries
    calls = []
    real = plib.db.query

    def counting(sql, params=()):
        if "AS k FROM file_path" in sql:
            calls.append(sql)
        return real(sql, params)

    monkeypatch.setattr(plib.db, "query", counting)
    _walk(psearch.search_paths, plib)
    _walk(psearch.search_paths, plib)
    _walk(psearch.search_paths, plib, orderDir="desc")
    assert len(calls) == 2 and "ASC" in calls[0] and "DESC" in calls[1]
    _insert(plib.db, 9002, 1)
    psearch.search_paths(plib, {"orderBy": "sizeInBytes"})
    assert len(calls) == 2
    psearch.search_paths(plib, {"orderBy": "sizeInBytes"})
    assert len(calls) == 3


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_walk_while_rows_change_builds_nothing_and_equals_jax(libraries, monkeypatch,
                                                                 writer):
    """A write between every page (as a running scan makes) sends every
    page to JAX's SQL: no order is built, and each page equals JAX's."""
    plib, jlib = libraries
    builds = []
    real = plib.db.query

    def counting(sql, params=()):
        if "AS k FROM file_path" in sql:
            builds.append(sql)
        return real(sql, params)

    monkeypatch.setattr(plib.db, "query", counting)
    db = plib.db if writer == "port" else jlib.db
    cursor, n = None, 0
    while True:
        _insert(db, 9100 + n, int(n * 37), loc=1, ext="bin")
        n += 1
        arg = {"orderBy": "sizeInBytes", "take": 7, **({"cursor": cursor} if cursor else {})}
        got = psearch.search_paths(plib, arg)
        assert got == jsearch.search_paths(jlib, arg)
        cursor = got["cursor"]
        if cursor is None:
            break
    assert n > 3 and builds == []
