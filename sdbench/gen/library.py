"""A photo library's rows, made from a seed (a configuration's `gen`:
"library").

`make(config, seed)` reads the `library` block of the configuration
file; `install(node, config, data, seed, tmp)` puts the library where a
node that has not started yet loads it from disk; `started(node, config,
library_id)` sets the library's connection as the host would have it.

- `files` image files, each with its own object (one object per file,
  as a library holds them once objects made on several devices have
  synced: copies of one file on two devices keep two objects that share
  a `cas_id`).
- One 64-bit pHash per object. Background hashes are uniform random.
  `near_cluster_share` of the files sit in clusters whose sizes cycle
  through `near_cluster_size` [lo, hi] (the same multiset of sizes on
  every seed); each member lies within `near_cluster_radius` bits of its
  cluster's random centre (a uniform count of distinct flipped bits, 0
  to the radius), so two members lie within twice the radius.
- `exact_copy_share` of the files are byte copies of another file that
  is not itself a copy: the same `cas_id`, pHash, size and extension.
- Unique `cas_id`s elsewhere (an odd multiplier over the file index,
  which cannot collide), lognormal sizes, `files_per_dir` files to a
  directory, extensions drawn by `extensions`' weights.

Hashes are uint64, the first bit of the packed big-endian hash (the
program's `np.packbits` order) being bit 63.
"""

from __future__ import annotations

import os
import sqlite3
import uuid
from dataclasses import dataclass

import numpy as np

#: `ObjectKind.Image` of the port (files/kind.py); a test holds the two equal
IMAGE_KIND = 5
#: the location's path: on the device the library synced from, absent here
LOCATION_PATH = "/media/photos/Pictures"
HASH_BITS = 64
DATE_BASE = np.datetime64("2019-01-01T08:00:00", "s")


def rng_for(seed: int, stream: int = 0) -> np.random.Generator:
    """The generator of `seed` (any int; negative and large ones too)."""
    return np.random.default_rng(np.random.SeedSequence([seed % 2**64, stream]))


@dataclass
class LibraryData:
    n: int
    phash: np.ndarray  # uint64 [n]
    cas: np.ndarray  # uint64 [n]; the cas_id is its 16 hex digits
    size: np.ndarray  # uint64 [n]
    ext: np.ndarray  # uint8 [n], an index into `extensions`
    extensions: list[str]
    files_per_dir: int
    cluster: np.ndarray  # int32 [n]: near cluster, or -1
    copy_of: np.ndarray  # int64 [n]: the file copied, or -1
    rows: sqlite3.Connection | None = None  # the rows in memory, from `make`

    # --- the rows' text, as the harness writes it --------------------------

    def name(self, i: int) -> str:
        return f"IMG_{i:07d}"

    def materialized_path(self, i: int) -> str:
        return f"/DCIM/{i // self.files_per_dir:04d}/"

    def cas_id(self, i: int) -> str:
        return f"{int(self.cas[i]):016x}"

    def extension(self, i: int) -> str:
        return self.extensions[int(self.ext[i])]

    def phash_bytes(self) -> np.ndarray:
        """uint8 [n, 8]: the big-endian hashes as the DB holds them."""
        return self.phash.astype(">u8").view(np.uint8).reshape(-1, 8)


def cluster_sizes(members: int, lo: int, hi: int) -> list[int]:
    """Sizes cycling lo, lo+1, ..., hi that add up to `members`, the last
    one cut short (dropped where it would hold fewer than 2)."""
    sizes: list[int] = []
    total = 0
    k = 0
    while total < members:
        s = min(lo + k % (hi - lo + 1), members - total)
        if s < 2:
            break
        sizes.append(s)
        total += s
        k += 1
    return sizes


def flip_masks(rng: np.random.Generator, m: int, radius: int) -> np.ndarray:
    """uint64 [m]: each a mask of a uniform count (0..radius) of distinct bits."""
    if m == 0 or radius == 0:
        return np.zeros(m, np.uint64)
    pos = np.argsort(rng.random((m, HASH_BITS)), axis=1)[:, :radius].astype(np.uint64)
    count = rng.integers(0, radius + 1, size=m)
    use = np.arange(radius)[None, :] < count[:, None]
    bits = np.left_shift(np.uint64(1), pos)
    return np.bitwise_or.reduce(np.where(use, bits, np.uint64(0)), axis=1)


def make(config: dict, seed: int) -> LibraryData:
    """The harness's entry: the library of the configuration `config`,
    its rows already in a database in memory. Needs neither torch nor a
    node, so that it can run while they load."""
    data = generate(config["library"], seed)
    data.rows = build_rows(data, seed)
    return data


def generate(spec: dict, seed: int) -> LibraryData:
    """The library of `spec` (a configuration's `library` block) for `seed`."""
    rng = rng_for(seed)
    n = int(spec["files"])
    phash = rng.integers(0, 2**64, size=n, dtype=np.uint64, endpoint=False)
    perm = rng.permutation(n)
    n_copy = int(round(float(spec["exact_copy_share"]) * n))
    copies, rest = perm[:n_copy], perm[n_copy:]

    lo, hi = (int(x) for x in spec["near_cluster_size"])
    sizes = cluster_sizes(int(round(float(spec["near_cluster_share"]) * n)), lo, hi)
    n_members = sum(sizes)
    if n_members > len(rest):
        raise ValueError("the near clusters need more files than the library has")
    members = rest[:n_members]
    cluster = np.full(n, -1, np.int32)
    cluster_of_member = np.repeat(np.arange(len(sizes), dtype=np.int32), sizes)
    cluster[members] = cluster_of_member
    centres = rng.integers(0, 2**64, size=len(sizes), dtype=np.uint64, endpoint=False)
    radius = int(spec["near_cluster_radius"])
    phash[members] = centres[cluster_of_member] ^ flip_masks(rng, n_members, radius)

    originals = rng.choice(rest, size=n_copy, replace=False)
    copy_of = np.full(n, -1, np.int64)
    copy_of[copies] = originals

    mult = rng.integers(0, 2**64, dtype=np.uint64, endpoint=False) | np.uint64(1)
    add = rng.integers(0, 2**64, dtype=np.uint64, endpoint=False)
    with np.errstate(over="ignore"):
        cas = np.arange(n, dtype=np.uint64) * mult + add
    median = float(spec["size_median_bytes"])
    size = np.exp(rng.normal(np.log(median), float(spec["size_sigma"]), n)).astype(np.uint64)
    size = np.maximum(size, np.uint64(1024))
    exts = list(spec["extensions"])
    weights = np.array([float(w) for w in spec["extension_weights"]])
    ext = rng.choice(len(exts), size=n, p=weights / weights.sum()).astype(np.uint8)

    for arr in (phash, cas, size, ext):
        arr[copies] = arr[originals]
    return LibraryData(n=n, phash=phash, cas=cas, size=size, ext=ext, extensions=exts,
                       files_per_dir=int(spec["files_per_dir"]), cluster=cluster,
                       copy_of=copy_of)


def _iso(seconds: np.ndarray) -> list[str]:
    stamps = np.datetime_as_string(DATE_BASE + seconds.astype("timedelta64[s]"), unit="ms")
    return [s + "+00:00" for s in stamps.tolist()]


def _sorted_ids(rng: np.random.Generator, count: int) -> np.ndarray:
    """uint8 [count, 16]: random 16-byte pub_ids, ascending in their first
    8 bytes, so that their unique index is written in order."""
    hi = np.sort(rng.integers(0, 2**64, size=count, dtype=np.uint64, endpoint=False))
    lo = rng.integers(0, 2**64, size=count, dtype=np.uint64, endpoint=False)
    return np.concatenate([hi.astype(">u8").view(np.uint8).reshape(count, 8),
                           lo.astype(">u8").view(np.uint8).reshape(count, 8)], axis=1)


def _hex16(values: np.ndarray) -> bytes:
    """The 16 lower-case hex digits of each uint64, back to back."""
    digits = np.frombuffer(b"0123456789abcdef", np.uint8)
    b = values.astype(">u8").view(np.uint8).reshape(-1, 8)
    return digits[np.stack([b >> 4, b & 15], axis=2).reshape(-1, 16)].tobytes()


def load_rows(conn: sqlite3.Connection, data: LibraryData, location_path: str,
              seed: int) -> int:
    """Write one location, `data.n` objects and `data.n` file_path rows
    into `conn`, a connection to a library database of the port's schema,
    in one transaction; returns the location's id.

    A bulk load: each table's rows go in with one INSERT ... SELECT that
    slices every column out of one packed parameter (a blob, so that
    `substr` is O(1)); foreign keys are off while it runs (the rows are
    consistent by construction); the tables' secondary indexes are
    dropped first and built again after; pub_ids ascend with the row id,
    and the inodes' 8-byte blobs ascend too. The rows and indexes are
    those of a library that synced them.
    """
    rng = rng_for(seed, 1)
    n = data.n
    pub = _sorted_ids(rng, 2 * n + 1)
    created = _iso(rng.integers(0, 5 * 365 * 86400, size=n))
    width = len(created[0])
    indexed = _iso(np.full(1, 6 * 365 * 86400))[0]
    exts = data.extensions
    params = {
        "n": n,
        "fpd": data.files_per_dir,
        "loc_path": location_path,
        "pub": pub[:2 * n].tobytes(),
        "created": "".join(created).encode(),
        "indexed": indexed,
        "phash": data.phash_bytes().tobytes(),
        "cas": _hex16(data.cas),
        "size": data.size.astype("<u8").tobytes(),
        "inode": np.arange(1, n + 1, dtype=">u8").tobytes(),
        "ext": data.ext.astype(np.uint8).tobytes(),
    }
    ext_case = " ".join(f"WHEN x'{k:02x}' THEN '{e}'" for k, e in enumerate(exts))
    rows = f"WITH RECURSIVE k(i) AS (SELECT 0 UNION ALL SELECT i + 1 FROM k WHERE i + 1 < :n) "
    created_i = f"CAST(substr(:created, i * {width} + 1, {width}) AS TEXT)"

    indexes = conn.execute(
        "SELECT name, sql FROM sqlite_master WHERE type = 'index' AND sql IS NOT NULL "
        "AND tbl_name IN ('object', 'file_path')").fetchall()
    conn.execute("PRAGMA foreign_keys=OFF")
    with conn:
        for name, _sql in indexes:
            conn.execute(f"DROP INDEX {name}")
        cur = conn.execute(
            "INSERT INTO location (pub_id, name, path, is_archived, "
            "generate_preview_media, sync_preview_media, hidden, date_created) "
            "VALUES (?, ?, ?, 0, 1, 1, 0, ?)",
            (pub[2 * n].tobytes(), "Pictures", location_path, indexed),
        )
        params["loc"] = cur.lastrowid
        conn.execute(
            rows + "INSERT INTO object (id, pub_id, kind, hidden, favorite, important, "
            "date_created, date_accessed, phash) "
            f"SELECT i + 1, substr(:pub, i * 16 + 1, 16), {IMAGE_KIND}, 0, 0, 0, {created_i}, "
            "NULL, substr(:phash, i * 8 + 1, 8) FROM k",
            {k: params[k] for k in ("n", "pub", "created", "phash")},
        )
        conn.execute(
            rows + "INSERT INTO file_path (id, pub_id, is_dir, cas_id, location_id, "
            "materialized_path, name, extension, hidden, size_in_bytes_bytes, inode, "
            "object_id, date_created, date_modified, date_indexed) "
            "SELECT i + 1, substr(:pub, (:n + i) * 16 + 1, 16), 0, "
            "CAST(substr(:cas, i * 16 + 1, 16) AS TEXT), :loc, "
            "printf('/DCIM/%04d/', i / :fpd), printf('IMG_%07d', i), "
            f"CASE substr(:ext, i + 1, 1) {ext_case} END, 0, "
            "substr(:size, i * 8 + 1, 8), substr(:inode, i * 8 + 1, 8), i + 1, "
            f"{created_i}, {created_i}, :indexed FROM k",
            {k: params[k] for k in ("n", "pub", "cas", "loc", "fpd", "ext", "size", "inode",
                                    "created", "indexed")},
        )
        for _name, sql in indexes:
            conn.execute(sql)
    conn.execute("PRAGMA foreign_keys=ON")
    return params["loc"]


def build_rows(data: LibraryData, seed: int) -> sqlite3.Connection:
    """A database in memory with the port's schema (its migrations, as
    `LibraryDb` runs them) and the rows of `data`."""
    from spacedrive_tpu_torch.db.schema import MIGRATIONS

    conn = sqlite3.connect(":memory:", check_same_thread=False)
    with conn:
        for stmts in MIGRATIONS:
            for stmt in stmts:
                conn.execute(stmt)
        conn.execute(f"PRAGMA user_version={len(MIGRATIONS)}")
    load_rows(conn, data, LOCATION_PATH, seed)
    return conn


def install(node, config: dict, data: LibraryData, seed: int, tmp: str) -> str:
    """Put the library of `data` where `node`, not yet started, finds it:
    the node's own library manager creates it (its instance, its rules),
    those rows join the rows that `make` built in memory, and the
    database goes back to its file in one write. Returns the library's
    id."""
    from spacedrive_tpu_torch.node.library import Libraries

    lib = Libraries(node.data_dir).create(
        config["name"], node_pub_id=node.id.bytes, node_name=node.config.config.name)
    path = lib.db.path
    lib.close()
    conn = data.rows
    conn.execute("ATTACH DATABASE ? AS created", (path,))
    with conn:
        tables = [r[0] for r in conn.execute(
            "SELECT name FROM created.sqlite_master WHERE type = 'table' "
            "AND name NOT LIKE 'sqlite_%'")]
        for t in tables:
            conn.execute(f'INSERT INTO main."{t}" SELECT * FROM created."{t}"')
    conn.execute("DETACH DATABASE created")
    image = conn.serialize()
    for leftover in (path + "-wal", path + "-shm"):
        if os.path.exists(leftover):
            os.remove(leftover)
    with open(path, "wb") as f:
        f.write(image)
    with open(path, "rb") as f:  # the host's page cache holds it, as after any use
        while f.read(1 << 24):
            pass
    return str(lib.id)


async def started(node, config: dict, library_id: str) -> None:
    """Once the node has loaded the library: SQLite maps the database
    file (`PRAGMA mmap_size`, the configuration's `sqlite_mmap_bytes`),
    so that a page already in the host's page cache is read without a
    system call, as on a desktop where such a read costs about a
    microsecond; on a host whose file reads are slow system calls, each
    pass would otherwise pay one for every page it misses in SQLite's
    own 2 MB cache."""
    lib = node.libraries.get(uuid.UUID(library_id))
    lib.db.execute(f"PRAGMA mmap_size={int(config['sqlite_mmap_bytes'])}")
