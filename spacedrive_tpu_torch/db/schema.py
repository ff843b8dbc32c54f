"""Library-database DDL, mirroring the reference's Prisma schema
(ref:core/prisma/schema.prisma:19-554) table for table.

Counterpart of `spacedrive_tpu/db/schema.py`: the same statements and
migrations, so a library DB of either package has the same DDL.

Storage conventions:
- `pub_id`: 16-byte UUID BLOB (globally unique, sync identity).
- datetimes: ISO-8601 TEXT in UTC.
- u64 (inode, sizes): 8-byte little-endian BLOB where the reference
  uses Bytes (SQLite has no u64), plain INTEGER elsewhere.
- `file_path.name/extension` collate NOCASE (ref:schema.prisma:156).
Versioning via PRAGMA user_version + ordered migration list.
"""

from __future__ import annotations

SCHEMA: list[str] = [
    # --- sync infrastructure -------------------------------------------------
    """
    CREATE TABLE crdt_operation (
        id          BLOB PRIMARY KEY,
        timestamp   INTEGER NOT NULL,
        model       TEXT NOT NULL,
        record_id   BLOB NOT NULL,
        kind        TEXT NOT NULL,
        data        BLOB NOT NULL,
        instance_id INTEGER NOT NULL REFERENCES instance(id)
    )
    """,
    "CREATE INDEX idx_crdt_instance_ts ON crdt_operation(instance_id, timestamp)",
    """
    CREATE TABLE cloud_crdt_operation (
        id          BLOB PRIMARY KEY,
        timestamp   INTEGER NOT NULL,
        model       TEXT NOT NULL,
        record_id   BLOB NOT NULL,
        kind        TEXT NOT NULL,
        data        BLOB NOT NULL,
        instance_id INTEGER NOT NULL REFERENCES instance(id)
    )
    """,
    # --- identity ------------------------------------------------------------
    """
    CREATE TABLE node (
        id           INTEGER PRIMARY KEY AUTOINCREMENT,
        pub_id       BLOB NOT NULL UNIQUE,
        name         TEXT NOT NULL,
        platform     INTEGER NOT NULL,
        date_created TEXT NOT NULL,
        identity     BLOB
    )
    """,
    """
    CREATE TABLE instance (
        id            INTEGER PRIMARY KEY AUTOINCREMENT,
        pub_id        BLOB NOT NULL UNIQUE,
        identity      BLOB NOT NULL,
        node_id       BLOB NOT NULL,
        node_name     TEXT NOT NULL,
        node_platform INTEGER NOT NULL,
        last_seen     TEXT NOT NULL,
        date_created  TEXT NOT NULL,
        timestamp     INTEGER
    )
    """,
    """
    CREATE TABLE statistics (
        id                   INTEGER PRIMARY KEY AUTOINCREMENT,
        date_captured        TEXT NOT NULL DEFAULT (datetime('now')),
        total_object_count   INTEGER NOT NULL DEFAULT 0,
        library_db_size      TEXT NOT NULL DEFAULT '0',
        total_bytes_used     TEXT NOT NULL DEFAULT '0',
        total_bytes_capacity TEXT NOT NULL DEFAULT '0',
        total_unique_bytes   TEXT NOT NULL DEFAULT '0',
        total_bytes_free     TEXT NOT NULL DEFAULT '0',
        preview_media_bytes  TEXT NOT NULL DEFAULT '0'
    )
    """,
    """
    CREATE TABLE volume (
        id                    INTEGER PRIMARY KEY AUTOINCREMENT,
        name                  TEXT NOT NULL,
        mount_point           TEXT NOT NULL,
        total_bytes_capacity  TEXT NOT NULL DEFAULT '0',
        total_bytes_available TEXT NOT NULL DEFAULT '0',
        disk_type             TEXT,
        filesystem            TEXT,
        is_system             INTEGER NOT NULL DEFAULT 0,
        date_modified         TEXT NOT NULL DEFAULT (datetime('now')),
        UNIQUE (mount_point, name)
    )
    """,
    # --- the VDFS core -------------------------------------------------------
    """
    CREATE TABLE location (
        id                     INTEGER PRIMARY KEY AUTOINCREMENT,
        pub_id                 BLOB NOT NULL UNIQUE,
        name                   TEXT,
        path                   TEXT,
        total_capacity         INTEGER,
        available_capacity     INTEGER,
        size_in_bytes          BLOB,
        is_archived            INTEGER,
        generate_preview_media INTEGER,
        sync_preview_media     INTEGER,
        hidden                 INTEGER,
        date_created           TEXT,
        instance_id            INTEGER REFERENCES instance(id) ON DELETE SET NULL
    )
    """,
    """
    CREATE TABLE file_path (
        id                  INTEGER PRIMARY KEY AUTOINCREMENT,
        pub_id              BLOB NOT NULL UNIQUE,
        is_dir              INTEGER,
        cas_id              TEXT,
        integrity_checksum  TEXT,
        location_id         INTEGER REFERENCES location(id) ON DELETE SET NULL,
        materialized_path   TEXT,
        name                TEXT COLLATE NOCASE,
        extension           TEXT COLLATE NOCASE,
        hidden              INTEGER,
        size_in_bytes       TEXT,
        size_in_bytes_bytes BLOB,
        inode               BLOB,
        object_id           INTEGER REFERENCES object(id) ON DELETE SET NULL,
        key_id              INTEGER,
        date_created        TEXT,
        date_modified       TEXT,
        date_indexed        TEXT,
        UNIQUE (location_id, materialized_path, name, extension),
        UNIQUE (location_id, inode)
    )
    """,
    "CREATE INDEX idx_file_path_location ON file_path(location_id)",
    "CREATE INDEX idx_file_path_materialized ON file_path(location_id, materialized_path)",
    "CREATE INDEX idx_file_path_cas ON file_path(cas_id)",
    "CREATE INDEX idx_file_path_object ON file_path(object_id)",
    """
    CREATE TABLE object (
        id            INTEGER PRIMARY KEY AUTOINCREMENT,
        pub_id        BLOB NOT NULL UNIQUE,
        kind          INTEGER,
        key_id        INTEGER,
        hidden        INTEGER,
        favorite      INTEGER,
        important     INTEGER,
        note          TEXT,
        date_created  TEXT,
        date_accessed TEXT
    )
    """,
    """
    CREATE TABLE media_data (
        id             INTEGER PRIMARY KEY AUTOINCREMENT,
        resolution     BLOB,
        media_date     BLOB,
        media_location BLOB,
        camera_data    BLOB,
        artist         TEXT,
        description    TEXT,
        copyright      TEXT,
        exif_version   TEXT,
        epoch_time     INTEGER,
        object_id      INTEGER NOT NULL UNIQUE REFERENCES object(id) ON DELETE CASCADE
    )
    """,
    # --- organisation --------------------------------------------------------
    """
    CREATE TABLE tag (
        id            INTEGER PRIMARY KEY AUTOINCREMENT,
        pub_id        BLOB NOT NULL UNIQUE,
        name          TEXT,
        color         TEXT,
        is_hidden     INTEGER,
        date_created  TEXT,
        date_modified TEXT
    )
    """,
    """
    CREATE TABLE tag_on_object (
        tag_id       INTEGER NOT NULL REFERENCES tag(id) ON DELETE RESTRICT,
        object_id    INTEGER NOT NULL REFERENCES object(id) ON DELETE RESTRICT,
        date_created TEXT,
        PRIMARY KEY (tag_id, object_id)
    )
    """,
    """
    CREATE TABLE label (
        id            INTEGER PRIMARY KEY AUTOINCREMENT,
        name          TEXT NOT NULL UNIQUE,
        date_created  TEXT,
        date_modified TEXT
    )
    """,
    """
    CREATE TABLE label_on_object (
        label_id     INTEGER NOT NULL REFERENCES label(id) ON DELETE RESTRICT,
        object_id    INTEGER NOT NULL REFERENCES object(id) ON DELETE RESTRICT,
        date_created TEXT NOT NULL DEFAULT (datetime('now')),
        PRIMARY KEY (label_id, object_id)
    )
    """,
    """
    CREATE TABLE space (
        id            INTEGER PRIMARY KEY AUTOINCREMENT,
        pub_id        BLOB NOT NULL UNIQUE,
        name          TEXT,
        description   TEXT,
        date_created  TEXT,
        date_modified TEXT
    )
    """,
    """
    CREATE TABLE object_in_space (
        space_id  INTEGER NOT NULL REFERENCES space(id) ON DELETE RESTRICT,
        object_id INTEGER NOT NULL REFERENCES object(id) ON DELETE RESTRICT,
        PRIMARY KEY (space_id, object_id)
    )
    """,
    """
    CREATE TABLE album (
        id            INTEGER PRIMARY KEY,
        pub_id        BLOB NOT NULL UNIQUE,
        name          TEXT,
        is_hidden     INTEGER,
        date_created  TEXT,
        date_modified TEXT
    )
    """,
    """
    CREATE TABLE object_in_album (
        album_id     INTEGER NOT NULL REFERENCES album(id),
        object_id    INTEGER NOT NULL REFERENCES object(id),
        date_created TEXT,
        PRIMARY KEY (album_id, object_id)
    )
    """,
    # --- execution -----------------------------------------------------------
    """
    CREATE TABLE job (
        id                        BLOB PRIMARY KEY,
        name                      TEXT,
        action                    TEXT,
        status                    INTEGER,
        errors_text               TEXT,
        data                      BLOB,
        metadata                  BLOB,
        parent_id                 BLOB REFERENCES job(id) ON DELETE SET NULL,
        task_count                INTEGER,
        completed_task_count      INTEGER,
        date_estimated_completion TEXT,
        date_created              TEXT,
        date_started              TEXT,
        date_completed            TEXT
    )
    """,
    # --- indexer rules -------------------------------------------------------
    """
    CREATE TABLE indexer_rule (
        id             INTEGER PRIMARY KEY AUTOINCREMENT,
        pub_id         BLOB NOT NULL UNIQUE,
        name           TEXT,
        "default"      INTEGER,
        rules_per_kind BLOB,
        date_created   TEXT,
        date_modified  TEXT
    )
    """,
    """
    CREATE TABLE indexer_rule_in_location (
        location_id     INTEGER NOT NULL REFERENCES location(id) ON DELETE RESTRICT,
        indexer_rule_id INTEGER NOT NULL REFERENCES indexer_rule(id) ON DELETE RESTRICT,
        PRIMARY KEY (location_id, indexer_rule_id)
    )
    """,
    # --- misc ----------------------------------------------------------------
    """
    CREATE TABLE preference (
        key   TEXT PRIMARY KEY,
        value BLOB
    )
    """,
    """
    CREATE TABLE notification (
        id         INTEGER PRIMARY KEY AUTOINCREMENT,
        read       INTEGER NOT NULL DEFAULT 0,
        data       BLOB NOT NULL,
        expires_at TEXT
    )
    """,
    """
    CREATE TABLE saved_search (
        id            INTEGER PRIMARY KEY AUTOINCREMENT,
        pub_id        BLOB NOT NULL UNIQUE,
        search        TEXT,
        filters       TEXT,
        name          TEXT,
        icon          TEXT,
        description   TEXT,
        date_created  TEXT,
        date_modified TEXT
    )
    """,
]

# Ordered migrations: MIGRATIONS[v] upgrades user_version v -> v+1.
# Version 0 is an empty database.
MIGRATIONS: list[list[str]] = [
    SCHEMA,
    # v1 -> v2: 64-bit perceptual hash for near-duplicate detection
    # (device-computed; no reference counterpart —
    # spacedrive dedups by exact cas_id only)
    ["ALTER TABLE object ADD COLUMN phash BLOB"],
    # v2 -> v3: persistent index journal (location/indexer/journal.py) —
    # per-path stat identity (inode/dev/mtime_ns/size as u64 LE blobs)
    # vouching for derived results (cas_id column for SQL joins; the
    # msgpack payload carries thumb/media/phash vouches and the
    # dirty-range chunk cache). `stale=1` marks watcher-invalidated
    # entries whose chunk cache is still useful for dirty-range rehash.
    [
        """
        CREATE TABLE index_journal (
            location_id       INTEGER NOT NULL REFERENCES location(id)
                              ON DELETE CASCADE,
            materialized_path TEXT NOT NULL,
            name              TEXT COLLATE NOCASE NOT NULL,
            extension         TEXT COLLATE NOCASE NOT NULL,
            inode             BLOB,
            dev               BLOB,
            mtime_ns          BLOB,
            size              BLOB,
            cas_id            TEXT,
            payload           BLOB,
            stale             INTEGER NOT NULL DEFAULT 0,
            date_vouched      TEXT,
            PRIMARY KEY (location_id, materialized_path, name, extension)
        )
        """,
        "CREATE INDEX idx_index_journal_cas ON index_journal(cas_id)",
    ],
    # v3 -> v4: LWW-order lookup index. sync/ingest.py's
    # is_operation_old and the delete re-apply path both filter by
    # (model, record_id) with a timestamp comparison; without this
    # index EVERY ingested op scans the whole op log for its record —
    # O(ops²) ingest that the mesh work plane's result merging
    # (thousands of cas/object ops converging through sync) turned from
    # slow into prohibitive.
    [
        "CREATE INDEX idx_crdt_model_record_ts ON "
        "crdt_operation(model, record_id, timestamp)",
    ],
    # v4 -> v5: per-object semantic embedding (models/embedder.py) —
    # the vector column is the EMBED_DIM f32 LE blob the search index
    # memmaps; identity rides the object FK like media_data, so the
    # row replicates through the CRDT plane with `object.pub_id` as
    # its sync id (db/sync_registry.py).
    [
        """
        CREATE TABLE object_embedding (
            id              INTEGER PRIMARY KEY AUTOINCREMENT,
            object_id       INTEGER NOT NULL UNIQUE REFERENCES object(id)
                            ON DELETE CASCADE,
            vector          BLOB,
            dim             INTEGER,
            model           TEXT,
            date_calculated TEXT
        )
        """,
    ],
]

# The version every migrated database reports via PRAGMA user_version.
SCHEMA_VERSION = len(MIGRATIONS)
