"""ObjectKind — the object-type taxonomy stored in `object.kind`.

Numbering is wire/DB-stable and must never change (the reference keeps
it in lockstep with its frontend, ref:crates/file-ext/src/kind.rs:7-64).
"""

from __future__ import annotations

import enum


class ObjectKind(enum.IntEnum):
    Unknown = 0          # not identifiable by the indexer
    Document = 1         # known filetype without specific support
    Folder = 2           # virtual filesystem directory
    Text = 3             # human-readable text
    Package = 4          # virtual directory (e.g. macOS bundle)
    Image = 5
    Audio = 6
    Video = 7
    Archive = 8
    Executable = 9
    Alias = 10           # link to another object
    Encrypted = 11       # bytes encrypted by the framework
    Key = 12             # key or certificate
    Link = 13            # opens web pages / apps / spaces
    WebPageArchive = 14
    Widget = 15
    Album = 16
    Collection = 17
    Font = 18
    Mesh = 19            # 3D object
    Code = 20
    Database = 21
    Book = 22
    Config = 23
    Dotfile = 24
    Screenshot = 25
    Label = 26
