"""Peer-identity metric labels — capped, stable short-hashes.

An owned copy of `spacedrive_tpu/telemetry/peers.py`: the same
identifier gives the same label in both packages.

Raw instance/peer identifiers (uuid4 pub_ids, ed25519 identity
strings) must NEVER ride metric labels: every new peer would mint a
fresh series until the family's cardinality cap silently folds samples
into ``__overflow__``, and the label itself would leak a long-lived
identifier into every scrape. ``peer_label`` is the one sanctioned
mapping: a stable 8-hex-char BLAKE2 digest of the identifier —

- stable: the same instance hashes to the same label across restarts,
  so dashboards and alerts can track one replica over time;
- capped: 8 hex chars bound the label length, and the per-family series
  cap (``registry.MAX_SERIES_PER_FAMILY``) bounds the count — a mesh
  larger than the cap degrades to ``__overflow__`` instead of eating
  memory;
- non-reversible: a scrape consumer learns "some peer", not which
  ed25519 identity (mesh-level correlation needs the /mesh surface,
  which maps labels back to peers explicitly for operators).
"""

from __future__ import annotations

import hashlib
import uuid
from typing import Any

PEER_LABEL_HEX_CHARS = 8


def peer_label(peer_id: Any) -> str:
    """The metric-label form of a peer/instance identifier.

    Accepts a ``uuid.UUID`` (instance pub_id), ``bytes`` (raw pub_id /
    identity key), or any object whose ``str()`` names the peer (a
    ``RemoteIdentity``). Returns a stable 8-hex-char digest.
    """
    if isinstance(peer_id, uuid.UUID):
        raw = peer_id.bytes
    elif isinstance(peer_id, (bytes, bytearray)):
        raw = bytes(peer_id)
    else:
        raw = str(peer_id).encode()
    return hashlib.blake2b(raw, digest_size=8).hexdigest()[:PEER_LABEL_HEX_CHARS]
