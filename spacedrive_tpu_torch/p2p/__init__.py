"""P2P mesh: identity, transport, discovery, protocol, transfer.

Parity: ref:crates/p2p2 (runtime), crates/p2p-block (Spaceblock),
crates/p2p-proto (wire helpers), core/src/p2p (protocol + operations).
The reference rides QUIC on a patched libp2p; here streams are
length-framed asyncio TCP with an ed25519-authenticated X25519 +
ChaCha20-Poly1305 channel (same trust model: identity keypairs, no CA).

Counterpart of `spacedrive_tpu/p2p/`, with the same exports: the
transport (identity, wire, Spaceblock, headers, Noise XX, the encrypted
streams, the `P2P` runtime, UDP streams, hole punching, the relay,
tunnels and discovery) and the node's half (the manager, its
operations, pairing, sync and remote rspc over the mesh, the work plane
and the loopback link).
"""

from .block import BlockSize, Range, SpaceblockRequest, SpaceblockRequests, Transfer
from .identity import Identity, RemoteIdentity
from .p2p import P2P, Peer
from .protocol import FileRequest, Header, HeaderType

__all__ = [
    "BlockSize",
    "FileRequest",
    "Header",
    "HeaderType",
    "Identity",
    "P2P",
    "Peer",
    "Range",
    "RemoteIdentity",
    "SpaceblockRequest",
    "SpaceblockRequests",
    "Transfer",
]
