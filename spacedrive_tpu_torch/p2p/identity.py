"""Node/instance identity keypairs.

Parity: ref:crates/p2p2/src/identity.rs — `Identity` (ed25519 signing
keypair, serialized as the 32-byte secret) and `RemoteIdentity` (the
32-byte verifying key, displayed base64/hex). The reference derives its
libp2p PeerId from the same keypair; here the verifying key itself is
the peer address on the mesh.

Counterpart of `Identity` and `RemoteIdentity` in
`spacedrive_tpu/p2p/identity.py`, with the same gate: the
`cryptography` package when it imports, else the pure-Python RFC 8032
fallback (utils/ed25519_fallback.py).
"""

from __future__ import annotations

import base64

try:
    from cryptography.hazmat.primitives import serialization
    from cryptography.hazmat.primitives.asymmetric.ed25519 import (
        Ed25519PrivateKey,
        Ed25519PublicKey,
    )

    _HAVE_CRYPTOGRAPHY = True
except ImportError:  # gated: pure-Python RFC 8032 keeps node boot alive
    from ..utils.ed25519_fallback import Ed25519PrivateKey, Ed25519PublicKey

    serialization = None
    _HAVE_CRYPTOGRAPHY = False


class RemoteIdentity:
    """Verifying half of an identity (ref:identity.rs `RemoteIdentity`)."""

    __slots__ = ("_key", "_raw")

    def __init__(self, raw: bytes):
        if len(raw) != 32:
            raise ValueError("RemoteIdentity must be 32 bytes")
        self._raw = bytes(raw)
        self._key = Ed25519PublicKey.from_public_bytes(self._raw)

    def to_bytes(self) -> bytes:
        return self._raw

    def verify(self, signature: bytes, message: bytes) -> bool:
        try:
            self._key.verify(signature, message)
            return True
        except Exception:
            return False

    def __eq__(self, other: object) -> bool:
        return isinstance(other, RemoteIdentity) and other._raw == self._raw

    def __hash__(self) -> int:
        return hash(self._raw)

    def __str__(self) -> str:
        # reference displays RemoteIdentity base64 (identity.rs Display)
        return base64.urlsafe_b64encode(self._raw).decode().rstrip("=")

    def __repr__(self) -> str:
        return f"<RemoteIdentity {str(self)[:12]}…>"

    @classmethod
    def from_str(cls, s: str) -> "RemoteIdentity":
        pad = "=" * (-len(s) % 4)
        return cls(base64.urlsafe_b64decode(s + pad))


class Identity:
    """Signing keypair (ref:identity.rs `Identity`); serialized as the
    32-byte ed25519 seed."""

    __slots__ = ("_key",)

    def __init__(self, key: Ed25519PrivateKey | None = None):
        self._key = key or Ed25519PrivateKey.generate()

    @classmethod
    def from_bytes(cls, seed: bytes) -> "Identity":
        if len(seed) != 32:
            raise ValueError("Identity seed must be 32 bytes")
        return cls(Ed25519PrivateKey.from_private_bytes(seed))

    def to_bytes(self) -> bytes:
        if not _HAVE_CRYPTOGRAPHY:
            return self._key.private_bytes()
        return self._key.private_bytes(
            serialization.Encoding.Raw,
            serialization.PrivateFormat.Raw,
            serialization.NoEncryption(),
        )

    def to_remote_identity(self) -> RemoteIdentity:
        if not _HAVE_CRYPTOGRAPHY:
            return RemoteIdentity(self._key.public_key().public_bytes())
        return RemoteIdentity(
            self._key.public_key().public_bytes(
                serialization.Encoding.Raw, serialization.PublicFormat.Raw
            )
        )

    def sign(self, message: bytes) -> bytes:
        return self._key.sign(message)
