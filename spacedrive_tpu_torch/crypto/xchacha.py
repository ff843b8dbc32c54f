"""XChaCha20-Poly1305 — extended-nonce AEAD.

Parity: ref:crates/crypto/src/crypto/stream.rs:8-13 — the reference's
primary AEAD is XChaCha20-Poly1305 (24-byte nonce) from the `aead`
crate family. `cryptography` ships only the IETF 12-byte-nonce
ChaCha20Poly1305, so this module adds the missing HChaCha20 subkey
step (RFC draft-irtf-cfrg-xchacha-03): subkey = HChaCha20(key,
nonce[0:16]); then IETF ChaCha20-Poly1305 with nonce 0x00000000 ‖
nonce[16:24]. HChaCha20 runs once per message in pure Python (20
rounds over 16 words — microseconds); bulk crypto stays in OpenSSL.
Verified against the RFC test vector (tests/test_crypto.py).

Counterpart of `spacedrive_tpu/crypto/xchacha.py`.
"""

from __future__ import annotations

import struct

try:
    from cryptography.hazmat.primitives.ciphers.aead import ChaCha20Poly1305
except ImportError:  # gated: construction refuses below
    ChaCha20Poly1305 = None  # type: ignore

_MASK = 0xFFFFFFFF


def _rotl(v: int, c: int) -> int:
    return ((v << c) | (v >> (32 - c))) & _MASK


def _quarter(state: list[int], a: int, b: int, c: int, d: int) -> None:
    state[a] = (state[a] + state[b]) & _MASK
    state[d] = _rotl(state[d] ^ state[a], 16)
    state[c] = (state[c] + state[d]) & _MASK
    state[b] = _rotl(state[b] ^ state[c], 12)
    state[a] = (state[a] + state[b]) & _MASK
    state[d] = _rotl(state[d] ^ state[a], 8)
    state[c] = (state[c] + state[d]) & _MASK
    state[b] = _rotl(state[b] ^ state[c], 7)


def hchacha20(key: bytes, nonce16: bytes) -> bytes:
    """HChaCha20(key, 16-byte nonce) -> 32-byte subkey."""
    if len(key) != 32 or len(nonce16) != 16:
        raise ValueError("hchacha20 needs 32-byte key + 16-byte nonce")
    state = [
        0x61707865, 0x3320646E, 0x79622D32, 0x6B206574,
        *struct.unpack("<8I", key),
        *struct.unpack("<4I", nonce16),
    ]
    for _ in range(10):  # 10 double rounds = 20 rounds
        _quarter(state, 0, 4, 8, 12)
        _quarter(state, 1, 5, 9, 13)
        _quarter(state, 2, 6, 10, 14)
        _quarter(state, 3, 7, 11, 15)
        _quarter(state, 0, 5, 10, 15)
        _quarter(state, 1, 6, 11, 12)
        _quarter(state, 2, 7, 8, 13)
        _quarter(state, 3, 4, 9, 14)
    return struct.pack("<8I", *(state[i] for i in (0, 1, 2, 3, 12, 13, 14, 15)))


class XChaCha20Poly1305:
    """Drop-in sibling of cryptography's AEAD classes, 24-byte nonce."""

    NONCE_LEN = 24

    def __init__(self, key: bytes):
        if ChaCha20Poly1305 is None:
            # CryptoError so keys/stream/header handlers see a clean
            # "crypto unavailable" instead of misreading the refusal
            # as a wrong password (lazy import: stream imports us)
            from .stream import CryptoError

            raise CryptoError(
                "the `cryptography` package is required for XChaCha20")
        if len(key) != 32:
            raise ValueError("key must be 32 bytes")
        self._key = key

    def _inner(self, nonce: bytes) -> tuple[ChaCha20Poly1305, bytes]:
        if len(nonce) != self.NONCE_LEN:
            raise ValueError("nonce must be 24 bytes")
        subkey = hchacha20(self._key, nonce[:16])
        return ChaCha20Poly1305(subkey), b"\x00\x00\x00\x00" + nonce[16:]

    def encrypt(self, nonce: bytes, data: bytes, aad: bytes | None) -> bytes:
        aead, n12 = self._inner(nonce)
        return aead.encrypt(n12, data, aad)

    def decrypt(self, nonce: bytes, data: bytes, aad: bytes | None) -> bytes:
        aead, n12 = self._inner(nonce)
        return aead.decrypt(n12, data, aad)
