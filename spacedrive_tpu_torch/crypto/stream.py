"""Stream AEAD — bounded-memory encryption of arbitrarily large files.

Parity: ref:crates/crypto/src/crypto/stream.rs — `Algorithm::
{XChaCha20Poly1305, Aes256Gcm}` (:8-13) wrapped in the `aead` crate's
STREAM construction (`EncryptorLE31`, :153-168): per-message nonce =
base ‖ u32-LE counter ‖ last-block flag byte, so the base nonce is
(nonce_len − 5) bytes — 19 for XChaCha, 7 for AES-GCM — and truncation
or reordering of the 1 MiB blocks is detected. Block size matches the
reference's `BLOCK_LEN` (1 MiB, crypto/mod.rs).

Counterpart of `spacedrive_tpu/crypto/stream.py`, with its import gate
on `cryptography`.
"""

from __future__ import annotations

import enum
import secrets
from typing import BinaryIO

try:
    from cryptography.exceptions import InvalidTag
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM
except ImportError:  # gated: AEADs refuse at construction time below
    AESGCM = None  # type: ignore

    class InvalidTag(Exception):  # type: ignore[no-redef]
        """Placeholder so except-clauses stay valid; never raised."""

from .xchacha import XChaCha20Poly1305

BLOCK_LEN = 1024 * 1024  # ref:crypto/mod.rs BLOCK_LEN
TAG_LEN = 16
KEY_LEN = 32


class CryptoError(Exception):
    pass


class Algorithm(enum.IntEnum):
    """ref:stream.rs:8-13."""

    XCHACHA20_POLY1305 = 0
    AES_256_GCM = 1

    @property
    def nonce_len(self) -> int:
        return 24 if self is Algorithm.XCHACHA20_POLY1305 else 12

    @property
    def stream_nonce_len(self) -> int:
        # base nonce for LE31 STREAM: full nonce minus 4 counter + 1 flag
        return self.nonce_len - 5

    def generate_nonce(self) -> bytes:
        return secrets.token_bytes(self.stream_nonce_len)


class _Stream:
    def __init__(self, key: bytes, base_nonce: bytes, algorithm: Algorithm):
        if len(key) != KEY_LEN:
            raise CryptoError("key must be 32 bytes")
        if len(base_nonce) != algorithm.stream_nonce_len:
            raise CryptoError(
                f"nonce must be {algorithm.stream_nonce_len} bytes for {algorithm.name}"
            )
        self.algorithm = algorithm
        self.base_nonce = base_nonce
        self.counter = 0
        if algorithm is not Algorithm.XCHACHA20_POLY1305 and AESGCM is None:
            raise CryptoError(
                "the `cryptography` package is required for AES-256-GCM")
        self._aead = (
            XChaCha20Poly1305(key)
            if algorithm is Algorithm.XCHACHA20_POLY1305
            else AESGCM(key)
        )

    def _nonce(self, last: bool) -> bytes:
        # LE31: base ‖ counter (u32 LE) ‖ last-block flag
        if self.counter >= 1 << 31:
            raise CryptoError("stream counter overflow")
        n = (
            self.base_nonce
            + self.counter.to_bytes(4, "little")
            + (b"\x01" if last else b"\x00")
        )
        self.counter += 1
        return n


class StreamEncryption(_Stream):
    def encrypt_next(self, plaintext: bytes, aad: bytes = b"", *, last: bool) -> bytes:
        return self._aead.encrypt(self._nonce(last), plaintext, aad or None)

    def encrypt_streams(
        self, reader: BinaryIO, writer: BinaryIO, aad: bytes = b""
    ) -> int:
        """ref:stream.rs `encrypt_streams` — 1 MiB blocks; AAD bound to
        the first block only (header authentication), like the reference."""
        total = 0
        block = reader.read(BLOCK_LEN)
        first = True
        while True:
            nxt = reader.read(BLOCK_LEN)
            ct = self.encrypt_next(block, aad if first else b"", last=not nxt)
            writer.write(ct)
            total += len(block)
            first = False
            if not nxt:
                return total
            block = nxt


class StreamDecryption(_Stream):
    def decrypt_next(self, ciphertext: bytes, aad: bytes = b"", *, last: bool) -> bytes:
        try:
            return self._aead.decrypt(self._nonce(last), ciphertext, aad or None)
        except InvalidTag as e:
            raise CryptoError("decryption failed (wrong key or tampered data)") from e

    def decrypt_streams(
        self, reader: BinaryIO, writer: BinaryIO, aad: bytes = b""
    ) -> int:
        total = 0
        block = reader.read(BLOCK_LEN + TAG_LEN)
        first = True
        while True:
            nxt = reader.read(BLOCK_LEN + TAG_LEN)
            pt = self.decrypt_next(block, aad if first else b"", last=not nxt)
            writer.write(pt)
            total += len(pt)
            first = False
            if not nxt:
                return total
            block = nxt
