"""Encrypted-file header — keyslots, metadata, preview media.

Parity: ref:crates/crypto/src/header/* — `FileHeader{version,
algorithm, nonce, keyslots[≤2], metadata, preview_media}`
(header/file.rs): each `Keyslot` stores (hashing algorithm, salt,
master-key nonce, encrypted master key) so either of two passwords can
unlock the file; optional `Metadata`/`PreviewMedia` objects are
encrypted under the same master key and authenticated as AAD-free
sections. The header bytes up to the section table are fed to the body
stream as AAD, so swapping headers between files fails decryption —
the same binding the reference gets by passing the header as AAD
(header/file.rs `to_writer`/`from_reader` + stream AAD).

Counterpart of `spacedrive_tpu/crypto/header.py`: MessagePack through
utils/msgpack_codec, which writes the bytes of the `msgpack` package, so
the same header is the same bytes.
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass, field
from typing import Any, BinaryIO

from ..utils.msgpack_codec import packb, unpackb
from .hashing import HashingAlgorithm, generate_salt
from .stream import (
    KEY_LEN,
    Algorithm,
    CryptoError,
    StreamDecryption,
    StreamEncryption,
)
from .xchacha import XChaCha20Poly1305

MAGIC = b"sdcrypt\x00"  # 8 bytes (the reference uses a magic+version prefix)
HEADER_VERSION = 1
MAX_KEYSLOTS = 2  # ref:header/keyslot.rs


def _aead_for(algorithm: Algorithm, key: bytes):
    if algorithm is Algorithm.XCHACHA20_POLY1305:
        return XChaCha20Poly1305(key)
    try:
        from cryptography.hazmat.primitives.ciphers.aead import AESGCM
    except ImportError:
        raise CryptoError(
            "the `cryptography` package is required for AES-256-GCM")
    return AESGCM(key)


@dataclass
class Keyslot:
    """ref:header/keyslot.rs `Keyslot`."""

    hashing_algorithm: HashingAlgorithm
    salt: bytes
    nonce: bytes
    encrypted_master_key: bytes  # 32 + 16 tag

    def to_wire(self) -> dict[str, Any]:
        return {
            "h": self.hashing_algorithm.to_wire(),
            "s": self.salt,
            "n": self.nonce,
            "k": self.encrypted_master_key,
        }

    @classmethod
    def from_wire(cls, obj: dict[str, Any]) -> "Keyslot":
        return cls(
            HashingAlgorithm.from_wire(obj["h"]), obj["s"], obj["n"], obj["k"]
        )


@dataclass
class FileHeader:
    algorithm: Algorithm
    nonce: bytes  # the body's STREAM base nonce
    keyslots: list[Keyslot] = field(default_factory=list)
    metadata: bytes | None = None  # encrypted msgpack
    metadata_nonce: bytes | None = None
    preview_media: bytes | None = None  # encrypted bytes (e.g. thumbnail)
    preview_media_nonce: bytes | None = None
    version: int = HEADER_VERSION

    # --- keyslots ------------------------------------------------------

    def add_keyslot(
        self,
        master_key: bytes,
        password: bytes,
        hashing_algorithm: HashingAlgorithm,
        *,
        _test_overrides: tuple | None = None,
    ) -> None:
        """ref:header/file.rs `add_keyslot`."""
        if len(self.keyslots) >= MAX_KEYSLOTS:
            raise CryptoError(f"at most {MAX_KEYSLOTS} keyslots")
        salt = generate_salt()
        derived = hashing_algorithm.hash_password(
            password, salt, _test_overrides=_test_overrides
        )
        nonce = secrets.token_bytes(self.algorithm.nonce_len)
        enc = _aead_for(self.algorithm, derived).encrypt(nonce, master_key, None)
        self.keyslots.append(Keyslot(hashing_algorithm, salt, nonce, enc))

    def decrypt_master_key(
        self, password: bytes, *, _test_overrides: tuple | None = None
    ) -> bytes:
        """Try every keyslot (ref:header/file.rs `decrypt_master_key`)."""
        for slot in self.keyslots:
            derived = slot.hashing_algorithm.hash_password(
                password, slot.salt, _test_overrides=_test_overrides
            )
            try:
                return _aead_for(self.algorithm, derived).decrypt(
                    slot.nonce, slot.encrypted_master_key, None
                )
            except Exception:
                continue
        raise CryptoError("no keyslot matched the provided password")

    # --- optional sections (ref:header/{metadata,preview_media}.rs) ----

    def set_metadata(self, master_key: bytes, obj: Any) -> None:
        nonce = secrets.token_bytes(self.algorithm.nonce_len)
        self.metadata = _aead_for(self.algorithm, master_key).encrypt(
            nonce, packb(obj), None
        )
        self.metadata_nonce = nonce

    def get_metadata(self, master_key: bytes) -> Any:
        if self.metadata is None:
            return None
        return unpackb(
            _aead_for(self.algorithm, master_key).decrypt(
                self.metadata_nonce, self.metadata, None
            )
        )

    def set_preview_media(self, master_key: bytes, media: bytes) -> None:
        nonce = secrets.token_bytes(self.algorithm.nonce_len)
        self.preview_media = _aead_for(self.algorithm, master_key).encrypt(
            nonce, media, None
        )
        self.preview_media_nonce = nonce

    def get_preview_media(self, master_key: bytes) -> bytes | None:
        if self.preview_media is None:
            return None
        return _aead_for(self.algorithm, master_key).decrypt(
            self.preview_media_nonce, self.preview_media, None
        )

    # --- wire ----------------------------------------------------------

    def to_bytes(self) -> bytes:
        body = packb(
            {
                "v": self.version,
                "a": int(self.algorithm),
                "n": self.nonce,
                "ks": [k.to_wire() for k in self.keyslots],
                "md": self.metadata,
                "mdn": self.metadata_nonce,
                "pv": self.preview_media,
                "pvn": self.preview_media_nonce,
            }
        )
        return MAGIC + len(body).to_bytes(4, "big") + body

    @classmethod
    def from_reader(cls, reader: BinaryIO) -> tuple["FileHeader", bytes]:
        """Returns (header, raw_bytes) — raw bytes double as body AAD."""
        magic = reader.read(len(MAGIC))
        if magic != MAGIC:
            raise CryptoError("not an encrypted file (bad magic)")
        ln = int.from_bytes(reader.read(4), "big")
        if ln > 16 * 1024 * 1024:
            raise CryptoError("oversized header")
        body = reader.read(ln)
        if len(body) != ln:
            raise CryptoError("truncated header")
        obj = unpackb(body)
        header = cls(
            algorithm=Algorithm(obj["a"]),
            nonce=obj["n"],
            keyslots=[Keyslot.from_wire(k) for k in obj["ks"]],
            metadata=obj.get("md"),
            metadata_nonce=obj.get("mdn"),
            preview_media=obj.get("pv"),
            preview_media_nonce=obj.get("pvn"),
            version=obj.get("v", HEADER_VERSION),
        )
        return header, MAGIC + ln.to_bytes(4, "big") + body


# --- whole-file convenience (ref:crypto examples + fs jobs) --------------


def encrypt_file(
    src: str,
    dst: str,
    password: bytes,
    *,
    algorithm: Algorithm = Algorithm.XCHACHA20_POLY1305,
    hashing: HashingAlgorithm | None = None,
    metadata: Any = None,
    preview_media: bytes | None = None,
    _test_overrides: tuple | None = None,
) -> None:
    hashing = hashing or HashingAlgorithm(HashingAlgorithm.ARGON2ID)
    master_key = secrets.token_bytes(KEY_LEN)
    header = FileHeader(algorithm=algorithm, nonce=algorithm.generate_nonce())
    header.add_keyslot(master_key, password, hashing, _test_overrides=_test_overrides)
    if metadata is not None:
        header.set_metadata(master_key, metadata)
    if preview_media is not None:
        header.set_preview_media(master_key, preview_media)
    raw = header.to_bytes()
    with open(src, "rb") as fin, open(dst, "wb") as fout:
        fout.write(raw)
        StreamEncryption(master_key, header.nonce, algorithm).encrypt_streams(
            fin, fout, aad=raw
        )


def decrypt_file(
    src: str, dst: str, password: bytes, *, _test_overrides: tuple | None = None
) -> Any:
    """Returns the decrypted metadata (if any)."""
    with open(src, "rb") as fin:
        header, raw = FileHeader.from_reader(fin)
        master_key = header.decrypt_master_key(
            password, _test_overrides=_test_overrides
        )
        with open(dst, "wb") as fout:
            StreamDecryption(
                master_key, header.nonce, header.algorithm
            ).decrypt_streams(fin, fout, aad=raw)
    return header.get_metadata(master_key)
