"""Encryption stack.

Parity: ref:crates/crypto — stream AEAD (XChaCha20-Poly1305 +
AES-256-GCM, STREAM LE31 construction), Argon2id + Balloon-BLAKE3 key
hashing, encrypted-file header with keyslots/metadata/preview-media,
key manager with encrypted keystore; secure erase lives with the fs
jobs (spacedrive_tpu/object/fs/erase.py).

Counterpart of `spacedrive_tpu/crypto/`: the same header, keystore
and ciphertext bytes under the same randomness, so a file or a keystore
written by either package opens in the other. Like JAX's, the AEADs and
Argon2id need the `cryptography` package and refuse without it.
"""

from .hashing import HashingAlgorithm, Params, balloon_blake3, generate_salt
from .header import FileHeader, Keyslot, decrypt_file, encrypt_file
from .keys import KeyManager, StoredKey
from .stream import (
    BLOCK_LEN,
    KEY_LEN,
    Algorithm,
    CryptoError,
    StreamDecryption,
    StreamEncryption,
)
from .xchacha import XChaCha20Poly1305, hchacha20

__all__ = [
    "Algorithm",
    "BLOCK_LEN",
    "CryptoError",
    "FileHeader",
    "HashingAlgorithm",
    "KEY_LEN",
    "KeyManager",
    "Keyslot",
    "Params",
    "StoredKey",
    "StreamDecryption",
    "StreamEncryption",
    "XChaCha20Poly1305",
    "balloon_blake3",
    "decrypt_file",
    "encrypt_file",
    "generate_salt",
    "hchacha20",
]
