"""Key manager — mounted keys + encrypted on-disk keystore.

Parity: ref:crates/crypto/src/keys/keymanager.rs — a per-library key
manager holding *mounted* (usable) keys in memory, backed by stored key
entries (key encrypted under the library's master password via a
keyslot-like record), plus the OS-keyring role (ref:keys/keyring) which
here is an encrypted JSON keystore file next to the library. Secrets
are bytearrays zeroized on unmount (best effort — the reference uses
the `zeroize` crate).

Counterpart of `spacedrive_tpu/crypto/keys.py`: the keystore file is
the same MessagePack bytes (utils/msgpack_codec), so either package's
manager loads the other's.
"""

from __future__ import annotations

import os
import secrets
import uuid
from dataclasses import dataclass
from typing import Any

from ..utils.msgpack_codec import packb, unpackb
from .hashing import HashingAlgorithm, generate_salt
from .stream import Algorithm, CryptoError
from .header import _aead_for


@dataclass
class StoredKey:
    """ref:keymanager.rs `StoredKey`."""

    uuid: str
    algorithm: Algorithm
    hashing_algorithm: HashingAlgorithm
    salt: bytes
    nonce: bytes
    encrypted_key: bytes
    memory_only: bool = False
    automount: bool = False

    def to_wire(self) -> dict[str, Any]:
        return {
            "uuid": self.uuid,
            "a": int(self.algorithm),
            "h": self.hashing_algorithm.to_wire(),
            "s": self.salt,
            "n": self.nonce,
            "k": self.encrypted_key,
            "auto": self.automount,
        }

    @classmethod
    def from_wire(cls, obj: dict[str, Any]) -> "StoredKey":
        return cls(
            uuid=obj["uuid"],
            algorithm=Algorithm(obj["a"]),
            hashing_algorithm=HashingAlgorithm.from_wire(obj["h"]),
            salt=obj["s"],
            nonce=obj["n"],
            encrypted_key=obj["k"],
            automount=obj.get("auto", False),
        )


class KeyManager:
    def __init__(
        self,
        keystore_path: str | None = None,
        *,
        algorithm: Algorithm = Algorithm.XCHACHA20_POLY1305,
        _test_overrides: tuple | None = None,
    ):
        self.path = keystore_path
        self.algorithm = algorithm
        self._overrides = _test_overrides
        self.stored: dict[str, StoredKey] = {}
        self._mounted: dict[str, bytearray] = {}
        self._master: bytearray | None = None
        if self.path and os.path.exists(self.path):
            with open(self.path, "rb") as f:
                for obj in unpackb(f.read()):
                    sk = StoredKey.from_wire(obj)
                    self.stored[sk.uuid] = sk

    # --- master password (unlocks the manager) -------------------------

    def set_master_password(self, password: bytes) -> None:
        self._master = bytearray(password)

    @property
    def unlocked(self) -> bool:
        return self._master is not None

    def _require_master(self) -> bytes:
        if self._master is None:
            raise CryptoError("key manager is locked")
        return bytes(self._master)

    # --- OS keyring (ref:keys/keyring/mod.rs:44-45) --------------------

    _KEYRING_SERVICE = "spacedrive-tpu"

    def remember_master(self, keyring, account: str = "master") -> None:
        """Persist the master password in the OS keyring so the next
        session unlocks without prompting (the reference's keyring
        usage). Call after set_master_password; raises when locked."""
        keyring.set(self._KEYRING_SERVICE, account, self._require_master())

    def unlock_from_keyring(self, keyring, account: str = "master") -> bool:
        """Unlock from a remembered master password; False when the
        keyring has no entry."""
        secret = keyring.get(self._KEYRING_SERVICE, account)
        if secret is None:
            return False
        self.set_master_password(secret)
        return True

    def forget_master(self, keyring, account: str = "master") -> bool:
        return keyring.delete(self._KEYRING_SERVICE, account)

    # --- key CRUD (ref:keymanager.rs add_to_keystore/mount/unmount) ----

    def add_key(
        self,
        key_material: bytes,
        *,
        hashing: HashingAlgorithm | None = None,
        memory_only: bool = False,
        automount: bool = False,
    ) -> str:
        hashing = hashing or HashingAlgorithm(HashingAlgorithm.ARGON2ID)
        salt = generate_salt()
        derived = hashing.hash_password(
            self._require_master(), salt, _test_overrides=self._overrides
        )
        nonce = secrets.token_bytes(self.algorithm.nonce_len)
        enc = _aead_for(self.algorithm, derived).encrypt(nonce, key_material, None)
        sk = StoredKey(
            uuid=str(uuid.uuid4()),
            algorithm=self.algorithm,
            hashing_algorithm=hashing,
            salt=salt,
            nonce=nonce,
            encrypted_key=enc,
            memory_only=memory_only,
            automount=automount,
        )
        self.stored[sk.uuid] = sk
        self._persist()
        return sk.uuid

    def mount(self, key_uuid: str) -> None:
        sk = self.stored.get(key_uuid)
        if sk is None:
            raise CryptoError(f"unknown key {key_uuid}")
        derived = sk.hashing_algorithm.hash_password(
            self._require_master(), sk.salt, _test_overrides=self._overrides
        )
        # constructed OUTSIDE the decrypt try: a crypto-unavailable
        # refusal (gated AEAD) must surface as itself, not be
        # misreported as a wrong password
        aead = _aead_for(sk.algorithm, derived)
        try:
            key = aead.decrypt(sk.nonce, sk.encrypted_key, None)
        except Exception as e:
            raise CryptoError("wrong master password for key") from e
        self._mounted[key_uuid] = bytearray(key)

    def automount(self) -> int:
        n = 0
        for sk in self.stored.values():
            if sk.automount and sk.uuid not in self._mounted:
                self.mount(sk.uuid)
                n += 1
        return n

    def get_key(self, key_uuid: str) -> bytes:
        key = self._mounted.get(key_uuid)
        if key is None:
            raise CryptoError(f"key {key_uuid} not mounted")
        return bytes(key)

    def unmount(self, key_uuid: str) -> None:
        key = self._mounted.pop(key_uuid, None)
        if key is not None:
            for i in range(len(key)):
                key[i] = 0

    def unmount_all(self) -> None:
        for key_uuid in list(self._mounted):
            self.unmount(key_uuid)

    def delete_key(self, key_uuid: str) -> None:
        self.unmount(key_uuid)
        self.stored.pop(key_uuid, None)
        self._persist()

    def mounted_uuids(self) -> list[str]:
        return list(self._mounted)

    def lock(self) -> None:
        """Unmount everything and forget the master password."""
        self.unmount_all()
        if self._master is not None:
            for i in range(len(self._master)):
                self._master[i] = 0
            self._master = None

    def _persist(self) -> None:
        if not self.path:
            return
        data = packb(
            [sk.to_wire() for sk in self.stored.values() if not sk.memory_only]
        )
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, self.path)
