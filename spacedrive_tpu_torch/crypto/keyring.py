"""OS keyring — Secret Service integration via libsecret, with the
encrypted file keystore as the portable fallback.

Parity: ref:crates/crypto/src/keys/keyring/mod.rs:44-45 — the reference
stores library secrets in the OS keyring (Secret Service on Linux,
Keychain on macOS) through the `secret-service` crate. Here the same
desktop integration goes through libsecret's password API over ctypes
(libsecret speaks the Secret Service D-Bus protocol to whatever daemon
— gnome-keyring, KWallet — owns the session). Headless hosts without
libsecret/D-Bus keep the encrypted keystore file (crypto/keys.py), and
`default_keyring()` returns None so callers fall back explicitly.

The ctypes structs mirror libsecret's public ABI (SecretSchema with 32
inline attributes + reserved fields); the binding is exercised in tests
against a stub libsecret built from source, so the call contract is
pinned even on hosts without the real library.

Counterpart of `spacedrive_tpu/crypto/keyring.py`: the same schema,
attributes and hex transport, so an entry either package stores reads
in the other.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import logging

logger = logging.getLogger(__name__)

_SECRET_SCHEMA_NONE = 0
_ATTR_STRING = 0
_COLLECTION_DEFAULT = None  # libsecret: NULL = default collection


class _SchemaAttribute(ctypes.Structure):
    _fields_ = [("name", ctypes.c_char_p), ("type", ctypes.c_int)]


class _SecretSchema(ctypes.Structure):
    _fields_ = [
        ("name", ctypes.c_char_p),
        ("flags", ctypes.c_int),
        ("attributes", _SchemaAttribute * 32),
        # libsecret reserves expansion space in the public struct
        ("reserved", ctypes.c_int),
        *[(f"reserved{i}", ctypes.c_void_p) for i in range(1, 8)],
    ]


class KeyringError(Exception):
    pass


class LibsecretKeyring:
    """Secret Service keyring through libsecret's sync password API.

    Secrets are keyed by (service, account) string attributes under the
    one spacedrive schema — the shape the reference's keyring entries
    use (Identifier{application, library_uuid, usage},
    ref:keyring/mod.rs)."""

    def __init__(self, lib_path: str | None = None):
        path = lib_path or ctypes.util.find_library("secret-1")
        if path is None:
            raise KeyringError("libsecret not available")
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            raise KeyringError(f"libsecret load failed: {e}") from e
        V, S = ctypes.c_void_p, ctypes.c_char_p
        lib.secret_password_store_sync.restype = ctypes.c_int
        lib.secret_password_lookup_sync.restype = V  # char* (freed below)
        lib.secret_password_clear_sync.restype = ctypes.c_int
        lib.secret_password_free.argtypes = [V]
        lib.secret_password_free.restype = None
        self._lib = lib

        self._schema = _SecretSchema()
        self._schema.name = b"com.spacedrive.tpu.Secret"
        self._schema.flags = _SECRET_SCHEMA_NONE
        self._schema.attributes[0] = _SchemaAttribute(b"service", _ATTR_STRING)
        self._schema.attributes[1] = _SchemaAttribute(b"account", _ATTR_STRING)
        self._schema.attributes[2] = _SchemaAttribute(None, 0)

    def set(self, service: str, account: str, secret: bytes) -> None:
        ok = self._lib.secret_password_store_sync(
            ctypes.byref(self._schema),
            _COLLECTION_DEFAULT,
            f"spacedrive {service}/{account}".encode(),
            secret.hex().encode(),  # hex: secrets may be binary
            None, None,
            b"service", service.encode(),
            b"account", account.encode(),
            ctypes.c_void_p(None),
        )
        if not ok:
            raise KeyringError("secret store failed")

    def get(self, service: str, account: str) -> bytes | None:
        raw = self._lib.secret_password_lookup_sync(
            ctypes.byref(self._schema), None, None,
            b"service", service.encode(),
            b"account", account.encode(),
            ctypes.c_void_p(None),
        )
        if not raw:
            return None
        try:
            return bytes.fromhex(ctypes.cast(raw, ctypes.c_char_p).value.decode())
        except ValueError as e:
            raise KeyringError(f"corrupt keyring entry: {e}") from e
        finally:
            self._lib.secret_password_free(raw)

    def delete(self, service: str, account: str) -> bool:
        return bool(self._lib.secret_password_clear_sync(
            ctypes.byref(self._schema), None, None,
            b"service", service.encode(),
            b"account", account.encode(),
            ctypes.c_void_p(None),
        ))


def default_keyring() -> LibsecretKeyring | None:
    """The OS keyring when the host has one; None on headless boxes
    (callers keep the encrypted file keystore)."""
    try:
        return LibsecretKeyring()
    except KeyringError:
        return None
