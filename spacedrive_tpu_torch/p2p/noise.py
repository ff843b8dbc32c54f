"""Noise Protocol Framework — XX handshake over 25519/ChaChaPoly/SHA256.

Parity: ref:crates/p2p2/Cargo.toml pins a patched libp2p whose secure
channel is libp2p-noise (`Noise_XX_25519_ChaChaPoly_SHA256` plus a
signed identity payload).  This module implements the same, directly
from the public Noise specification (revision 34, noiseprotocol.org):

- ``CipherState`` (spec §5.1): ChaCha20-Poly1305 with the 64-bit
  little-endian counter nonce layout of spec §12.2.
- ``SymmetricState`` (spec §5.2): SHA256 hash chain ``h``, chaining key
  ``ck``, and the two-output HKDF of spec §4.3.
- ``HandshakeState`` (spec §5.3) specialised to the XX pattern
  (spec §7.5):  ``-> e``, ``<- e ee s es``, ``-> s se``.

The state machine is written token-for-token against the spec so it can
be checked against the published cacophony/snow vector corpus — the
test suite (tests/test_noise.py) validates structural spec invariants
(message sizes, hash agreement, HKDF composition) and, when a standard
``vectors.json`` in cacophony format is present at
``tests/data/noise_vectors.json``, replays every
``Noise_XX_25519_ChaChaPoly_SHA256`` vector byte-for-byte.  This build
environment has no network egress so the corpus is not bundled; the
``Vector hook`` below documents the exact expected format.

Identity binding follows the public libp2p-noise spec: each party's
handshake payload carries its ed25519 identity public key and a
signature over ``"noise-libp2p-static-key:" || x25519_static_pub``,
binding the long-lived identity to the Noise static key for this
session.  See docs/security.md for the full security argument.

Counterpart of `spacedrive_tpu/p2p/noise.py`: the same messages under
the same keys, and the same hard requirement on `cryptography`'s X25519
and ChaCha20-Poly1305 (the module imports without it; a handshake or a
keyed cipher then raises `NoiseError`).
"""

from __future__ import annotations

import hashlib
import hmac
import struct

try:
    from cryptography.hazmat.primitives import serialization
    from cryptography.hazmat.primitives.asymmetric.x25519 import (
        X25519PrivateKey,
        X25519PublicKey,
    )
    from cryptography.hazmat.primitives.ciphers.aead import ChaCha20Poly1305

    _HAVE_CRYPTOGRAPHY = True
except ImportError:  # gated: imports stay alive; channels refuse below
    serialization = X25519PrivateKey = X25519PublicKey = None  # type: ignore
    ChaCha20Poly1305 = None  # type: ignore
    _HAVE_CRYPTOGRAPHY = False

PROTOCOL_NAME = b"Noise_XX_25519_ChaChaPoly_SHA256"
DHLEN = 32
TAGLEN = 16
MAX_MESSAGE = 65535  # spec §3: a Noise transport message is <= 65535 bytes
MAX_PLAINTEXT = MAX_MESSAGE - TAGLEN

# libp2p-noise static-key-binding context (public libp2p spec, noise/README.md)
IDENTITY_CONTEXT = b"noise-libp2p-static-key:"


class NoiseError(Exception):
    pass


def require_crypto() -> None:
    """Encrypted channels hard-require the real `cryptography` AEADs —
    no pure-Python degradation for wire security. Raises where a
    handshake would otherwise start."""
    if not _HAVE_CRYPTOGRAPHY:
        raise NoiseError(
            "the `cryptography` package is required for Noise channels"
        )


def _hkdf(chaining_key: bytes, ikm: bytes, n: int) -> tuple[bytes, ...]:
    """Spec §4.3 HKDF: HMAC-SHA256 chain keyed by ck."""
    temp = hmac.new(chaining_key, ikm, hashlib.sha256).digest()
    out1 = hmac.new(temp, b"\x01", hashlib.sha256).digest()
    out2 = hmac.new(temp, out1 + b"\x02", hashlib.sha256).digest()
    if n == 2:
        return out1, out2
    out3 = hmac.new(temp, out2 + b"\x03", hashlib.sha256).digest()
    return out1, out2, out3


def _dh(priv: X25519PrivateKey, pub_raw: bytes) -> bytes:
    # ValueError covers both bad-length keys and the all-zero shared
    # secret rejection; surface both as protocol errors so transports
    # map them to a clean handshake failure.
    try:
        return priv.exchange(X25519PublicKey.from_public_bytes(pub_raw))
    except ValueError as exc:
        raise NoiseError("invalid DH public key") from exc


def _pub_raw(priv: X25519PrivateKey) -> bytes:
    return priv.public_key().public_bytes(
        serialization.Encoding.Raw, serialization.PublicFormat.Raw
    )


class CipherState:
    """Spec §5.1 — AEAD key + 64-bit nonce counter."""

    __slots__ = ("_k", "_n", "_aead")

    def __init__(self, k: bytes | None = None):
        self.initialize_key(k)

    def initialize_key(self, k: bytes | None) -> None:
        if k is not None:
            require_crypto()
        self._k = k
        self._aead = ChaCha20Poly1305(k) if k is not None else None
        self._n = 0

    def has_key(self) -> bool:
        return self._k is not None

    def _nonce(self) -> bytes:
        # spec §12.2: 32 zero bits then the counter as 64-bit little-endian
        if self._n >= 2**64 - 1:  # 2^64-1 reserved for rekey
            raise NoiseError("nonce exhausted")
        return struct.pack("<IQ", 0, self._n)

    def encrypt_with_ad(self, ad: bytes, plaintext: bytes) -> bytes:
        if self._aead is None:
            return plaintext
        ct = self._aead.encrypt(self._nonce(), plaintext, ad)
        self._n += 1
        return ct

    def decrypt_with_ad(self, ad: bytes, ciphertext: bytes) -> bytes:
        if self._aead is None:
            return ciphertext
        try:
            pt = self._aead.decrypt(self._nonce(), ciphertext, ad)
        except Exception as exc:  # InvalidTag — nonce NOT advanced (spec §5.1)
            raise NoiseError("decrypt failed") from exc
        self._n += 1
        return pt


class SymmetricState:
    """Spec §5.2 — ck/h chain shared by both handshake roles."""

    __slots__ = ("ck", "h", "cipher")

    def __init__(self, protocol_name: bytes = PROTOCOL_NAME):
        if len(protocol_name) <= 32:
            self.h = protocol_name.ljust(32, b"\x00")
        else:
            self.h = hashlib.sha256(protocol_name).digest()
        self.ck = self.h
        self.cipher = CipherState(None)

    def mix_key(self, ikm: bytes) -> None:
        self.ck, temp_k = _hkdf(self.ck, ikm, 2)
        self.cipher.initialize_key(temp_k)

    def mix_hash(self, data: bytes) -> None:
        self.h = hashlib.sha256(self.h + data).digest()

    def encrypt_and_hash(self, plaintext: bytes) -> bytes:
        ct = self.cipher.encrypt_with_ad(self.h, plaintext)
        self.mix_hash(ct)
        return ct

    def decrypt_and_hash(self, ciphertext: bytes) -> bytes:
        pt = self.cipher.decrypt_with_ad(self.h, ciphertext)
        self.mix_hash(ciphertext)
        return pt

    def split(self) -> tuple[CipherState, CipherState]:
        k1, k2 = _hkdf(self.ck, b"", 2)
        return CipherState(k1), CipherState(k2)


class HandshakeState:
    """Spec §5.3 restricted to the XX pattern (§7.5):

        XX:
          -> e
          <- e, ee, s, es
          -> s, se

    Construct with ``initiator=True/False`` and a static X25519 key;
    drive with alternating write_message()/read_message() calls.  After
    the third message both sides expose ``split()`` and
    ``handshake_hash`` (channel binding, spec §11.2) and
    ``remote_static`` (the peer's Noise static public key).
    """

    _XX = (("e",), ("e", "ee", "s", "es"), ("s", "se"))

    def __init__(
        self,
        initiator: bool,
        s: X25519PrivateKey,
        prologue: bytes = b"",
        e: X25519PrivateKey | None = None,
        protocol_name: bytes = PROTOCOL_NAME,
    ):
        require_crypto()
        self.initiator = initiator
        self.ss = SymmetricState(protocol_name)
        self.ss.mix_hash(prologue)
        self.s = s
        self.e = e  # injectable for vector replay; generated lazily
        self.rs: bytes | None = None
        self.re: bytes | None = None
        self._msg_idx = 0
        self._finished = False

    # --- token helpers ---

    def _mix_dh(self, token: str) -> None:
        # es = DH(initiator e, responder s); se = DH(initiator s, responder e)
        if token == "ee":
            self.ss.mix_key(_dh(self.e, self.re))
        elif token == "es":
            key = _dh(self.e, self.rs) if self.initiator else _dh(self.s, self.re)
            self.ss.mix_key(key)
        elif token == "se":
            key = _dh(self.s, self.re) if self.initiator else _dh(self.e, self.rs)
            self.ss.mix_key(key)
        else:  # pragma: no cover
            raise NoiseError(f"unknown DH token {token}")

    def _my_turn_to_write(self) -> bool:
        return (self._msg_idx % 2 == 0) == self.initiator

    # --- message processing (spec §5.3 WriteMessage/ReadMessage) ---

    def write_message(self, payload: bytes = b"") -> bytes:
        if self._finished or not self._my_turn_to_write():
            raise NoiseError("out-of-order write_message")
        out = bytearray()
        for token in self._XX[self._msg_idx]:
            if token == "e":
                if self.e is None:
                    self.e = X25519PrivateKey.generate()
                e_pub = _pub_raw(self.e)
                out += e_pub
                self.ss.mix_hash(e_pub)
            elif token == "s":
                out += self.ss.encrypt_and_hash(_pub_raw(self.s))
            else:
                self._mix_dh(token)
        out += self.ss.encrypt_and_hash(payload)
        self._advance()
        return bytes(out)

    def read_message(self, message: bytes) -> bytes:
        if self._finished or self._my_turn_to_write():
            raise NoiseError("out-of-order read_message")
        buf = memoryview(message)
        for token in self._XX[self._msg_idx]:
            if token == "e":
                if len(buf) < DHLEN:
                    raise NoiseError("truncated handshake message")
                self.re = bytes(buf[:DHLEN])
                buf = buf[DHLEN:]
                self.ss.mix_hash(self.re)
            elif token == "s":
                n = DHLEN + (TAGLEN if self.ss.cipher.has_key() else 0)
                if len(buf) < n:
                    raise NoiseError("truncated handshake message")
                self.rs = self.ss.decrypt_and_hash(bytes(buf[:n]))
                buf = buf[n:]
            else:
                self._mix_dh(token)
        payload = self.ss.decrypt_and_hash(bytes(buf))
        self._advance()
        return payload

    def _advance(self) -> None:
        self._msg_idx += 1
        if self._msg_idx == len(self._XX):
            self._finished = True

    # --- post-handshake ---

    @property
    def local_static_pub(self) -> bytes:
        return _pub_raw(self.s)

    @property
    def finished(self) -> bool:
        return self._finished

    @property
    def handshake_hash(self) -> bytes:
        if not self._finished:
            raise NoiseError("handshake not finished")
        return self.ss.h

    def split(self) -> tuple[CipherState, CipherState]:
        """Returns (initiator→responder, responder→initiator) ciphers
        regardless of this side's role (spec §5.3: Split() ordering is
        fixed; callers pick send/recv by role)."""
        if not self._finished:
            raise NoiseError("handshake not finished")
        return self.ss.split()


# --- libp2p-noise style identity payload -----------------------------------


def identity_payload(identity, noise_static_pub: bytes) -> bytes:
    """``identity_pub(32) || sig(64)`` where sig covers the libp2p
    static-key-binding context string plus this session's Noise static
    key (public libp2p noise spec)."""
    sig = identity.sign(IDENTITY_CONTEXT + noise_static_pub)
    return identity.to_remote_identity().to_bytes() + sig


def verify_identity_payload(payload: bytes, noise_static_pub: bytes):
    """Returns the authenticated RemoteIdentity or raises NoiseError."""
    from .identity import RemoteIdentity

    if len(payload) != 96:
        raise NoiseError("malformed identity payload")
    ident = RemoteIdentity(payload[:32])
    if not ident.verify(payload[32:], IDENTITY_CONTEXT + noise_static_pub):
        raise NoiseError("identity signature invalid")
    return ident
