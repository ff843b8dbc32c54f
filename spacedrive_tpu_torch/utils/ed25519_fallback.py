"""Pure-Python ed25519 (RFC 8032) — the no-`cryptography` fallback.

Containers without the `cryptography` wheel must still boot a node:
the node config serializes an ed25519 identity keypair at first start,
so a missing AEAD stack would otherwise take the whole API layer down
with it. This module implements exactly the RFC 8032 Ed25519 operations
`p2p.identity` needs (keygen, public-key derivation, sign, verify) with
the same class surface as `cryptography`'s Ed25519PrivateKey/PublicKey.

Counterpart of `spacedrive_tpu/utils/ed25519_fallback.py`.

NOT constant-time and orders of magnitude slower than the C
implementation — correctness parity only. The real `cryptography`
package is preferred whenever importable (p2p/identity.py gates on
it).
"""

from __future__ import annotations

import hashlib
import secrets

_P = 2**255 - 19
_Q = 2**252 + 27742317777372353535851937790883648493
_D = (-121665 * pow(121666, _P - 2, _P)) % _P
_I = pow(2, (_P - 1) // 4, _P)  # sqrt(-1)


def _sha512(*parts: bytes) -> bytes:
    h = hashlib.sha512()
    for part in parts:
        h.update(part)
    return h.digest()


def _inv(x: int) -> int:
    return pow(x, _P - 2, _P)


def _edwards_add(pt1, pt2):
    # extended homogeneous coordinates (X, Y, Z, T), RFC 8032 §5.1.4
    x1, y1, z1, t1 = pt1
    x2, y2, z2, t2 = pt2
    a = (y1 - x1) * (y2 - x2) % _P
    b = (y1 + x1) * (y2 + x2) % _P
    c = 2 * t1 * t2 * _D % _P
    dd = 2 * z1 * z2 % _P
    e, f, g, h = b - a, dd - c, dd + c, b + a
    return (e * f % _P, g * h % _P, f * g % _P, e * h % _P)


def _scalar_mult(pt, n: int):
    acc = (0, 1, 1, 0)  # neutral
    while n > 0:
        if n & 1:
            acc = _edwards_add(acc, pt)
        pt = _edwards_add(pt, pt)
        n >>= 1
    return acc


def _recover_x(y: int, sign: int) -> int | None:
    if y >= _P:
        return None
    x2 = (y * y - 1) * _inv(_D * y * y + 1) % _P
    if x2 == 0:
        return None if sign else 0
    x = pow(x2, (_P + 3) // 8, _P)
    if (x * x - x2) % _P != 0:
        x = x * _I % _P
    if (x * x - x2) % _P != 0:
        return None
    if (x & 1) != sign:
        x = _P - x
    return x


_BASE_Y = 4 * _inv(5) % _P
_BASE_X = _recover_x(_BASE_Y, 0)
_BASE = (_BASE_X, _BASE_Y, 1, _BASE_X * _BASE_Y % _P)


def _compress(pt) -> bytes:
    x, y, z, _t = pt
    zi = _inv(z)
    x, y = x * zi % _P, y * zi % _P
    return int.to_bytes(y | ((x & 1) << 255), 32, "little")


def _decompress(raw: bytes):
    if len(raw) != 32:
        return None
    enc = int.from_bytes(raw, "little")
    y = enc & ((1 << 255) - 1)
    x = _recover_x(y, enc >> 255)
    if x is None:
        return None
    return (x, y, 1, x * y % _P)


def _clamp(h: bytes) -> int:
    a = int.from_bytes(h[:32], "little")
    return (a & ((1 << 254) - 8)) | (1 << 254)


class InvalidSignature(Exception):
    pass


class Ed25519PublicKey:
    __slots__ = ("_raw", "_point")

    def __init__(self, raw: bytes, point):
        self._raw = raw
        self._point = point

    @classmethod
    def from_public_bytes(cls, raw: bytes) -> "Ed25519PublicKey":
        pt = _decompress(bytes(raw))
        if pt is None:
            raise ValueError("invalid ed25519 public key")
        return cls(bytes(raw), pt)

    def public_bytes(self, *_a, **_k) -> bytes:
        return self._raw

    def verify(self, signature: bytes, message: bytes) -> None:
        if len(signature) != 64:
            raise InvalidSignature("bad length")
        r_pt = _decompress(signature[:32])
        s = int.from_bytes(signature[32:], "little")
        if r_pt is None or s >= _Q:
            raise InvalidSignature("malformed")
        k = int.from_bytes(
            _sha512(signature[:32], self._raw, message), "little") % _Q
        left = _scalar_mult(_BASE, s)
        right = _edwards_add(r_pt, _scalar_mult(self._point, k))
        # compare affine coordinates
        zl, zr = _inv(left[2]), _inv(right[2])
        if (left[0] * zl - right[0] * zr) % _P != 0 or \
                (left[1] * zl - right[1] * zr) % _P != 0:
            raise InvalidSignature("verification failed")


class Ed25519PrivateKey:
    __slots__ = ("_seed", "_scalar", "_prefix", "_pub")

    def __init__(self, seed: bytes):
        if len(seed) != 32:
            raise ValueError("seed must be 32 bytes")
        self._seed = bytes(seed)
        h = _sha512(self._seed)
        self._scalar = _clamp(h)
        self._prefix = h[32:]
        pub_pt = _scalar_mult(_BASE, self._scalar)
        self._pub = Ed25519PublicKey(_compress(pub_pt), pub_pt)

    @classmethod
    def generate(cls) -> "Ed25519PrivateKey":
        return cls(secrets.token_bytes(32))

    @classmethod
    def from_private_bytes(cls, seed: bytes) -> "Ed25519PrivateKey":
        return cls(bytes(seed))

    def private_bytes(self, *_a, **_k) -> bytes:
        return self._seed

    def public_key(self) -> Ed25519PublicKey:
        return self._pub

    def sign(self, message: bytes) -> bytes:
        r = int.from_bytes(_sha512(self._prefix, message), "little") % _Q
        r_enc = _compress(_scalar_mult(_BASE, r))
        k = int.from_bytes(
            _sha512(r_enc, self._pub.public_bytes(), message), "little") % _Q
        s = (r + k * self._scalar) % _Q
        return r_enc + int.to_bytes(s, 32, "little")
