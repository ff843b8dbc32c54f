"""Password hashing / key derivation.

Parity: ref:crates/crypto/src/types.rs:52-53 — `HashingAlgorithm::
{Argon2id(Params), BalloonBlake3(Params)}` with `Params::{Standard,
Hardened, Paranoid}` cost profiles. Argon2id rides `cryptography`'s
OpenSSL binding; Balloon hashing (Boneh–Corrigan-Gibbs–Schechter) is
implemented over the host C BLAKE3 (ops/blake3_host.py) — the same pairing
the reference gets from the `balloon-hash` + `blake3` crates. Output
is always a 32-byte key from (password, 16-byte salt).

Counterpart of `spacedrive_tpu/crypto/hashing.py`: the same keys from
the same (password, salt, profile).
"""

from __future__ import annotations

import enum
import secrets
import struct

try:
    from cryptography.hazmat.primitives.kdf.argon2 import Argon2id
except ImportError:  # gated: Argon2id derivation refuses at use below
    Argon2id = None  # type: ignore

from ..ops.blake3_host import NativeBuildError, blake3_digest
from .stream import KEY_LEN, CryptoError

SALT_LEN = 16  # ref:types.rs SALT_LEN


class Params(enum.IntEnum):
    """Cost profiles (ref:keys/hashing.rs params tables)."""

    STANDARD = 0
    HARDENED = 1
    PARANOID = 2


# Argon2id (memory KiB, iterations, lanes) per profile — the reference's
# keys/hashing.rs ladder (standard ≈ interactive, paranoid ≈ sensitive)
_ARGON2 = {
    Params.STANDARD: (131_072, 8, 4),
    Params.HARDENED: (262_144, 8, 4),
    Params.PARANOID: (524_288, 8, 4),
}

# Balloon (space cost in 64-byte blocks, time cost) per profile
_BALLOON = {
    Params.STANDARD: (131_072, 2),
    Params.HARDENED: (262_144, 2),
    Params.PARANOID: (524_288, 2),
}

_DELTA = 3  # balloon dependency count (standard choice)


class HashingAlgorithm:
    """ref:types.rs `HashingAlgorithm` — (kind, params) pair."""

    ARGON2ID = "Argon2id"
    BALLOON_BLAKE3 = "BalloonBlake3"

    def __init__(self, kind: str, params: Params = Params.STANDARD):
        if kind not in (self.ARGON2ID, self.BALLOON_BLAKE3):
            raise CryptoError(f"unknown hashing algorithm {kind}")
        self.kind = kind
        self.params = Params(params)

    def to_wire(self) -> list:
        return [self.kind, int(self.params)]

    @classmethod
    def from_wire(cls, obj: list) -> "HashingAlgorithm":
        return cls(obj[0], Params(obj[1]))

    def hash_password(
        self, password: bytes, salt: bytes, *, _test_overrides: tuple | None = None
    ) -> bytes:
        if len(salt) != SALT_LEN:
            raise CryptoError(f"salt must be {SALT_LEN} bytes")
        if self.kind == self.ARGON2ID:
            if Argon2id is None:
                raise CryptoError(
                    "the `cryptography` package is required for Argon2id")
            memory, iterations, lanes = _test_overrides or _ARGON2[self.params]
            return Argon2id(
                salt=salt,
                length=KEY_LEN,
                iterations=iterations,
                lanes=lanes,
                memory_cost=memory,
            ).derive(password)
        space, time = _test_overrides or _BALLOON[self.params]
        return balloon_blake3(password, salt, space_cost=space, time_cost=time)


def generate_salt() -> bytes:
    return secrets.token_bytes(SALT_LEN)


def _blake3(data: bytes) -> bytes:
    try:
        return blake3_digest(data)
    except (NativeBuildError, OSError) as e:  # no C compiler, or a broken build
        raise CryptoError("native blake3 unavailable") from e


def balloon_blake3(
    password: bytes, salt: bytes, *, space_cost: int, time_cost: int
) -> bytes:
    """Balloon hashing (BCGS16) with BLAKE3 as H; sequential-memory-hard.

    Layout follows the paper's single-buffer variant: expand, then
    `time_cost` rounds of mixing each block with its predecessor and
    `_DELTA` pseudo-random other blocks derived from (counter, salt).
    """
    if space_cost < 1 or time_cost < 1:
        raise CryptoError("balloon params must be >= 1")
    cnt = 0

    def h(*parts: bytes) -> bytes:
        nonlocal cnt
        out = _blake3(struct.pack("<Q", cnt) + b"".join(parts))
        cnt += 1
        return out

    buf = [h(password, salt)]
    for m in range(1, space_cost):
        buf.append(h(buf[m - 1]))
    for t in range(time_cost):
        for m in range(space_cost):
            buf[m] = h(buf[(m - 1) % space_cost], buf[m])
            for i in range(_DELTA):
                idx_block = h(
                    struct.pack("<QQQ", t, m, i), salt
                )
                other = int.from_bytes(idx_block[:8], "little") % space_cost
                buf[m] = h(buf[m], buf[other])
    return buf[-1]
