"""Streaming BLAKE3 on the host through a small C library.

The validator's host leg hashes whole files of any size in 1 MiB
blocks; pure Python (`blake3_ref.StreamingBlake3`, the reference the
tests hold this against) runs at about half a megabyte a second, so the
leg streams through `csrc/blake3_stream.c` instead, an owned copy of the
streaming part of the JAX package's native hasher; `blake3_digest` is
its one-shot form (crypto/hashing.py's Balloon hashing).

The library is built by native/build.py (the system C compiler, the
first time a hasher is made, never at import, into
`spacedrive_tpu_torch/_build/` under a name that carries the source's
digest) and loaded with ctypes. A failed build raises
`NativeBuildError` with the compiler's output; there is no pure-Python
fallback.
"""

from __future__ import annotations

import ctypes
import os
import threading

from ..native.build import COMPILERS, NativeBuildError, built_path, compile_shared

__all__ = ["NativeBuildError", "StreamingHasher", "blake3_digest", "load"]

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "blake3_stream.c")

_lock = threading.Lock()
_lib: list[ctypes.CDLL] = []  # the loaded library, once built


def _compile(out: str) -> None:
    compile_shared(_SRC, out, compilers=COMPILERS)


def load() -> ctypes.CDLL:
    """The built library (compiled on first use)."""
    with _lock:
        if not _lib:
            so = built_path(_SRC, "blake3_stream")
            if not os.path.exists(so):
                _compile(so)
            lib = ctypes.CDLL(so)
            lib.b3_state_size.argtypes = []
            lib.b3_state_size.restype = ctypes.c_uint32
            lib.b3_init.argtypes = [ctypes.c_void_p]
            lib.b3_init.restype = None
            lib.b3_update.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64]
            lib.b3_update.restype = None
            lib.b3_finalize.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32]
            lib.b3_finalize.restype = None
            lib.b3_hash.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_void_p,
                                    ctypes.c_uint32]
            lib.b3_hash.restype = None
            _lib.append(lib)
        return _lib[0]


def blake3_digest(data: bytes, out_len: int = 32) -> bytes:
    """One-shot BLAKE3 of `data`, `out_len` (1..64) bytes."""
    if not 0 < out_len <= 64:
        raise ValueError(f"digest length must be 1..64, got {out_len}")
    lib = load()
    out = ctypes.create_string_buffer(64)
    lib.b3_hash(bytes(data), len(data), out, out_len)
    return out.raw[:out_len]


class StreamingHasher:
    """Incremental BLAKE3: bounded memory over unbounded input."""

    def __init__(self):
        self._lib = load()
        self._state = ctypes.create_string_buffer(self._lib.b3_state_size())
        self._lib.b3_init(self._state)

    def update(self, data: bytes) -> "StreamingHasher":
        data = bytes(data)
        self._lib.b3_update(self._state, data, len(data))
        return self

    def digest(self, out_len: int = 32) -> bytes:
        if not 0 < out_len <= 64:
            raise ValueError(f"digest length must be 1..64, got {out_len}")
        out = ctypes.create_string_buffer(64)
        self._lib.b3_finalize(self._state, out, out_len)
        return out.raw[:out_len]

    def hexdigest(self, out_len: int = 32) -> str:
        return self.digest(out_len).hex()
