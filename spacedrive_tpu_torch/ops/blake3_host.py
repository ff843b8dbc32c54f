"""Streaming BLAKE3 on the host through a small C library.

The validator's host leg hashes whole files of any size in 1 MiB
blocks; pure Python (`blake3_ref.StreamingBlake3`, the reference the
tests hold this against) runs at about half a megabyte a second, so the
leg streams through `csrc/blake3_stream.c` instead, an owned copy of the
streaming part of the JAX package's native hasher.

The library is compiled with the system C compiler the first time a
hasher is made (never at import), into `spacedrive_tpu_torch/_build/`
(git-ignored), under a name that carries the source's digest, and
loaded with ctypes. A failed build raises `NativeBuildError` with the
compiler's output; there is no pure-Python fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "blake3_stream.c")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
COMPILERS = ("cc", "gcc", "clang")

_lock = threading.Lock()
_lib: list[ctypes.CDLL] = []  # the loaded library, once built


class NativeBuildError(RuntimeError):
    pass


def _compile(out: str) -> None:
    """Compile the source into `out` (through a temporary name, so a
    process never loads another's half-written library)."""
    tried = []
    for cc in COMPILERS:
        if shutil.which(cc) is None:
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.run([cc, "-O3", "-fPIC", "-shared", _SRC, "-o", tmp],
                              capture_output=True, text=True, timeout=120)
        if proc.returncode == 0:
            os.replace(tmp, out)
            return
        tried.append(f"{cc} exited {proc.returncode}:\n{proc.stdout}{proc.stderr}")
    raise NativeBuildError(
        "could not build the host BLAKE3 hasher from " + _SRC + ":\n"
        + ("\n".join(tried) if tried else f"no C compiler found (tried {', '.join(COMPILERS)})")
    )


def load() -> ctypes.CDLL:
    """The built library (compiled on first use)."""
    with _lock:
        if not _lib:
            with open(_SRC, "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()[:16]
            os.makedirs(BUILD_DIR, exist_ok=True)
            so = os.path.join(BUILD_DIR, f"blake3_stream_{digest}.so")
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
            _lib.append(lib)
        return _lib[0]


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
