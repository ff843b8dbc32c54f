"""How the port's host C libraries are built: with the system C compiler,
at first use (never at import), into `spacedrive_tpu_torch/_build/`
(git-ignored), under a name that carries the source's digest. A failed
build raises `NativeBuildError` with each compiler's output; no caller
falls back silently. Users: the validator's host hasher
(ops/blake3_host.py) and the video frontend (native/video.py)."""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess

BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
COMPILERS = ("cc", "gcc", "clang")


class NativeBuildError(RuntimeError):
    pass


def compile_shared(src: str, out: str, libs: tuple[str, ...] = (),
                   compilers: tuple[str, ...] = COMPILERS) -> None:
    """Compile the C source `src` into the shared library `out`, linked
    with `libs` (through a temporary name, so a process never loads
    another's half-written library). Raises NativeBuildError with each
    compiler's output when none builds it."""
    tried = []
    for cc in compilers:
        if shutil.which(cc) is None:
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.run([cc, "-O3", "-fPIC", "-shared", src, "-o", tmp, *libs],
                              capture_output=True, text=True, timeout=120)
        if proc.returncode == 0:
            os.replace(tmp, out)
            return
        tried.append(f"{cc} exited {proc.returncode}:\n{proc.stdout}{proc.stderr}")
    raise NativeBuildError(
        f"could not build {src}:\n"
        + ("\n".join(tried) if tried else f"no C compiler found (tried {', '.join(compilers)})")
    )


def built_path(src: str, stem: str) -> str:
    """Where `src` builds to: `_build/<stem>_<source digest>.so`."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    return os.path.join(BUILD_DIR, f"{stem}_{digest}.so")
