"""Builds a CUDA source of the port's `csrc/` with nvcc for `sm_90a`.

Each source includes no PyTorch header, so nvcc builds it alone, in
seconds, into a shared library with a plain C interface that its
wrapper loads with ctypes (`blake3_cuda.py`, `hamming_cuda.py`). The
library goes to `spacedrive_tpu_torch/_build/<name>/` (git-ignored)
under a name that carries the source's digest, so an edited source
builds anew and an unchanged one is loaded as it is.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build"
)
NVCC_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-shared",
              "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def shared_library(source: str, name: str, verbose: bool = False) -> str:
    """The path of `source`'s library, compiled first if this digest of
    it has no library yet. `verbose` prints the compiler's output,
    ptxas register and spill counts included, when it compiles. A
    failed build raises RuntimeError with nvcc's output."""
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    build_dir = os.path.join(BUILD_DIR, name)
    so = os.path.join(build_dir, f"{name}_{digest}.so")
    if not os.path.exists(so):
        os.makedirs(build_dir, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"  # no process loads a half-written library
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas=-v"] if verbose else []), "-o", tmp, source]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if verbose:
            print(proc.stdout + proc.stderr, flush=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc exited {proc.returncode} building {source}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
    return so
