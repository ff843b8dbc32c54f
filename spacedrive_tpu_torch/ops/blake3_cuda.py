"""K1: the BLAKE3 chunk stage as a hand-written CUDA kernel for Hopper.

Replaces the Pallas TPU kernel `spacedrive_tpu/ops/blake3_pallas.py`
(`chunk_cvs` and the `pallas_call` in `_chunk_cvs_call`). The kernel
(`csrc/blake3_chunk.cu`, one thread per 1 KiB chunk lane, state and
message in registers) is issue-bound on 32-bit integer operations; its
design notes sit in the source.

The kernel builds with nvcc for `sm_90a` into a shared library with a
plain C interface (its source includes no PyTorch header, so the build
takes seconds), loaded with ctypes, the first time a CUDA tensor reaches
`chunk_cvs` (or `build()` is called), never at import, into
`spacedrive_tpu_torch/_build/blake3_chunk/` (git-ignored) under a name
that carries the source's digest. A tensor on the CPU takes the plain
torch version, `blake3_torch.chunk_cvs_plain`; a CUDA tensor launches
the kernel or raises — there is no fallback.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build"
)
SOURCE = os.path.join(_CSRC, "blake3_chunk.cu")
NVCC_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-shared",
              "-Xcompiler", "-fPIC")

_build_lock = threading.Lock()
_built: list = []  # the loaded library, once built


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def build(verbose: bool = False) -> ctypes.CDLL:
    """Compile (or load this process's build of) the kernel once and
    return the library. `verbose` on the first call prints the
    compiler's output, ptxas register and spill counts included. A
    failed build raises RuntimeError with nvcc's output."""
    with _build_lock:
        if not _built:
            with open(SOURCE, "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()[:16]
            build_dir = os.path.join(BUILD_DIR, "blake3_chunk")
            so = os.path.join(build_dir, f"blake3_chunk_{digest}.so")
            if not os.path.exists(so):
                os.makedirs(build_dir, exist_ok=True)
                tmp = f"{so}.{os.getpid()}.tmp"  # no process loads a half-written library
                cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas=-v"] if verbose else []),
                       "-o", tmp, SOURCE]
                proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
                if verbose:
                    print(proc.stdout + proc.stderr, flush=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc exited {proc.returncode} building {SOURCE}:\n"
                                       f"{proc.stdout}{proc.stderr}")
                os.replace(tmp, so)
            lib = ctypes.CDLL(so)
            lib.sd_blake3_chunk_cvs.argtypes = [ctypes.c_void_p] * 5 + [
                ctypes.c_int64, ctypes.c_void_p]
            lib.sd_blake3_chunk_cvs.restype = ctypes.c_int
            _built.append(lib)
        return _built[0]


def chunk_cvs(
    words: torch.Tensor,
    chunk_len: torch.Tensor,
    is_root: torch.Tensor,
    t_lo: torch.Tensor,
) -> torch.Tensor:
    """Chaining values of N independent chunk lanes.

    words int32 [N, 256]: each lane's 1 KiB chunk as little-endian words
    in natural chunk-major layout (the bytes as the host packed them);
    chunk_len int32 [N]: the lane's byte count in 0..1024; is_root int32
    [N]: non-zero for the single chunk of a one-chunk message (it takes
    the ROOT flag); t_lo int32 [N]: the chunk counter. Returns int32
    [8, N], the uint32 chaining-value words as their int32 bit patterns.
    """
    if words.device.type == "cpu":
        from .blake3_torch import chunk_cvs_plain

        return chunk_cvs_plain(words, chunk_len, is_root, t_lo)
    if words.device.type != "cuda":
        raise ValueError(f"chunk_cvs runs on cuda or cpu tensors, got {words.device}")
    for name, t in (("chunk_len", chunk_len), ("is_root", is_root), ("t_lo", t_lo)):
        if t.device != words.device or t.dtype != torch.int32 or t.shape != (words.shape[0],):
            raise ValueError(
                f"{name} must be int32 [{words.shape[0]}] on {words.device}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    if words.dtype != torch.int32 or words.dim() != 2 or words.shape[1] != 256:
        raise ValueError(f"words must be int32 [N, 256], got {words.dtype} {tuple(words.shape)}")
    if not all(t.is_contiguous() for t in (words, chunk_len, is_root, t_lo)):
        raise ValueError("chunk_cvs takes contiguous tensors")
    if words.data_ptr() % 16:
        raise ValueError("words must be 16-byte aligned")
    n = words.shape[0]
    if n == 0:
        return torch.empty((8, 0), dtype=torch.int32, device=words.device)
    lib = build()
    out = torch.empty((8, n), dtype=torch.int32, device=words.device)
    index = words.get_device()
    # the launch goes to the thread's current device: switch only when the
    # tensors lie on another (a switch costs microseconds, as much as a
    # small batch's kernel)
    with (contextlib.nullcontext() if index == torch.cuda.current_device()
          else torch.cuda.device(index)):
        err = lib.sd_blake3_chunk_cvs(
            words.data_ptr(), chunk_len.data_ptr(), is_root.data_ptr(), t_lo.data_ptr(),
            out.data_ptr(), n, torch._C._cuda_getCurrentRawStream(index))
    if err:
        raise RuntimeError(f"the K1 launch failed: CUDA error {err}")
    chunk_cvs.launches += 1
    return out


#: kernel launches since the last reset (launches on the main path are
#: what chip_smoke.py reads; set it to 0 to start a count)
chunk_cvs.launches = 0
