"""K1: the BLAKE3 chunk stage as a hand-written CUDA kernel for Hopper.

Replaces the Pallas TPU kernel `spacedrive_tpu/ops/blake3_pallas.py`
(`chunk_cvs` and the `pallas_call` in `_chunk_cvs_call`). The kernel
(`csrc/blake3_chunk.cu`, one thread per 1 KiB chunk lane, state and
message in registers) is issue-bound on 32-bit integer operations; its
design notes sit in the source.

The extension builds with nvcc for `sm_90a` through
`torch.utils.cpp_extension.load` the first time a CUDA tensor reaches
`chunk_cvs` (or `build()` is called), never at import, into
`spacedrive_tpu_torch/_build/` (git-ignored). A tensor on the CPU takes
the plain torch version, `blake3_torch.chunk_cvs_plain`; a CUDA tensor
launches the kernel or raises — there is no fallback.
"""

from __future__ import annotations

import os
import threading

import torch

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build"
)
SOURCES = (
    os.path.join(_CSRC, "blake3_binding.cpp"),
    os.path.join(_CSRC, "blake3_chunk.cu"),
)
CUDA_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a")

_build_lock = threading.Lock()
_built: list = []  # the loaded extension module, once built


def build(verbose: bool = False):
    """Compile (or load the cached build of) the extension once per
    process and return it. `verbose` on the first call prints the
    compiler's output, ptxas register and spill counts included."""
    with _build_lock:
        if not _built:
            from torch.utils.cpp_extension import load

            build_dir = os.path.join(BUILD_DIR, "blake3_chunk")
            os.makedirs(build_dir, exist_ok=True)  # load() does not create it
            _built.append(load(
                name="sd_blake3_chunk",
                sources=list(SOURCES),
                build_directory=build_dir,
                extra_cflags=["-O3"],
                extra_cuda_cflags=list(CUDA_FLAGS) + (["-Xptxas=-v"] if verbose else []),
                verbose=verbose,
            ))
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
    if words.shape[0] == 0:
        return torch.empty((8, 0), dtype=torch.int32, device=words.device)
    out = build().chunk_cvs(words, chunk_len, is_root, t_lo)
    chunk_cvs.launches += 1
    return out


#: kernel launches since the last reset (launches on the main path are
#: what chip_smoke.py reads; set it to 0 to start a count)
chunk_cvs.launches = 0
