"""H1: a row block of the near-pairs search as a hand-written CUDA kernel
for Hopper.

Replaces no Pallas kernel (the JAX package leaves its `near_pairs` to
XLA). The kernel (`csrc/hamming_pairs.cu`) finds every pair (i, j),
i < j, of a row block within a Hamming threshold by XOR-popcount over
the upper triangle, and appends only those pairs to a compact buffer;
its design notes, its POPC bound and its capacity scheme sit in the
source.

It builds like K1 (`nvcc_build.py`), the first time a CUDA tensor
reaches `near_pairs_block` (or `build()` is called), never at import.
The plain torch version is `phash_torch.plain_block`, which
`phash_torch.near_pairs` takes for a tensor off the card; a CUDA tensor
launches the kernel or raises — there is no fallback.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import threading

import torch

from .nvcc_build import CSRC, shared_library

SOURCE = os.path.join(CSRC, "hamming_pairs.cu")
#: row and column tile of the kernel: `off` and `rows` are multiples of
#: it, and the table holds whole tiles
TILE = 1024
#: the packed pair keeps i and j in 32 bits each, i below the sign bit
MAX_HASHES = 2**31

_build_lock = threading.Lock()
_built: list = []  # the loaded library, once built


def build(verbose: bool = False) -> ctypes.CDLL:
    """Compile (or load this process's build of) the kernel once and
    return the library; `verbose` as `blake3_cuda.build`."""
    with _build_lock:
        if not _built:
            lib = ctypes.CDLL(shared_library(SOURCE, "hamming_pairs", verbose))
            lib.sd_hamming_pairs.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
            lib.sd_hamming_pairs.restype = ctypes.c_int
            _built.append(lib)
        return _built[0]


def near_pairs_block(table: torch.Tensor, n: int, off: int, rows: int, threshold: int,
                     capacity: int) -> torch.Tensor:
    """The pairs (i, j) with off <= i < off + rows, i < j < n and
    Hamming distance at most `threshold`, on the card.

    table int64 [P] on a CUDA device: the n hashes' 8 bytes each as
    stored (the distance does not depend on the byte order), padded to
    whole tiles (P a multiple of TILE, P >= off + rows). Returns int64
    [1 + capacity] on that device: word 0 the number of pairs found,
    past the capacity too, then the first min(count, capacity) pairs
    packed as (i << 32) | j, in no set order; the words after them are
    not written. Queued on the current stream; nothing waits for it.
    """
    if table.device.type != "cuda":
        raise ValueError(f"near_pairs_block runs on cuda tensors, got {table.device}")
    if table.dtype != torch.int64 or table.dim() != 1 or not table.is_contiguous():
        raise ValueError(f"table must be contiguous int64 [P], got {table.dtype} "
                         f"{tuple(table.shape)}")
    p = table.shape[0]
    if p % TILE or table.data_ptr() % 16:
        raise ValueError(f"table must hold whole tiles of {TILE}, 16-byte aligned; got {p}")
    if not (0 <= off < n <= p < MAX_HASHES) or off % TILE or rows <= 0 or rows % TILE \
            or off + rows > p:
        raise ValueError(f"rows [{off}, {off} + {rows}) of n={n} do not fit a table of {p} "
                         f"in tiles of {TILE}")
    if not 0 <= threshold <= 64 or capacity < 0:
        raise ValueError(f"threshold {threshold} outside 0..64 or capacity {capacity} < 0")
    lib = build()
    buf = torch.empty(1 + capacity, dtype=torch.int64, device=table.device)
    index = table.get_device()
    with (contextlib.nullcontext() if index == torch.cuda.current_device()
          else torch.cuda.device(index)):
        err = lib.sd_hamming_pairs(table.data_ptr(), n, off, rows, threshold, buf.data_ptr(),
                                   capacity, torch._C._cuda_getCurrentRawStream(index))
    if err:
        raise RuntimeError(f"the H1 launch failed: CUDA error {err}")
    near_pairs_block.launches += 1
    return buf


#: kernel launches since the last reset (set it to 0 to start a count)
near_pairs_block.launches = 0
