"""Full float32 products on the card, whatever the caller set.

cuBLAS and cuDNN run float32 matmuls and convolutions in TF32 (10-bit
mantissas, ~1e-3 relative) when `torch.backends.cuda.matmul.allow_tf32`
or `torch.backends.cudnn.allow_tf32` is on, which
`torch.set_float32_matmul_precision("high")` also turns on. The port's
float32 paths are held to the JAX package at full float32 (the resize
within one uint8 level, embeddings and ONNX outputs within 1e-5), so
they run their products inside `strict_fp32`.
"""

from __future__ import annotations

import contextlib
import threading

import torch

_FP32_LOCK = threading.Lock()


@contextlib.contextmanager
def strict_fp32(device: str | torch.device):
    """Full-precision float32 products on `device`: on CUDA, TF32 off for
    cuBLAS and cuDNN for the duration, the caller's flags restored after.
    The flags are process-wide, so the section holds a lock."""
    if torch.device(device).type != "cuda":
        yield
        return
    with _FP32_LOCK:
        matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = matmul
            torch.backends.cudnn.allow_tf32 = cudnn
