"""Full float32 products on the card, whatever the caller set.

cuBLAS and cuDNN run float32 matmuls and convolutions in TF32 (10-bit
mantissas, ~1e-3 relative) when `torch.backends.cuda.matmul.allow_tf32`
or `torch.backends.cudnn.allow_tf32` is on, which
`torch.set_float32_matmul_precision("high")` also turns on. The port's
float32 paths are held to the JAX package at full float32 (the resize
within one uint8 level, embeddings and ONNX outputs within 1e-5), so
they run their products inside `strict_fp32`.

Torch keeps the TF32 choice three ways: the legacy `allow_tf32` flags,
the process-wide `float32_matmul_precision`, and (torch >= 2.9) a
per-backend, per-op `fp32_precision` string. The legacy setters rewrite
the first two and the CUDA strings, so a section that turned TF32 off
and restored only the legacy flags left a "medium" caller with strings
that no longer agree with its precision, a state torch refuses to
report ("mix of the legacy and new APIs"). `strict_fp32` saves all
three and restores them in the caller's terms.
"""

from __future__ import annotations

import contextlib
import threading

import torch

_FP32_LOCK = threading.Lock()

# the `fp32_precision` attributes under torch.backends, parents first:
# setting a parent rewrites children that read "none", so children are
# restored after their parent
_PRECISION_PATHS = ("", "cuda.matmul", "cudnn", "cudnn.conv", "cudnn.rnn",
                    "mkldnn", "mkldnn.matmul", "mkldnn.conv", "mkldnn.rnn")


def _read(fn):
    """`fn()`, or None where torch refuses to answer (a mixed state)."""
    try:
        return fn()
    except (RuntimeError, AttributeError):
        return None


def _handle(path: str):
    obj = torch.backends
    for part in filter(None, path.split(".")):
        obj = _read(lambda o=obj, p=part: getattr(o, p))
        if obj is None:
            return None
    return obj


def precision_state() -> dict:
    """Every TF32 setting torch keeps, None where torch cannot read it:
    `matmul_precision`, the legacy flags and each `fp32_precision`."""
    state = {
        "matmul_precision": _read(torch.get_float32_matmul_precision),
        "matmul_allow_tf32": _read(lambda: torch.backends.cuda.matmul.allow_tf32),
        "cudnn_allow_tf32": _read(lambda: torch.backends.cudnn.allow_tf32),
    }
    for path in _PRECISION_PATHS:
        h = _handle(path)
        state[f"fp32_precision:{path}"] = None if h is None else _read(lambda h=h: h.fp32_precision)
    return state


def _restore(state: dict) -> None:
    if state["matmul_precision"] is not None:
        torch.set_float32_matmul_precision(state["matmul_precision"])
    elif state["matmul_allow_tf32"] is not None:
        torch.backends.cuda.matmul.allow_tf32 = state["matmul_allow_tf32"]
    if state["cudnn_allow_tf32"] is not None:
        torch.backends.cudnn.allow_tf32 = state["cudnn_allow_tf32"]
    for path in _PRECISION_PATHS:
        value = state[f"fp32_precision:{path}"]
        if value is not None:
            _handle(path).fp32_precision = value


@contextlib.contextmanager
def strict_fp32(device: str | torch.device):
    """Full-precision float32 products on `device`: on CUDA, TF32 off for
    cuBLAS and cuDNN for the duration, and every TF32 setting of the
    caller restored after (`precision_state`). The settings are
    process-wide, so the section holds a lock."""
    if torch.device(device).type != "cuda":
        yield
        return
    with _FP32_LOCK:
        saved = precision_state()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            yield
        finally:
            _restore(saved)
