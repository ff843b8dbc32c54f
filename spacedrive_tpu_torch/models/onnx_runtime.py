"""Execute ONNX graphs with torch: the labeler's ONNX Runtime stand-in.

Counterpart of `spacedrive_tpu/models/onnx_runtime.py`, over the same
64 ops. The reference hands its YOLOv8 `.onnx` to the `ort` runtime
(ref:crates/ai/src/lib.rs:22-77); here `OnnxModel(model, device)` runs
the graph node by node as eager torch ops on its device.

Placement follows the JAX runtime. The ops in `_DEVICE_ONLY` always run
on the model's device. Every other op runs in numpy when all its inputs
are host values, so shape subgraphs (Shape → Gather → Concat → Reshape)
stay concrete on the host; otherwise its host inputs move to the device
(float64 as float32, as JAX keeps them without x64) and it runs there.
Each op is written once against a numpy-like namespace: numpy itself or
`_TorchNS`.

Float32 products (MatMul, Gemm, Conv, ConvTranspose, the Resize
contractions) run at full float32 precision like the JAX runtime's
`Precision.HIGHEST`: on a CUDA device each call turns TF32 off for
cuBLAS and cuDNN and restores the caller's setting after, whatever the
process globals say. Resize and Upsample build `jax.image.resize`'s
weights (half-pixel nearest; triangle and Keys cubic a = −0.5 kernels,
antialiased when downscaling) rather than calling `F.interpolate`.
Unsupported ops raise with their names when the graph loads; attributes
an op does not model raise when it runs.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.precision import strict_fp32
from . import onnx_proto as proto


def _np_static(x: Any, what: str) -> np.ndarray:
    """A value that must be concrete (shape or index operands) as numpy;
    a device tensor is copied to the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    try:
        return np.asarray(x)
    except Exception as exc:
        raise ValueError(f"ONNX graph uses a non-static {what}") from exc


class _Env(dict):
    def fetch(self, names: list[str]) -> list[Any]:
        return [None if n == "" else self[n] for n in names]


def _is_host(v: Any) -> bool:
    return v is None or isinstance(v, (np.ndarray, np.generic, int, float, bool))


# Ops that call into torch's own kernels (convolution, pooling, products,
# resize, softmax, erf) and so always run on the model's device; the
# JAX runtime's list (`spacedrive_tpu/models/onnx_runtime.py:57-62`).
_DEVICE_ONLY = frozenset({
    "Conv", "ConvTranspose", "MaxPool", "AveragePool", "GlobalAveragePool",
    "GlobalMaxPool", "Resize", "Upsample", "Softmax", "Erf", "MatMul",
    "Gemm",
})

_TORCH_DTYPES = {
    np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64,
    np.dtype(np.float16): torch.float16, np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int8): torch.int8, np.dtype(np.int16): torch.int16,
    np.dtype(np.uint16): torch.uint16, np.dtype(np.int32): torch.int32,
    np.dtype(np.uint32): torch.uint32, np.dtype(np.int64): torch.int64,
    np.dtype(np.uint64): torch.uint64, np.dtype(np.bool_): torch.bool,
}

class _TorchNS:
    """The numpy functions the ops call, on torch tensors."""

    sqrt, exp, log, abs, tanh = torch.sqrt, torch.exp, torch.log, torch.abs, torch.tanh
    floor, ceil, where, clip = torch.floor, torch.ceil, torch.where, torch.clip
    reshape, broadcast_to, tile = torch.reshape, torch.broadcast_to, torch.tile

    @staticmethod
    def maximum(a, b):
        return torch.clamp(a, min=b) if not isinstance(b, torch.Tensor) else torch.maximum(a, b)

    @staticmethod
    def minimum(a, b):
        return torch.clamp(a, max=b) if not isinstance(b, torch.Tensor) else torch.minimum(a, b)

    @staticmethod
    def concatenate(xs, axis):
        return torch.cat(xs, dim=axis)

    @staticmethod
    def transpose(x, perm):
        return x.permute(*perm)

    @staticmethod
    def expand_dims(x, axis):
        return torch.unsqueeze(x, axis)

    @staticmethod
    def squeeze(x, axis=None):
        return torch.squeeze(x) if axis is None else torch.squeeze(x, dim=axis)

    @staticmethod
    def take(x, idx, axis):
        idx = torch.as_tensor(idx, device=x.device).long()
        flat = torch.remainder(idx.reshape(-1), x.shape[axis])  # negative indices wrap
        out = torch.index_select(x, axis, flat)
        return out.reshape(*x.shape[:axis], *idx.shape, *x.shape[axis + 1:])

    @staticmethod
    def split(x, bounds, axis):
        return torch.tensor_split(x, bounds, dim=axis)

    @staticmethod
    def astype(x, dtype):
        return x.to(_TORCH_DTYPES[np.dtype(dtype)])

    @staticmethod
    def index(x, idx):
        """x[idx] for a tuple of slices; torch slices take no negative
        step, so such an axis gathers its indices."""
        for ax, s in enumerate(idx):
            if s.step is not None and s.step < 0:
                rows = list(range(*s.indices(x.shape[ax])))
                x = torch.index_select(x, ax, torch.tensor(rows, dtype=torch.long,
                                                           device=x.device))
                idx = idx[:ax] + (slice(None),) + idx[ax + 1:]
        return x[idx]

    @staticmethod
    def pad(x, pairs, mode="constant", constant_values=0.0):
        if mode == "constant":
            flat = [p for pair in reversed(pairs) for p in pair]
            return F.pad(x, flat, value=constant_values)
        for ax, (lo, hi) in enumerate(pairs):
            if lo or hi:  # numpy's own index rule for the mode
                rows = np.pad(np.arange(x.shape[ax]), (lo, hi), mode=mode)
                x = torch.index_select(x, ax, torch.from_numpy(rows).to(x.device))
        return x

    @staticmethod
    def _axes(x, axis):
        return tuple(range(x.dim())) if axis is None else axis

    @classmethod
    def mean(cls, x, axis=None, keepdims=False):
        return torch.mean(x, dim=cls._axes(x, axis), keepdim=keepdims)

    @classmethod
    def sum(cls, x, axis=None, keepdims=False):
        return torch.sum(x, dim=cls._axes(x, axis), keepdim=keepdims)

    @classmethod
    def max(cls, x, axis=None, keepdims=False):
        return torch.amax(x, dim=cls._axes(x, axis), keepdim=keepdims)

    @classmethod
    def min(cls, x, axis=None, keepdims=False):
        return torch.amin(x, dim=cls._axes(x, axis), keepdim=keepdims)

    @classmethod
    def var(cls, x, axis=None, keepdims=False):
        return torch.var(x, dim=cls._axes(x, axis), correction=0, keepdim=keepdims)

    @staticmethod
    def argmax(x, axis):
        return torch.argmax(x, dim=axis)


def _cast(xp, x, dtype):
    return x.astype(dtype) if xp is np else xp.astype(x, dtype)


def _index(xp, x, idx):
    return x[idx] if xp is np else xp.index(x, idx)


_OPS: dict[str, Callable] = {}


def op(name: str):
    def deco(fn):
        _OPS[name] = fn
        return fn
    return deco


def _attr_value(a: dict[str, Any]) -> Any:
    t = a.get("type", 0)
    if t == 1:
        return a["f"]
    if t == 2:
        return a["i"]
    if t == 3:
        return a["s"].decode()
    if t == 4:
        return proto.tensor_to_array(a["t"])
    if t == 6:
        return list(a.get("floats", []))
    if t == 7:
        return list(a.get("ints", []))
    if t == 8:
        return [s.decode() for s in a.get("strings", [])]
    raise ValueError(f"unsupported attribute type {t} ({a.get('name')})")


def _attrs(node: dict[str, Any]) -> dict[str, Any]:
    return {a["name"]: _attr_value(a) for a in node.get("attribute", [])}


# --- elementwise / activation ---------------------------------------------

def _ew(fn):
    return lambda xp, attrs, *xs: fn(xp, *xs)


op("Add")(_ew(lambda xp, a, b: a + b))
op("Sub")(_ew(lambda xp, a, b: a - b))
op("Mul")(_ew(lambda xp, a, b: a * b))
op("Div")(_ew(lambda xp, a, b: a / b))
op("Pow")(_ew(lambda xp, a, b: a ** b))
op("Sqrt")(_ew(lambda xp, a: xp.sqrt(a)))
op("Exp")(_ew(lambda xp, a: xp.exp(a)))
op("Log")(_ew(lambda xp, a: xp.log(a)))
op("Neg")(_ew(lambda xp, a: -a))
op("Abs")(_ew(lambda xp, a: xp.abs(a)))
op("Relu")(_ew(lambda xp, a: xp.maximum(a, 0)))
op("Sigmoid")(_ew(lambda xp, a: 1.0 / (1.0 + xp.exp(-a))))
op("Tanh")(_ew(lambda xp, a: xp.tanh(a)))
op("Erf")(_ew(lambda xp, a: torch.erf(a)))
op("Identity")(_ew(lambda xp, a: a))
op("Floor")(_ew(lambda xp, a: xp.floor(a)))
op("Ceil")(_ew(lambda xp, a: xp.ceil(a)))
op("Min")(_ew(lambda xp, *xs: functools.reduce(xp.minimum, xs)))
op("Max")(_ew(lambda xp, *xs: functools.reduce(xp.maximum, xs)))


@op("LeakyRelu")
def _leaky_relu(xp, attrs, x):
    alpha = attrs.get("alpha", 0.01)
    return xp.where(x >= 0, x, alpha * x)


@op("HardSigmoid")
def _hard_sigmoid(xp, attrs, x):
    alpha = attrs.get("alpha", 0.2)
    beta = attrs.get("beta", 0.5)
    return xp.clip(alpha * x + beta, 0.0, 1.0)


@op("HardSwish")
def _hard_swish(xp, attrs, x):
    return x * xp.clip(x / 6.0 + 0.5, 0.0, 1.0)


@op("Clip")
def _clip(xp, attrs, x, lo=None, hi=None):
    lo = attrs.get("min", lo)
    hi = attrs.get("max", hi)
    if lo is not None:
        x = xp.maximum(x, lo)
    if hi is not None:
        x = xp.minimum(x, hi)
    return x


@op("Softmax")
def _softmax(xp, attrs, x):
    return torch.softmax(x, dim=attrs.get("axis", -1))


# --- tensor shuffling ------------------------------------------------------

@op("Concat")
def _concat(xp, attrs, *xs):
    return xp.concatenate(xs, axis=attrs["axis"])


@op("Reshape")
def _reshape(xp, attrs, x, shape=None):
    target = [int(v) for v in _np_static(shape, "Reshape target").tolist()]
    # ONNX: 0 copies the input dim (unless allowzero), -1 infers
    out = [x.shape[i] if v == 0 and not attrs.get("allowzero") else v
           for i, v in enumerate(target)]
    return xp.reshape(x, out)


@op("Flatten")
def _flatten(xp, attrs, x):
    axis = attrs.get("axis", 1)
    lead = int(np.prod(x.shape[:axis], dtype=np.int64)) if axis else 1
    return xp.reshape(x, (lead, -1))


@op("Transpose")
def _transpose(xp, attrs, x):
    perm = attrs.get("perm") or list(range(x.ndim))[::-1]
    return xp.transpose(x, perm)


@op("Unsqueeze")
def _unsqueeze(xp, attrs, x, axes=None):
    ax = attrs.get("axes")
    if ax is None:
        ax = _np_static(axes, "Unsqueeze axes").tolist()
    out = x
    for a in sorted(int(v) for v in ax):
        out = xp.expand_dims(out, a)
    return out


@op("Squeeze")
def _squeeze(xp, attrs, x, axes=None):
    ax = attrs.get("axes")
    if ax is None and axes is not None:
        ax = _np_static(axes, "Squeeze axes").tolist()
    return xp.squeeze(x, axis=tuple(int(v) for v in ax) if ax else None)


@op("Shape")
def _shape(xp, attrs, x):
    return np.asarray(tuple(x.shape), np.int64)  # always a host value


@op("Gather")
def _gather(xp, attrs, x, idx):
    axis = attrs.get("axis", 0)
    if isinstance(x, np.ndarray):
        return np.take(x, _np_static(idx, "Gather indices"), axis=axis)
    return xp.take(x, idx, axis=axis)


@op("Slice")
def _slice(xp, attrs, x, starts=None, ends=None, axes=None, steps=None):
    if starts is None:  # opset < 10: attributes
        starts = attrs["starts"]
        ends = attrs["ends"]
        axes = attrs.get("axes")
        steps = None
    starts = _np_static(starts, "Slice starts").tolist()
    ends = _np_static(ends, "Slice ends").tolist()
    axes = (_np_static(axes, "Slice axes").tolist()
            if axes is not None else list(range(len(starts))))
    steps = (_np_static(steps, "Slice steps").tolist()
             if steps is not None else [1] * len(starts))
    idx = [slice(None)] * x.ndim
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        ax = int(ax) % x.ndim
        idx[ax] = slice(int(st), int(en), int(sp))
    return _index(xp, x, tuple(idx))


@op("Split")
def _split(xp, attrs, x, split=None):
    axis = attrs.get("axis", 0)
    sizes = attrs.get("split")
    if sizes is None and split is not None:
        sizes = _np_static(split, "Split sizes").tolist()
    if sizes is None:
        n = attrs["num_outputs"]
        base = x.shape[axis] // n
        rem = x.shape[axis] - base * n
        sizes = [base + (1 if i < rem else 0) for i in range(n)]
    bounds = np.cumsum(sizes)[:-1].tolist()
    return tuple(xp.split(x, bounds, axis=axis))


@op("Cast")
def _cast_op(xp, attrs, x):
    return _cast(xp, x, proto._DTYPES[attrs["to"]])


@op("Constant")
def _constant(xp, attrs):
    if "value" in attrs:
        return attrs["value"]
    for k in ("value_float", "value_int"):
        if k in attrs:
            return np.asarray(attrs[k])
    if "value_floats" in attrs:
        return np.asarray(attrs["value_floats"], np.float32)
    if "value_ints" in attrs:
        return np.asarray(attrs["value_ints"], np.int64)
    raise ValueError("Constant node without value")


@op("ConstantOfShape")
def _constant_of_shape(xp, attrs, shape):
    dims = _np_static(shape, "ConstantOfShape dims").tolist()
    fill = attrs.get("value")
    if fill is None:
        return np.zeros(dims, np.float32)
    return np.full(dims, fill.reshape(-1)[0], fill.dtype)


@op("Range")
def _range(xp, attrs, start, limit, delta):
    return np.arange(
        _np_static(start, "Range").item(),
        _np_static(limit, "Range").item(),
        _np_static(delta, "Range").item(),
    )


@op("Expand")
def _expand(xp, attrs, x, shape):
    dims = [int(v) for v in _np_static(shape, "Expand shape").tolist()]
    # ONNX Expand broadcasts; dim of 1 in target keeps input dim
    out_shape = list(np.broadcast_shapes(tuple(x.shape), tuple(dims)))
    return xp.broadcast_to(x, out_shape)


@op("Tile")
def _tile(xp, attrs, x, reps):
    return xp.tile(x, [int(v) for v in _np_static(reps, "Tile reps").tolist()])


@op("Pad")
def _pad(xp, attrs, x, pads=None, value=None):
    mode = attrs.get("mode", "constant")
    p = attrs.get("pads")
    if p is None:
        p = _np_static(pads, "Pad pads").tolist()
    n = x.ndim
    pairs = [(int(p[i]), int(p[i + n])) for i in range(n)]
    cval = 0.0
    if value is not None:
        cval = float(_np_static(value, "Pad value").reshape(-1)[0])
    if mode == "constant":
        return xp.pad(x, pairs, constant_values=cval)
    return xp.pad(x, pairs, mode={"reflect": "reflect", "edge": "edge"}[mode])


# --- reductions ------------------------------------------------------------

def _reduce(fn_name):
    def fn(xp, attrs, x, axes_in=None):
        axes = attrs.get("axes")
        if axes is None and axes_in is not None:
            axes = _np_static(axes_in, "Reduce axes").tolist()
        axes = tuple(int(a) for a in axes) if axes else None
        keep = bool(attrs.get("keepdims", 1))
        return getattr(xp, fn_name)(x, axis=axes, keepdims=keep)
    return fn


op("ReduceMean")(_reduce("mean"))
op("ReduceSum")(_reduce("sum"))
op("ReduceMax")(_reduce("max"))
op("ReduceMin")(_reduce("min"))


@op("ArgMax")
def _argmax(xp, attrs, x):
    axis = attrs.get("axis", 0)
    out = xp.argmax(x, axis=axis)
    if attrs.get("keepdims", 1):
        out = xp.expand_dims(out, axis)
    return out


# --- linear algebra (device only, full float32: see strict_fp32) ----------

@op("MatMul")
def _matmul(xp, attrs, a, b):
    return torch.matmul(a, b)


@op("Gemm")
def _gemm(xp, attrs, a, b, c=None):
    alpha = attrs.get("alpha", 1.0)
    beta = attrs.get("beta", 1.0)
    if attrs.get("transA"):
        a = a.T
    if attrs.get("transB"):
        b = b.T
    out = alpha * torch.matmul(a, b)
    if c is not None:
        out = out + beta * c
    return out


# --- convolution / pooling (device only) ------------------------------------

def _conv_pads(attrs, x_shape, k_shape, strides, dilations):
    """Resolve ONNX pads/auto_pad to ((lo, hi), ...) per spatial dim."""
    spatial = len(k_shape)
    auto = attrs.get("auto_pad", "NOTSET")
    if auto in ("NOTSET", ""):
        p = attrs.get("pads", [0] * (2 * spatial))
        return [(int(p[i]), int(p[i + spatial])) for i in range(spatial)]
    if auto == "VALID":
        return [(0, 0)] * spatial
    pairs = []
    for i in range(spatial):
        in_dim = x_shape[2 + i]
        eff_k = (k_shape[i] - 1) * dilations[i] + 1
        out_dim = math.ceil(in_dim / strides[i])
        total = max(0, (out_dim - 1) * strides[i] + eff_k - in_dim)
        lo = total // 2
        hi = total - lo
        if auto == "SAME_UPPER":
            pairs.append((lo, hi))
        else:  # SAME_LOWER
            pairs.append((hi, lo))
    return pairs


def _pad_spatial(x, pairs, value=0.0):
    flat = [p for pair in reversed(pairs) for p in pair]
    return F.pad(x, flat, value=value) if any(flat) else x


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d, 3: F.conv_transpose3d}


@op("Conv")
def _conv(xp, attrs, x, w, b=None):
    spatial = w.ndim - 2
    strides = attrs.get("strides", [1] * spatial)
    dilations = attrs.get("dilations", [1] * spatial)
    groups = attrs.get("group", 1)
    pads = _conv_pads(attrs, x.shape, w.shape[2:], strides, dilations)
    return _CONV[spatial](_pad_spatial(x, pads), w, b, stride=strides, dilation=dilations,
                          groups=groups)


@op("ConvTranspose")
def _conv_transpose(xp, attrs, x, w, b=None):
    spatial = w.ndim - 2
    strides = attrs.get("strides", [1] * spatial)
    # Attributes this lowering does not model: refuse rather than compute
    # a silently wrong result (the JAX runtime refuses the same ones).
    if attrs.get("group", 1) != 1:
        raise NotImplementedError("ConvTranspose: group != 1")
    if any(int(d) != 1 for d in attrs.get("dilations", [1] * spatial)):
        raise NotImplementedError("ConvTranspose: dilations != 1")
    if any(int(p) != 0 for p in attrs.get("output_padding", [0] * spatial)):
        raise NotImplementedError("ConvTranspose: output_padding")
    if "output_shape" in attrs:
        raise NotImplementedError("ConvTranspose: output_shape")
    if attrs.get("auto_pad", "NOTSET") not in ("NOTSET", "VALID"):  # VALID: zero pads
        raise NotImplementedError("ConvTranspose: auto_pad SAME_*")
    pads = attrs.get("pads", [0] * (2 * spatial))
    # ONNX ConvTranspose weight is (C_in, C_out, k...), torch's layout;
    # the pads crop the full output
    out = _CONV_T[spatial](x, w, b, stride=strides)
    crop = [slice(None), slice(None)] + [
        slice(int(pads[i]), out.shape[2 + i] - int(pads[i + spatial])) for i in range(spatial)]
    return out[tuple(crop)]


def _pool(attrs, x, fill, reduce):
    """Sliding windows over the padded input (ceil_mode grows the high
    pad), each window reduced by `reduce` over its trailing dims."""
    kernel = attrs["kernel_shape"]
    spatial = len(kernel)
    strides = attrs.get("strides", [1] * spatial)
    dilations = attrs.get("dilations", [1] * spatial)
    pads = _conv_pads(attrs, x.shape, kernel, strides, dilations)
    if attrs.get("ceil_mode"):
        new_pads = []
        for i in range(spatial):
            in_dim = x.shape[2 + i] + pads[i][0] + pads[i][1]
            eff_k = (kernel[i] - 1) * dilations[i] + 1
            rem = (in_dim - eff_k) % strides[i]
            extra = (strides[i] - rem) % strides[i] if rem else 0
            new_pads.append((pads[i][0], pads[i][1] + extra))
        pads = new_pads
    win = _pad_spatial(x, pads, fill)
    for i in range(spatial):
        eff_k = (kernel[i] - 1) * dilations[i] + 1
        win = win.unfold(2 + i, eff_k, strides[i])[..., ::dilations[i]]
    return reduce(win, tuple(range(-spatial, 0))), pads, win.shape


@op("MaxPool")
def _max_pool(xp, attrs, x):
    return _pool(attrs, x, -math.inf, lambda w, dims: torch.amax(w, dim=dims))[0]


@op("AveragePool")
def _avg_pool(xp, attrs, x):
    total, pads, _ = _pool(attrs, x, 0.0, lambda w, dims: torch.sum(w, dim=dims))
    if attrs.get("count_include_pad"):
        return total / float(np.prod(attrs["kernel_shape"]))
    ones = torch.ones((1, 1, *x.shape[2:]), dtype=x.dtype, device=x.device)
    counts = _pool({**attrs, "pads": [p for p, _ in pads] + [q for _, q in pads],
                    "auto_pad": "NOTSET", "ceil_mode": 0}, ones, 0.0,
                   lambda w, dims: torch.sum(w, dim=dims))[0]
    return total / counts


@op("GlobalAveragePool")
def _global_avg_pool(xp, attrs, x):
    return torch.mean(x, dim=tuple(range(2, x.ndim)), keepdim=True)


@op("GlobalMaxPool")
def _global_max_pool(xp, attrs, x):
    return torch.amax(x, dim=tuple(range(2, x.ndim)), keepdim=True)


@op("BatchNormalization")
def _batch_norm(xp, attrs, x, scale, bias, mean, var):
    eps = attrs.get("epsilon", 1e-5)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    inv = 1.0 / xp.sqrt(var + eps)
    return (x - mean.reshape(shape)) * (scale * inv).reshape(shape) + \
        bias.reshape(shape)


@op("InstanceNormalization")
def _instance_norm(xp, attrs, x, scale, bias):
    eps = attrs.get("epsilon", 1e-5)
    axes = tuple(range(2, x.ndim))
    mean = xp.mean(x, axis=axes, keepdims=True)
    var = xp.var(x, axis=axes, keepdims=True)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    return (x - mean) / xp.sqrt(var + eps) * scale.reshape(shape) + \
        bias.reshape(shape)


@op("LayerNormalization")
def _layer_norm(xp, attrs, x, scale, bias=None):
    eps = attrs.get("epsilon", 1e-5)
    axis = attrs.get("axis", -1)
    axes = tuple(range(axis % x.ndim, x.ndim))
    mean = xp.mean(x, axis=axes, keepdims=True)
    var = xp.var(x, axis=axes, keepdims=True)
    out = (x - mean) / xp.sqrt(var + eps) * scale
    return out + bias if bias is not None else out


# --- resize (jax.image.resize's arithmetic) --------------------------------

def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(np.float32(0), np.float32(1) - np.abs(x))


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    f = np.float32
    out = ((f(1.5) * x - f(2.5)) * x) * x + f(1.0)
    out = np.where(x >= f(1.0), ((f(-0.5) * x + f(2.5)) * x - f(4.0)) * x + f(2.0), out)
    return np.where(x >= f(2.0), f(0.0), out).astype(np.float32)


def resize_weights(in_size: int, out_size: int, kernel: Callable) -> np.ndarray:
    """float32 [in_size, out_size]: `jax.image.compute_weight_mat` at
    scale out/in and no translation, antialiased (the kernel widens by
    the downscale factor)."""
    f = np.float32
    inv_scale = f(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f(1.0))
    sample_f = (np.arange(out_size, dtype=f) + f(0.5)) * inv_scale - f(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f)[:, None]) / kernel_scale
    weights = kernel(x)
    total = weights.sum(axis=0, keepdims=True, dtype=f)
    weights = np.where(np.abs(total) > f(1000.0 * np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, f(1.0)), f(0.0))
    inside = (sample_f >= f(-0.5)) & (sample_f <= f(in_size - 0.5))
    return np.where(inside[None, :], weights, f(0.0)).astype(f)


def nearest_indices(in_size: int, out_size: int) -> np.ndarray:
    """`jax.image.resize`'s nearest rows: floor((o + 0.5) · in / out) in
    float32, the half-pixel centre rule."""
    offsets = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * np.float32(in_size)
    return np.floor(offsets / np.float32(out_size)).astype(np.int64)


_KERNELS = {"linear": _triangle, "cubic": _keys_cubic}


@op("Resize")
def _resize(xp, attrs, x, roi=None, scales=None, sizes=None):
    mode = attrs.get("mode", "nearest")
    if sizes is not None:
        out_spatial = [int(v) for v in
                       _np_static(sizes, "Resize sizes").tolist()][2:]
    else:
        sc = _np_static(scales, "Resize scales").tolist()
        out_spatial = [int(round(x.shape[2 + i] * sc[2 + i]))
                       for i in range(x.ndim - 2)]
    kernel = _KERNELS[mode] if mode != "nearest" else None
    if kernel is not None and not x.is_floating_point():
        x = x.float()  # jax promotes to inexact before the contraction
    for i, out in enumerate(out_spatial):
        d, size = 2 + i, x.shape[2 + i]
        if size == out:
            continue
        if kernel is None:
            rows = torch.from_numpy(nearest_indices(size, out)).to(x.device)
            x = torch.index_select(x, d, rows)
        else:
            w = torch.from_numpy(resize_weights(size, out, kernel)).to(x.device, x.dtype)
            x = torch.matmul(x.movedim(d, -1), w).movedim(-1, d)
    return x


@op("Upsample")
def _upsample(xp, attrs, x, scales=None):
    sc = attrs.get("scales") or _np_static(scales, "Upsample scales").tolist()
    fake_attrs = {"mode": attrs.get("mode", "nearest")}
    return _resize(xp, fake_attrs, x, None, np.asarray(sc, np.float32), None)


@op("Where")
def _where(xp, attrs, cond, a, b):
    return xp.where(cond, a, b)


@op("Equal")
def _equal(xp, attrs, a, b):
    return a == b


@op("Greater")
def _greater(xp, attrs, a, b):
    return a > b


@op("Less")
def _less(xp, attrs, a, b):
    return a < b


@op("Dropout")
def _dropout(xp, attrs, x, *rest):
    return x  # inference mode


# --- the model object ------------------------------------------------------


class OnnxModel:
    """A decoded ONNX graph, executable with torch on `device`.

    `inputs`/`outputs` are the graph's I/O names (initializers
    excluded); `__call__` takes tensors on the model's device or numpy
    arrays, in input order, and returns the list of outputs: tensors on
    the device, or numpy arrays for outputs computed on the host.
    """

    def __init__(self, model: dict[str, Any], device: str | torch.device = "cuda"):
        self.model = model
        self.device = torch.device(device)
        graph = model["graph"]
        self.graph = graph
        self.initializers = {
            t["name"]: proto.tensor_to_array(t)
            for t in graph.get("initializer", [])
        }
        self._on_device: dict[str, torch.Tensor] = {}  # initializers, moved at first use
        self.inputs = [
            vi["name"] for vi in graph.get("input", [])
            if vi["name"] not in self.initializers
        ]
        self.outputs = [vi["name"] for vi in graph.get("output", [])]
        self.nodes = graph.get("node", [])
        unsupported = sorted({
            n["op_type"] for n in self.nodes if n["op_type"] not in _OPS
        })
        if unsupported:
            raise NotImplementedError(
                f"unsupported ONNX ops: {', '.join(unsupported)}"
            )

    def input_shapes(self) -> dict[str, tuple[int, ...]]:
        shapes = {}
        for vi in self.graph.get("input", []):
            if vi["name"] in self.initializers:
                continue
            dims = vi.get("type", {}).get("tensor_type", {}) \
                .get("shape", {}).get("dim", [])
            shapes[vi["name"]] = tuple(
                int(d.get("dim_value", -1)) if "dim_value" in d else -1
                for d in dims
            )
        return shapes

    def _device_value(self, name: str, v: Any) -> Any:
        if v is None or isinstance(v, torch.Tensor):
            return v
        if name in self.initializers and self.initializers[name] is v:
            t = self._on_device.get(name)
            if t is None:
                t = self._on_device[name] = self._to_device(v)
            return t
        return self._to_device(v)

    def _to_device(self, v: Any) -> torch.Tensor:
        arr = np.asarray(v)
        if arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        return torch.from_numpy(np.require(arr, requirements=["C", "W"])).to(self.device)

    def __call__(self, *args: Any) -> list[Any]:
        if len(args) != len(self.inputs):
            raise ValueError(
                f"expected {len(self.inputs)} inputs {self.inputs}, "
                f"got {len(args)}"
            )
        for a in args:
            if isinstance(a, torch.Tensor) and (
                    a.device.type != self.device.type
                    or self.device.index not in (None, a.device.index)):
                raise ValueError(f"input on {a.device}, model on {self.device}")
        env = _Env(self.initializers)
        env.update(zip(self.inputs, args))
        with torch.no_grad(), strict_fp32(self.device):
            for node in self.nodes:
                op_type = node["op_type"]
                names = node.get("input", [])  # the wire format omits an empty list
                ins = env.fetch(names)
                host = op_type not in _DEVICE_ONLY and all(_is_host(i) for i in ins)
                if not host:
                    ins = [self._device_value(n, v) for n, v in zip(names, ins)]
                outs = _OPS[op_type](np if host else _TorchNS, _attrs(node), *ins)
                if not isinstance(outs, tuple):
                    outs = (outs,)
                for name, val in zip(node["output"], outs):
                    if name:
                        env[name] = val
        return [env[n] for n in self.outputs]


def load(path_or_bytes: str | bytes, device: str | torch.device = "cuda") -> OnnxModel:
    """Load an `.onnx` file (or raw bytes) into an OnnxModel on `device`."""
    if isinstance(path_or_bytes, bytes):
        data = path_or_bytes
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    return OnnxModel(proto.decode_model(data), device)
