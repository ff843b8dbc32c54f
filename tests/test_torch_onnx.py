"""The port's ONNX executor against the JAX package's, graph for graph.

Each graph is built with the port's writer, decoded by both runtimes
and run on the same seeded inputs: by the JAX runtime eagerly on the
CPU, and by the port on the CPU twice, once with torch tensors as the
graph inputs (every op on the torch path, the one that runs on the
card) and once with numpy inputs (non-device ops then run in numpy,
as the JAX runtime keeps host values).

Tolerance: float32 results within 1e-5 relative and 1e-5 absolute
(float32 sums in another order; the JAX runtime's products run at
`Precision.HIGHEST`, the port's in full float32); integer and boolean
results equal.
"""

import numpy as np
import pytest
import torch

from spacedrive_tpu.models import onnx_proto as jax_proto
from spacedrive_tpu.models import onnx_runtime as jax_runtime
from spacedrive_tpu_torch.models import onnx_proto as P
from spacedrive_tpu_torch.models import onnx_runtime as R

RNG = np.random.default_rng


def _f(*shape, seed=0, lo=-2.0, hi=2.0):
    return RNG(seed).uniform(lo, hi, shape).astype(np.float32)


def _graph(nodes, inputs: dict, inits: dict | None = None, outputs=("y",)) -> bytes:
    model = P.make_model(
        nodes, [P.make_value_info(k, v.shape, P._DTYPE_CODES[v.dtype]) for k, v in inputs.items()],
        [P.make_value_info(o, ()) for o in outputs], inits or {})
    return P.encode_model(model)


def _one(op, inputs: dict, inits: dict | None = None, outputs=("y",), **attrs):
    """A one-node graph: the node reads the inputs, then the initializers."""
    node = P.make_node(op, [*inputs, *(inits or {})], list(outputs), **attrs)
    return _graph([node], inputs, inits, outputs), inputs


def _as_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.cpu().numpy()
    return np.asarray(v)


def assert_same(got, want) -> None:
    got, want = _as_numpy(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if want.dtype.kind == "f":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)


def run_both(buf: bytes, inputs: dict) -> list:
    """Run the graph through the JAX runtime and both port paths; check
    every output agrees; return the port's torch-path outputs."""
    decoded = jax_proto.decode_model(buf)
    for node in decoded["graph"]["node"]:
        # the JAX runtime reads node["input"] unguarded, and the wire
        # format omits an empty list (a Constant); the port defaults it
        node.setdefault("input", [])
    want = jax_runtime.OnnxModel(decoded)(*inputs.values())
    model = R.load(buf, device="cpu")
    on_torch = model(*(torch.from_numpy(v) for v in inputs.values()))
    on_numpy = model(*inputs.values())
    assert len(on_torch) == len(on_numpy) == len(want)
    for t, n, w in zip(on_torch, on_numpy, want):
        assert_same(t, w)
        assert_same(n, w)
    return on_torch


X = _f(2, 3, 4)
POS = _f(2, 3, 4, seed=1, lo=0.1, hi=3.0)
IMG = _f(2, 3, 9, 9, seed=2)


def _ew(op, **attrs):
    return lambda: [_one(op, {"x": X}, **attrs)]


def _io_symmetric(c, k=(3, 3), seed=0):
    w = _f(c, c, *k, seed=seed)
    return (w + w.transpose(1, 0, 2, 3)) / np.float32(2)


def _conv_cases():
    w = _f(6, 3, 3, 3, seed=3)
    b = _f(6, seed=4)
    wg = _f(6, 1, 3, 3, seed=5)
    return [
        _one("Conv", {"x": IMG}, {"w": w, "b": b}, strides=[2, 1], pads=[1, 0, 2, 1],
             dilations=[1, 2], kernel_shape=[3, 3]),
        _one("Conv", {"x": IMG}, {"w": wg}, group=3, auto_pad="SAME_UPPER", strides=[2, 2]),
        _one("Conv", {"x": IMG}, {"w": w}, auto_pad="SAME_LOWER", strides=[2, 2]),
        _one("Conv", {"x": _f(2, 3, 11, seed=6)}, {"w": _f(4, 3, 3, seed=7)}, pads=[1, 1]),
    ]


def _resize_cases():
    out = []
    for mode in ("nearest", "linear", "cubic"):
        for scales in ([1, 1, 2, 1.5], [1, 1, 0.5, 0.34]):  # up, down (antialiased)
            out.append(_one("Resize", {"x": IMG}, {"roi": np.zeros(0, np.float32),
                                                    "scales": np.array(scales, np.float32)},
                            mode=mode))
    out.append(_one("Resize", {"x": IMG}, {"roi": np.zeros(0, np.float32),
                                           "scales": np.zeros(0, np.float32),
                                           "sizes": np.array([2, 3, 5, 13], np.int64)},
                    mode="linear"))
    return out


# op → a function making [(graph bytes, inputs)], one entry per ONNX op the
# runtimes register (64)
CASES = {
    "Add": lambda: [_one("Add", {"x": X}, {"b": _f(4, seed=9)})],
    "Sub": lambda: [_one("Sub", {"x": X, "b": _f(3, 1, seed=9)})],
    "Mul": lambda: [_one("Mul", {"x": X}, {"b": np.array(2.5, np.float32)})],
    "Div": lambda: [_one("Div", {"x": X, "b": POS})],
    "Pow": lambda: [_one("Pow", {"x": POS}, {"b": np.array([0.5, 2.0, 3.0, -1.0], np.float32)})],
    "Sqrt": lambda: [_one("Sqrt", {"x": POS})],
    "Exp": _ew("Exp"),
    "Log": lambda: [_one("Log", {"x": POS})],
    "Neg": _ew("Neg"),
    "Abs": _ew("Abs"),
    "Relu": _ew("Relu"),
    "Sigmoid": _ew("Sigmoid"),
    "Tanh": _ew("Tanh"),
    "Erf": _ew("Erf"),
    "Identity": _ew("Identity"),
    "Floor": _ew("Floor"),
    "Ceil": _ew("Ceil"),
    "Min": lambda: [_one("Min", {"x": X, "b": POS, "c": _f(4, seed=8)})],
    "Max": lambda: [_one("Max", {"x": X, "b": POS, "c": _f(4, seed=8)})],
    "LeakyRelu": _ew("LeakyRelu", alpha=0.2),
    "HardSigmoid": _ew("HardSigmoid", alpha=0.3, beta=0.4),
    "HardSwish": lambda: [_one("HardSwish", {"x": _f(2, 3, 4, lo=-5, hi=5)})],
    "Clip": lambda: [_one("Clip", {"x": X}, {"lo": np.array(-0.5, np.float32),
                                             "hi": np.array(0.7, np.float32)}),
                     _one("Clip", {"x": X}, min=-0.2, max=0.4)],
    "Softmax": lambda: [_one("Softmax", {"x": X}, axis=1)],
    "Concat": lambda: [_one("Concat", {"x": X, "b": _f(2, 2, 4, seed=3)}, axis=1)],
    "Reshape": lambda: [_one("Reshape", {"x": X}, {"s": np.array([4, 0, -1], np.int64)})],
    "Flatten": lambda: [_one("Flatten", {"x": IMG}, axis=2)],
    "Transpose": lambda: [_one("Transpose", {"x": X}, perm=[2, 0, 1]),
                          _one("Transpose", {"x": X})],
    "Unsqueeze": lambda: [_one("Unsqueeze", {"x": X}, {"a": np.array([0, 4], np.int64)}),
                          _one("Unsqueeze", {"x": X}, axes=[1])],
    "Squeeze": lambda: [_one("Squeeze", {"x": _f(1, 3, 1, 4)}, {"a": np.array([0, 2], np.int64)}),
                        _one("Squeeze", {"x": _f(1, 3, 1, 4)})],
    "Shape": lambda: [_one("Shape", {"x": IMG})],
    "Gather": lambda: [_one("Gather", {"x": _f(5, 4)}, {"i": np.array([[0, 4], [2, 3]], np.int64)}),
                       _one("Gather", {"x": _f(5, 4)}, {"i": np.array(1, np.int64)}, axis=1)],
    "Slice": lambda: [_one("Slice", {"x": _f(4, 6)}, {
        "st": np.array([1, -1], np.int64), "en": np.array([3, -7], np.int64),
        "ax": np.array([0, 1], np.int64), "sp": np.array([1, -2], np.int64)}),
        _one("Slice", {"x": _f(4, 6)}, {"st": np.array([2], np.int64),
                                        "en": np.array([2 ** 62], np.int64)})],
    "Split": lambda: [_one("Split", {"x": _f(2, 6)}, {"s": np.array([2, 4], np.int64)},
                           outputs=("y", "z"), axis=1),
                      _one("Split", {"x": _f(2, 7)}, outputs=("y", "z", "w"), axis=1,
                           num_outputs=3)],
    "Cast": lambda: [_one("Cast", {"x": _f(2, 3, lo=-9, hi=9)}, to=6),
                     _one("Cast", {"x": X}, to=9)],
    "Constant": lambda: [
        (_graph([P.make_node("Constant", [], ["c"], value=_f(4, seed=2)),
                 P.make_node("Add", ["x", "c"], ["y"])], {"x": X}), {"x": X}),
        (_graph([P.make_node("Constant", [], ["c"], value_ints=[1, 2, 3, 4]),
                 P.make_node("Mul", ["x", "c"], ["y"])], {"x": X}), {"x": X})],
    "ConstantOfShape": lambda: [
        (_graph([P.make_node("ConstantOfShape", ["s"], ["c"], value=np.array([1.5], np.float32)),
                 P.make_node("Add", ["x", "c"], ["y"])], {"x": X},
                {"s": np.array([2, 3, 4], np.int64)}), {"x": X})],
    "Range": lambda: [
        (_graph([P.make_node("Range", ["a", "b", "d"], ["r"]),
                 P.make_node("Mul", ["x", "r"], ["y"])], {"x": X},
                {"a": np.array(1.0, np.float32), "b": np.array(5.0, np.float32),
                 "d": np.array(1.0, np.float32)}), {"x": X})],
    "Expand": lambda: [_one("Expand", {"x": _f(3, 1)}, {"s": np.array([2, 1, 4], np.int64)})],
    "Tile": lambda: [_one("Tile", {"x": _f(2, 3)}, {"r": np.array([2, 3], np.int64)})],
    "Pad": lambda: [
        _one("Pad", {"x": IMG}, {"p": np.array([0, 0, 0, 1, 0, 0, 1, 2], np.int64),
                                 "v": np.array(0.5, np.float32)}),
        _one("Pad", {"x": IMG}, {"p": np.array([0, 0, 2, 1, 0, 0, 1, 3], np.int64)},
             mode="reflect"),
        _one("Pad", {"x": IMG}, {"p": np.array([0, 1, 2, 1, 0, 0, 1, 3], np.int64)}, mode="edge")],
    "ReduceMean": lambda: [_one("ReduceMean", {"x": IMG}, axes=[2, 3], keepdims=0),
                           _one("ReduceMean", {"x": IMG})],
    "ReduceSum": lambda: [_one("ReduceSum", {"x": IMG}, {"a": np.array([1, -1], np.int64)})],
    "ReduceMax": lambda: [_one("ReduceMax", {"x": IMG}, axes=[1], keepdims=0)],
    "ReduceMin": lambda: [_one("ReduceMin", {"x": IMG}, axes=[0, 3])],
    "ArgMax": lambda: [_one("ArgMax", {"x": IMG}, axis=1),
                       _one("ArgMax", {"x": IMG}, axis=3, keepdims=0)],
    "MatMul": lambda: [_one("MatMul", {"x": X}, {"w": _f(4, 5, seed=3)}),
                       _one("MatMul", {"x": _f(7, seed=1), "w": _f(7, 3, seed=2)})],
    "Gemm": lambda: [_one("Gemm", {"a": _f(5, 7)}, {"w": _f(6, 7, seed=1), "c": _f(5, 6, seed=2)},
                          alpha=0.5, beta=2.0, transB=1),
                     _one("Gemm", {"a": _f(7, 5)}, {"w": _f(7, 6, seed=1), "c": _f(6, seed=2)},
                          transA=1)],
    "Conv": _conv_cases,
    # weights symmetric in (C_in, C_out): the JAX runtime reads the ONNX
    # weight with those axes swapped (see test_conv_transpose_follows_onnx)
    "ConvTranspose": lambda: [
        _one("ConvTranspose", {"x": IMG}, {"w": _io_symmetric(3, seed=3), "b": _f(3, seed=4)},
             strides=[2, 2], pads=[1, 0, 1, 1]),
        _one("ConvTranspose", {"x": IMG}, {"w": _io_symmetric(3, (2, 4), seed=6)},
             strides=[3, 1], auto_pad="VALID")],
    "MaxPool": lambda: [
        _one("MaxPool", {"x": IMG}, kernel_shape=[3, 3], strides=[2, 2], pads=[1, 1, 1, 1],
             ceil_mode=1),
        _one("MaxPool", {"x": IMG}, kernel_shape=[2, 3], dilations=[2, 1],
             auto_pad="SAME_UPPER")],
    "AveragePool": lambda: [
        _one("AveragePool", {"x": IMG}, kernel_shape=[3, 3], strides=[2, 2],
             pads=[1, 1, 1, 1]),
        _one("AveragePool", {"x": IMG}, kernel_shape=[3, 2], strides=[2, 2],
             pads=[1, 0, 1, 1], ceil_mode=1, count_include_pad=1),
        _one("AveragePool", {"x": IMG}, kernel_shape=[2, 2], strides=[2, 2], ceil_mode=1)],
    "GlobalAveragePool": lambda: [_one("GlobalAveragePool", {"x": IMG})],
    "GlobalMaxPool": lambda: [_one("GlobalMaxPool", {"x": IMG})],
    "BatchNormalization": lambda: [_one("BatchNormalization", {"x": IMG}, {
        "s": _f(3, seed=1), "b": _f(3, seed=2), "m": _f(3, seed=3),
        "v": _f(3, seed=4, lo=0.5, hi=2)}, epsilon=1e-3)],
    "InstanceNormalization": lambda: [_one("InstanceNormalization", {"x": IMG}, {
        "s": _f(3, seed=1), "b": _f(3, seed=2)})],
    "LayerNormalization": lambda: [
        _one("LayerNormalization", {"x": IMG}, {"s": _f(9, seed=1), "b": _f(9, seed=2)}),
        _one("LayerNormalization", {"x": IMG}, {"s": _f(9, 9, seed=1)}, axis=2, epsilon=1e-3)],
    "Resize": _resize_cases,
    "Upsample": lambda: [_one("Upsample", {"x": IMG}, {"s": np.array([1, 1, 2, 3], np.float32)}),
                         _one("Upsample", {"x": IMG}, {"s": np.array([1, 1, 2, 2], np.float32)},
                              mode="linear")],
    "Where": lambda: [_one("Where", {"c": RNG(1).random((2, 3, 4)) > 0.5, "x": X, "b": POS})],
    "Equal": lambda: [_one("Equal", {"x": np.array([1, 2, 3, 4], np.int64),
                                     "b": np.array([1, 0, 3, 5], np.int64)})],
    "Greater": lambda: [_one("Greater", {"x": X, "b": _f(4, seed=5)})],
    "Less": lambda: [_one("Less", {"x": X, "b": _f(4, seed=5)})],
    "Dropout": lambda: [_one("Dropout", {"x": X}, {"r": np.array(0.5, np.float32)})],
}


def test_op_table_covers_both_runtimes():
    assert set(CASES) == set(R._OPS) == set(jax_runtime._OPS)
    assert len(CASES) == 64
    assert R._DEVICE_ONLY == jax_runtime._DEVICE_ONLY


@pytest.mark.parametrize("op_type", sorted(CASES))
def test_op_matches_jax_runtime(op_type):
    for buf, inputs in CASES[op_type]():
        run_both(buf, inputs)


def test_writer_bytes_equal_the_jax_writer():
    nodes = [P.make_node("Conv", ["x", "w"], ["y"], kernel_shape=[3, 3], pads=[1, 1, 1, 1],
                         alpha=0.5, mode="linear", value=np.arange(3, dtype=np.int64))]
    args = (nodes, [P.make_value_info("x", (1, 3, 8, 8))], [P.make_value_info("y", (1, 2, 8, 8))],
            {"w": _f(2, 3, 3, 3)})
    jnodes = [jax_proto.make_node("Conv", ["x", "w"], ["y"], kernel_shape=[3, 3],
                                  pads=[1, 1, 1, 1], alpha=0.5, mode="linear",
                                  value=np.arange(3, dtype=np.int64))]
    jargs = (jnodes, [jax_proto.make_value_info("x", (1, 3, 8, 8))],
             [jax_proto.make_value_info("y", (1, 2, 8, 8))], {"w": _f(2, 3, 3, 3)})
    buf = P.encode_model(P.make_model(*args))
    assert buf == jax_proto.encode_model(jax_proto.make_model(*jargs))
    assert P.decode_model(buf) == jax_proto.decode_model(buf)


def _cnn_classifier(batch: int = 2, size: int = 16):
    """Conv(s2,p1) → BN → SiLU → MaxPool → GAP → Gemm, seeded (the shape
    of `test_onnx.py::test_cnn_classifier_matches_torch`)."""
    rng = RNG(0)
    nodes = [
        P.make_node("Conv", ["x", "w", "b"], ["c"], strides=[2, 2], pads=[1, 1, 1, 1],
                    kernel_shape=[3, 3]),
        P.make_node("BatchNormalization", ["c", "gamma", "beta", "mu", "var"], ["bn"],
                    epsilon=1e-5),
        P.make_node("Sigmoid", ["bn"], ["sig"]),
        P.make_node("Mul", ["bn", "sig"], ["silu"]),
        P.make_node("MaxPool", ["silu"], ["mp"], kernel_shape=[2, 2], strides=[2, 2]),
        P.make_node("GlobalAveragePool", ["mp"], ["gap"]),
        P.make_node("Flatten", ["gap"], ["flat"]),
        P.make_node("Gemm", ["flat", "fcw", "fcb"], ["out"], transB=1),
    ]
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    inits = {"w": f(8, 3, 3, 3) * 0.3, "b": f(8), "gamma": f(8), "beta": f(8),
             "mu": f(8) * 0.1, "var": rng.random(8).astype(np.float32) + 0.5,
             "fcw": f(5, 8), "fcb": f(5)}
    x = rng.standard_normal((batch, 3, size, size)).astype(np.float32)
    return P.encode_model(P.make_model(nodes, [P.make_value_info("x", x.shape)],
                                       [P.make_value_info("out", (batch, 5))], inits)), x


def _yolo_style():
    """Split / Concat / Resize(nearest ×2) / Slice / Softmax / Transpose /
    Reshape: the YOLO-head op vocabulary (`test_onnx.py`'s graph)."""
    rng = RNG(1)
    nodes = [
        P.make_node("Conv", ["x", "w", "b"], ["c"], kernel_shape=[1, 1]),
        P.make_node("Split", ["c"], ["a", "bb"], axis=1, split=[8, 8]),
        P.make_node("Resize", ["bb", "", "scales"], ["up"], mode="nearest"),
        P.make_node("MaxPool", ["up"], ["down"], kernel_shape=[2, 2], strides=[2, 2]),
        P.make_node("Concat", ["a", "down"], ["cat"], axis=1),
        P.make_node("Slice", ["cat", "starts", "ends", "axes"], ["sl"]),
        P.make_node("Softmax", ["sl"], ["sm"], axis=1),
        P.make_node("Transpose", ["sm"], ["tr"], perm=[0, 2, 3, 1]),
        P.make_node("Reshape", ["tr", "shape"], ["out"]),
    ]
    inits = {
        "w": rng.standard_normal((16, 4, 1, 1)).astype(np.float32),
        "b": rng.standard_normal(16).astype(np.float32),
        "scales": np.array([1, 1, 2, 2], np.float32),
        "starts": np.array([2], np.int64), "ends": np.array([14], np.int64),
        "axes": np.array([1], np.int64), "shape": np.array([2, -1, 12], np.int64),
    }
    x = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    return P.encode_model(P.make_model(nodes, [P.make_value_info("x", x.shape)],
                                       [P.make_value_info("out", (2, 64, 12))], inits)), x


def test_cnn_classifier_and_yolo_style_graphs_match_jax():
    for buf, x in (_cnn_classifier(), _yolo_style()):
        run_both(buf, {"x": x})


def test_grouped_and_depthwise_conv_match_jax():
    rng = RNG(3)
    nodes = [
        P.make_node("Conv", ["x", "w1", "b1"], ["c1"], kernel_shape=[3, 3], pads=[1, 1, 1, 1],
                    group=4),
        P.make_node("Conv", ["c1", "w2", "b2"], ["out"], kernel_shape=[3, 3], pads=[1, 1, 1, 1],
                    group=8),
    ]
    inits = {"w1": rng.standard_normal((8, 2, 3, 3)).astype(np.float32),
             "b1": rng.standard_normal(8).astype(np.float32),
             "w2": rng.standard_normal((8, 1, 3, 3)).astype(np.float32),
             "b2": rng.standard_normal(8).astype(np.float32)}
    x = rng.standard_normal((1, 8, 10, 10)).astype(np.float32)
    buf = P.encode_model(P.make_model(nodes, [P.make_value_info("x", x.shape)],
                                      [P.make_value_info("out", (1, 8, 10, 10))], inits))
    run_both(buf, {"x": x})


def test_resize_weights_equal_jax_image():
    import jax.numpy as jnp
    from jax._src.image import scale as jax_scale

    for m, n in ((9, 18), (9, 13), (9, 3), (17, 5), (4, 4)):
        for name, kernel, jkernel in (("linear", R._triangle, jax_scale._fill_triangle_kernel),
                                      ("cubic", R._keys_cubic, jax_scale._fill_keys_cubic_kernel)):
            want = np.asarray(jax_scale.compute_weight_mat(m, n, n / m, 0.0, jkernel, True))
            np.testing.assert_allclose(R.resize_weights(m, n, kernel), want, atol=1e-6,
                                       err_msg=f"{name} {m}->{n}")
        rows = np.asarray(jax_scale._resize_nearest(jnp.arange(m)[:, None], (n, 1)))[:, 0]
        np.testing.assert_array_equal(R.nearest_indices(m, n), rows)


def test_unsupported_op_raises_with_its_name():
    buf = P.encode_model(P.make_model(
        [P.make_node("NonMaxSuppression", ["x"], ["y"]), P.make_node("TopK", ["y"], ["z"])],
        [P.make_value_info("x", (1,))], [P.make_value_info("z", (1,))], {}))
    with pytest.raises(NotImplementedError, match="NonMaxSuppression, TopK"):
        R.load(buf, device="cpu")


def test_conv_transpose_follows_onnx():
    """ONNX's ConvTranspose weight is (C_in, C_out, k...), torch's own
    layout: the port equals `F.conv_transpose2d` cropped by the pads, at
    C_in != C_out. (The JAX runtime transposes the weight's first two
    axes, so it computes the transpose of that kernel, and fails
    outright when C_in != C_out; ROADMAP queue 3.)"""
    import torch.nn.functional as F

    w, b = _f(3, 4, 3, 3, seed=3), _f(4, seed=4)
    buf, _ = _one("ConvTranspose", {"x": IMG}, {"w": w, "b": b}, strides=[2, 2],
                  pads=[1, 0, 1, 1])
    got = R.load(buf, device="cpu")(torch.from_numpy(IMG))[0]
    full = F.conv_transpose2d(torch.from_numpy(IMG), torch.from_numpy(w), torch.from_numpy(b),
                              stride=2)
    assert_same(got, full[:, :, 1:-1, 0:-1].numpy())


@pytest.mark.parametrize("attrs", [dict(group=3), dict(dilations=[2, 2]),
                                   dict(output_padding=[1, 1]), dict(output_shape=[20, 20]),
                                   dict(auto_pad="SAME_UPPER")])
def test_conv_transpose_refuses_what_it_does_not_model(attrs):
    buf, inputs = _one("ConvTranspose", {"x": IMG}, {"w": _f(3, 1, 3, 3)}, strides=[2, 2],
                       **attrs)
    with pytest.raises(NotImplementedError, match="ConvTranspose"):
        R.load(buf, device="cpu")(torch.from_numpy(IMG))
    with pytest.raises(NotImplementedError, match="ConvTranspose"):
        jax_runtime.load(buf)(IMG)


def test_shape_subgraph_stays_static_on_the_host():
    """Shape → Gather → Unsqueeze → Concat → Reshape: the target is
    computed in numpy although x is a tensor, and the Reshape runs on
    the tensor."""
    nodes = [
        P.make_node("Shape", ["x"], ["sh"]),
        P.make_node("Gather", ["sh", "zero"], ["batch"], axis=0),
        P.make_node("Unsqueeze", ["batch"], ["b1"], axes=[0]),
        P.make_node("Concat", ["b1", "minus1"], ["target"], axis=0),
        P.make_node("Reshape", ["x", "target"], ["out"]),
    ]
    inits = {"zero": np.array(0, np.int64), "minus1": np.array([-1], np.int64)}
    buf = P.encode_model(P.make_model(nodes, [P.make_value_info("x", (3, 4, 5))],
                                      [P.make_value_info("out", (3, 20)),
                                       P.make_value_info("target", (2,))], inits))
    x = RNG(0).standard_normal((3, 4, 5)).astype(np.float32)
    out, target = R.load(buf, device="cpu")(torch.from_numpy(x))
    assert isinstance(target, np.ndarray) and target.tolist() == [3, -1]
    assert isinstance(out, torch.Tensor)
    np.testing.assert_array_equal(out.numpy(), x.reshape(3, 20))


def test_inputs_on_another_device_are_refused():
    buf, _ = _one("Relu", {"x": X})
    model = R.load(buf, device="meta")
    with pytest.raises(ValueError, match="model on meta"):
        model(torch.from_numpy(X))
