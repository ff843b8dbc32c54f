"""LabelerNet: the image labeler's multi-label classifier, in torch.

Counterpart of `spacedrive_tpu/models/labeler.py` (the flax
`LabelerNet`, `ConvBlock`, `Bottleneck` and `infer_step`). The
reference labels library images with YOLOv8 and keeps every class whose
confidence clears a threshold as a text label
(ref:crates/ai/src/image_labeler/actor.rs:67-73); this model is a
multi-label classifier over the same 80-class vocabulary: a stride-2
stem, four stride-2 stages of residual 3×3 conv pairs, a global average
pool and two dense layers.

Numerics follow flax so that the port agrees with the JAX forward on the
same parameters: compute in bf16 with float32 parameters, and

- `padding="SAME"` as flax resolves it: at stride 2 on an even input
  the pad is (0, 1), not (1, 1) (`same_pads`);
- flax's GroupNorm: `min(32, C // 4)` groups, epsilon 1e-6, statistics
  in float32 by E[x²] − E[x]², the affine in float32, then bf16;
- the global mean accumulates in float32 and rounds once to bf16; the
  dense layers cast kernel and bias to bf16 and add the bias after the
  product; the logits return as float32.

Parameters load from the flax tree (`params_from_flax`, the layout of a
`models/checkpoint.py` artifact) or from a seeded generator
(`init_params`). The public input layout is the JAX package's:
float[B, H, W, 3] in [0, 1].
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# The 80-class COCO vocabulary YOLOv8 ships with; the reference maps
# detections to these names as searchable labels.
LABEL_CLASSES = (
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep",
    "cow", "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella",
    "handbag", "tie", "suitcase", "frisbee", "skis", "snowboard",
    "sports ball", "kite", "baseball bat", "baseball glove", "skateboard",
    "surfboard", "tennis racket", "bottle", "wine glass", "cup", "fork",
    "knife", "spoon", "bowl", "banana", "apple", "sandwich", "orange",
    "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair",
    "couch", "potted plant", "bed", "dining table", "toilet", "tv",
    "laptop", "mouse", "remote", "keyboard", "cell phone", "microwave",
    "oven", "toaster", "sink", "refrigerator", "book", "clock", "vase",
    "scissors", "teddy bear", "hair drier", "toothbrush",
)

NUM_CLASSES = len(LABEL_CLASSES)
DEFAULT_IMAGE_SIZE = 224
DEFAULT_WIDTHS = (32, 64, 128, 256, 256)
DEFAULT_DEPTHS = (1, 2, 2, 1)
HIDDEN = 512
GROUPNORM_EPS = 1e-6


def same_pads(size: int, stride: int, kernel: int = 3) -> tuple[int, int]:
    """(low, high) pad of one spatial dim under `padding="SAME"`, as
    `lax.padtype_to_pads` computes it."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class ConvBlock(nn.Module):
    """3×3 conv (no bias) → flax GroupNorm → SiLU, bf16 compute."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.groups = min(32, cout // 4)
        self.weight = nn.Parameter(torch.zeros(cout, cin, 3, 3), requires_grad=False)
        self.scale = nn.Parameter(torch.ones(cout), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(cout), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (top, bottom), (left, right) = (same_pads(x.shape[2], self.stride),
                                        same_pads(x.shape[3], self.stride))
        x = F.pad(x, (left, right, top, bottom))
        x = F.conv2d(x, self.weight.to(torch.bfloat16), stride=self.stride)
        return F.silu(self._group_norm(x))

    def _group_norm(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        xf = x.float()
        # per-channel sums, then per group: no regrouped copy of x
        n = (c // self.groups) * h * w
        s1 = xf.sum(dim=(2, 3)).view(b, self.groups, -1).sum(dim=2, keepdim=True)
        s2 = (xf * xf).sum(dim=(2, 3)).view(b, self.groups, -1).sum(dim=2, keepdim=True)
        mean = s1 / n
        var = torch.clamp(s2 / n - mean * mean, min=0.0)
        mul = torch.rsqrt(var + GROUPNORM_EPS).expand(b, self.groups, c // self.groups)
        mul = mul.reshape(b, c, 1, 1) * self.scale.view(1, c, 1, 1)
        mean = mean.expand(b, self.groups, c // self.groups).reshape(b, c, 1, 1)
        y = (xf - mean) * mul + self.bias.view(1, c, 1, 1)
        return y.to(torch.bfloat16)


class Bottleneck(nn.Module):
    """Residual pair of 3×3 ConvBlocks (the YOLO-family bottleneck)."""

    def __init__(self, width: int):
        super().__init__()
        self.block0 = ConvBlock(width, width)
        self.block1 = ConvBlock(width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.block1(self.block0(x))


class LabelerNet(nn.Module):
    """Multi-label classifier: images float[B, H, W, 3] in [0, 1] →
    logits float32[B, num_classes]. At the default widths a 224² input
    runs the stride-2 stem and four stride-2 stages to a 7×7×256 map."""

    def __init__(self, num_classes: int = NUM_CLASSES,
                 widths: Sequence[int] = DEFAULT_WIDTHS,
                 depths: Sequence[int] = DEFAULT_DEPTHS):
        super().__init__()
        self.num_classes = num_classes
        self.widths = tuple(int(w) for w in widths)
        self.depths = tuple(int(d) for d in depths)
        self.stem = ConvBlock(3, self.widths[0], stride=2)
        stages = []
        for cin, width, depth in zip(self.widths, self.widths[1:], self.depths):
            stages.append(nn.Sequential(ConvBlock(cin, width, stride=2),
                                        *(Bottleneck(width) for _ in range(depth))))
        self.stages = nn.Sequential(*stages)
        self.dense0_weight = nn.Parameter(torch.zeros(HIDDEN, self.widths[-1]), requires_grad=False)
        self.dense0_bias = nn.Parameter(torch.zeros(HIDDEN), requires_grad=False)
        self.dense1_weight = nn.Parameter(torch.zeros(num_classes, HIDDEN), requires_grad=False)
        self.dense1_bias = nn.Parameter(torch.zeros(num_classes), requires_grad=False)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        # NHWC in, NCHW strides of the same memory: channels-last convs
        x = images.to(torch.bfloat16).permute(0, 3, 1, 2)
        x = self.stages(self.stem(x))
        x = x.float().mean(dim=(2, 3)).to(torch.bfloat16)
        x = F.silu(self._dense(x, self.dense0_weight, self.dense0_bias))
        return self._dense(x, self.dense1_weight, self.dense1_bias).float()

    @staticmethod
    def _dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        return x @ weight.to(torch.bfloat16).t() + bias.to(torch.bfloat16)

    def blocks(self) -> list[tuple[str, ConvBlock]]:
        """Every ConvBlock with its flax path, in flax's naming order."""
        out = [("ConvBlock_0", self.stem)]
        n_bottleneck = 0
        for i, stage in enumerate(self.stages, start=1):
            out.append((f"ConvBlock_{i}", stage[0]))
            for bottleneck in stage[1:]:
                name = f"Bottleneck_{n_bottleneck}"
                n_bottleneck += 1
                out.append((f"{name}/ConvBlock_0", bottleneck.block0))
                out.append((f"{name}/ConvBlock_1", bottleneck.block1))
        return out


def _leaf(tree: Any, path: str) -> np.ndarray:
    for part in path.split("/"):
        if not isinstance(tree, dict) or part not in tree:
            raise KeyError(f"flax parameter tree has no {path}")
        tree = tree[part]
    return np.array(tree, np.float32)  # a writable copy


def params_from_flax(tree: Any, model: LabelerNet) -> dict[str, torch.Tensor]:
    """The flax parameter tree (numpy arrays: `LabelerNet.init(...)
    ["params"]` or `checkpoint.load`'s tree) as `model`'s state dict.
    Conv kernels go HWIO → OIHW, dense kernels [in, out] → [out, in]."""
    names = {id(p): n for n, p in model.named_parameters()}
    state: dict[str, torch.Tensor] = {}
    for path, block in model.blocks():
        kernel = _leaf(tree, f"{path}/Conv_0/kernel")
        state[names[id(block.weight)]] = torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy())
        state[names[id(block.scale)]] = torch.from_numpy(_leaf(tree, f"{path}/GroupNorm_0/scale"))
        state[names[id(block.bias)]] = torch.from_numpy(_leaf(tree, f"{path}/GroupNorm_0/bias"))
    for i in (0, 1):
        state[f"dense{i}_weight"] = torch.from_numpy(_leaf(tree, f"Dense_{i}/kernel").T.copy())
        state[f"dense{i}_bias"] = torch.from_numpy(_leaf(tree, f"Dense_{i}/bias"))
    want = set(model.state_dict())
    if set(state) != want:
        raise ValueError(f"flax tree does not fit the model: {sorted(want ^ set(state))}")
    return state


def from_flax(tree: Any, num_classes: int, widths: Sequence[int], depths: Sequence[int],
              device: str | torch.device = "cuda") -> LabelerNet:
    """A LabelerNet of that architecture holding the flax tree's weights,
    on `device`, in eval mode."""
    model = LabelerNet(num_classes, widths, depths)
    model.load_state_dict(params_from_flax(tree, model))
    return model.to(device).eval()


def init_params(generator: torch.Generator, model: LabelerNet | None = None) -> LabelerNet:
    """Fill `model` (default: the full-width 80-class net) with seeded
    weights, drawn on the CPU from `generator`: flax's initializers
    (LeCun normal kernels, unit GroupNorm scales, zero biases), without
    truncation. Returns the model, in eval mode."""
    model = model if model is not None else LabelerNet()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("scale"):
                p.fill_(1.0)
            elif p.dim() == 1:
                p.zero_()
            else:
                fan_in = p[0].numel()
                p.copy_(torch.randn(p.shape, generator=generator) * fan_in ** -0.5)
    return model.eval()


def conv_flops(model: LabelerNet, image_size: int) -> int:
    """Multiply-adds × 2 of one image's forward, from the shapes: every
    3×3 conv over its SAME-padded output, and the two dense layers."""
    flops, size = 0, image_size
    for _path, block in model.blocks():
        size = -(-size // block.stride)
        cout, cin = block.weight.shape[:2]
        flops += 2 * size * size * cout * cin * 9
    flops += 2 * (model.dense0_weight.numel() + model.dense1_weight.numel())
    return flops


@torch.no_grad()
def infer_step(model: LabelerNet, images: torch.Tensor,
               threshold: float = 0.35) -> tuple[torch.Tensor, torch.Tensor]:
    """(probs float32[B, C], mask bool[B, C]): the mask selects the
    emitted labels, the reference's confidence cut before it writes
    `label` rows."""
    probs = torch.sigmoid(model(images))
    return probs, probs >= threshold
