"""`strict_fp32` hands the caller back every TF32 setting it had.

The section only touches torch's process-wide flags, so it runs without
a card: `strict_fp32(torch.device("cuda"))` on a CPU build sets and
restores the same flags it does on the H100. Each case runs in a fresh
interpreter, so no flag leaks into another test (a "medium" precision
also turns the CPU's oneDNN matmuls to bf16).
"""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# how the caller set its precision before entering the section
CALLERS = {
    "highest": "torch.set_float32_matmul_precision('highest')",
    "high": "torch.set_float32_matmul_precision('high')",
    "medium": "torch.set_float32_matmul_precision('medium')",
    "legacy_flags_on": ("torch.backends.cuda.matmul.allow_tf32 = True\n"
                        "torch.backends.cudnn.allow_tf32 = True"),
    "legacy_flags_off": ("torch.backends.cuda.matmul.allow_tf32 = False\n"
                         "torch.backends.cudnn.allow_tf32 = False"),
    "fp32_precision_strings": ("if hasattr(torch.backends.cuda.matmul, 'fp32_precision'):\n"
                               "    torch.backends.cuda.matmul.fp32_precision = 'tf32'"),
}

# the snapshot is the test's own, independent of the module under test
SCRIPT = """
import json, torch
from spacedrive_tpu_torch.utils.precision import strict_fp32

def read(fn):
    try:
        return fn()
    except (RuntimeError, AttributeError):
        return "unreadable"

def snapshot():
    out = {"precision": read(torch.get_float32_matmul_precision),
           "matmul_allow_tf32": read(lambda: torch.backends.cuda.matmul.allow_tf32),
           "cudnn_allow_tf32": read(lambda: torch.backends.cudnn.allow_tf32)}
    for path in ("", "cuda.matmul", "cudnn", "cudnn.conv", "cudnn.rnn",
                 "mkldnn", "mkldnn.matmul", "mkldnn.conv", "mkldnn.rnn"):
        def get(path=path):
            obj = torch.backends
            for part in filter(None, path.split(".")):
                obj = getattr(obj, part)
            return obj.fp32_precision
        out["fp32_precision:" + path] = read(get)
    return out

CALLER
before = snapshot()
with strict_fp32(torch.device("cuda")):
    inside = [torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32]
after = snapshot()
print(json.dumps({"before": before, "inside": inside, "after": after}))
"""


@pytest.mark.parametrize("caller", sorted(CALLERS))
def test_strict_fp32_restores_the_callers_precision(caller):
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT.replace("CALLER", CALLERS[caller])],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["inside"] == [False, False], "TF32 must be off inside the section"
    assert got["after"] == got["before"]
    if caller in ("highest", "high", "medium"):
        assert got["after"]["precision"] == caller
