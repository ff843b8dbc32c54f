"""The PyTorch port stands alone: no JAX, no spacedrive_tpu, no build at
import, and no CUDA needed to import it."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(ROOT, "spacedrive_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "spacedrive_tpu")


def _port_sources():
    for dirpath, _, files in os.walk(PACKAGE):
        if "_build" in dirpath.split(os.sep):
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _imported_modules(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("path", sorted(_port_sources()), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_jax_package_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{os.path.relpath(path, ROOT)} imports {mod}"


def test_import_builds_nothing_and_needs_no_cuda():
    """Import every module of the port in a fresh interpreter with CUDA
    hidden: no jax module loads, no kernel builds, nothing compiles."""
    modules = []
    for path in _port_sources():
        rel = os.path.relpath(path, ROOT)
        if rel == "chip_smoke.py" or rel.endswith("__main__.py"):
            continue
        modules.append(rel[:-3].replace(os.sep, ".").removesuffix(".__init__"))
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "from spacedrive_tpu_torch.ops import blake3_cuda\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "assert blake3_cuda._built == []\n"
        "assert 'torch.utils.cpp_extension' not in sys.modules\n"
        "print('ok', len(sys.modules))\n"
    )
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
    assert not os.path.exists(os.path.join(PACKAGE, "_build", "blake3_chunk", "lock"))


def test_chip_smoke_refuses_without_cuda():
    """With no CUDA device the smoke exits non-zero and prints no result."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
