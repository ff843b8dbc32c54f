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
    yield os.path.join(ROOT, "profile_library.py")


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


def test_the_scan_covers_the_decoders():
    """The other decoders (owned copies of the JAX modules and the video
    loader) are among the scanned sources, so the import checks above
    and the fresh-interpreter import below hold them too."""
    rel = {os.path.relpath(p, PACKAGE) for p in _port_sources()}
    media = os.path.join("object", "media")
    assert {os.path.join(media, f) for f in ("images.py", "svg.py", "pdf.py", "pdf_raster.py",
                                            "pdf_fonts.py")} <= rel
    assert {os.path.join("native", "video.py"), os.path.join(media, "thumbnail", "host.py"),
            os.path.join("ops", "thumbnail_dims.py")} <= rel


def test_the_scan_covers_the_samplers_and_verdicts():
    """The node's samplers and verdicts (owned copies of the JAX
    telemetry modules and the resilience layer) are scanned too."""
    rel = {os.path.relpath(p, PACKAGE) for p in _port_sources()}
    tel = {os.path.join("telemetry", f) for f in (
        "history.py", "resources.py", "slo.py", "attrib.py", "tenants.py", "health.py",
        "federation.py")}
    assert tel | {os.path.join("utils", "resilience.py"), os.path.join("utils", "compat.py")} <= rel


def test_the_scan_covers_the_live_location():
    """The location manager, its watchers, ephemeral browsing, the
    fs-ops jobs and the orphan remover (owned copies of the JAX
    modules) are scanned too."""
    rel = {os.path.relpath(p, PACKAGE) for p in _port_sources()}
    loc = os.path.join("location", "watcher")
    fs = os.path.join("object", "fs")
    assert {os.path.join("location", "manager.py"), os.path.join("location", "non_indexed.py"),
            os.path.join("object", "orphan_remover.py")} <= rel
    assert {os.path.join(loc, f) for f in ("__init__.py", "events.py", "inotify.py",
                                           "polling.py", "platform_norm.py")} <= rel
    assert {os.path.join(fs, f) for f in ("__init__.py", "copy.py", "cut.py", "delete.py",
                                          "erase.py")} <= rel


def test_the_scan_covers_sync_ingest_and_crypto():
    """Sync ingest and the crypto stack (owned copies of the JAX modules)
    are scanned too. Their MessagePack bytes, packed and read, come from
    utils/msgpack_codec: none imports the `msgpack` package."""
    rel = {os.path.relpath(p, PACKAGE) for p in _port_sources()}
    planes = {os.path.join("db", "sync_registry.py"), os.path.join("object", "fs", "encrypt.py")}
    planes |= {os.path.join("sync", f) for f in ("apply.py", "ingest.py", "crdt.py",
                                                 "manager.py")}
    planes |= {os.path.join("crypto", f) for f in ("__init__.py", "stream.py", "xchacha.py",
                                                   "hashing.py", "header.py", "keys.py",
                                                   "keyring.py")}
    assert planes <= rel
    for f in planes:
        with open(os.path.join(PACKAGE, f), encoding="utf-8") as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module] if isinstance(node, ast.ImportFrom) else [])
            assert "msgpack" not in names, f"{f} imports msgpack"



P2P_TRANSPORT = ("__init__.py", "identity.py", "wire.py", "block.py", "protocol.py", "noise.py",
                 "transport.py", "p2p.py", "udp.py", "udpstream.py", "punch.py", "relay.py",
                 "tunnel.py", "mdns.py")


def test_the_scan_covers_the_p2p_transport():
    """The p2p transport (owned copies of the JAX modules) is scanned
    too, and its MessagePack frames come from utils/msgpack_codec: none
    imports the `msgpack` package."""
    rel = {os.path.relpath(p, PACKAGE) for p in _port_sources()}
    files = {os.path.join("p2p", f) for f in P2P_TRANSPORT}
    assert files <= rel
    for f in files:
        assert "msgpack" not in set(_imported_modules(os.path.join(PACKAGE, f))), f


P2P_NODE = ("sync.py", "operations.py", "rspc.py", "pairing.py", "manager.py", "loopback.py")


def test_the_scan_covers_the_node_p2p():
    """The node's p2p (owned copies of the JAX modules but the work
    plane, which waits for the continuum stages) is scanned too, with
    the federation's peer half; none imports the `msgpack` package."""
    rel = {os.path.relpath(p, PACKAGE) for p in _port_sources()}
    files = {os.path.join("p2p", f) for f in P2P_NODE}
    assert files | {os.path.join("telemetry", "federation.py")} <= rel
    assert os.path.join("p2p", "work.py") not in rel
    for f in files:
        assert "msgpack" not in set(_imported_modules(os.path.join(PACKAGE, f))), f


def test_p2p_imports_without_cryptography():
    """With `cryptography` absent the p2p package still imports, as the
    JAX package's does (identities fall back to the pure-Python
    ed25519), while every encrypted channel refuses: a keyed cipher, a
    handshake state and a client handshake raise NoiseError; nothing
    falls back to plaintext."""
    modules = ["spacedrive_tpu_torch.p2p" + ("" if f == "__init__.py" else "." + f[:-3])
               for f in P2P_TRANSPORT + P2P_NODE]
    code = (
        "import asyncio, importlib, sys\n"
        "sys.modules['cryptography'] = None\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "from spacedrive_tpu_torch.p2p import Identity, noise, transport\n"
        "ident = Identity()\n"
        "assert ident.to_remote_identity().verify(ident.sign(b'm'), b'm')\n"
        "refused = []\n"
        "for attempt in (lambda: noise.CipherState(b'k' * 32),\n"
        "                lambda: noise.HandshakeState(True, None),\n"
        "                lambda: asyncio.run(transport._client_handshake(None, None, ident, None))):\n"
        "    try:\n"
        "        attempt()\n"
        "    except noise.NoiseError:\n"
        "        refused.append(1)\n"
        "assert len(refused) == 3, refused\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"

def test_sklearn_only_inside_digits_demo_dataset():
    """scikit-learn, which the card's machine lacks, is imported by one
    function of the port, lazily: `models/train.py`'s
    `digits_demo_dataset`, as in the JAX module."""
    def sklearn_imports(node):
        return [n for n in ast.walk(node)
                if isinstance(n, (ast.Import, ast.ImportFrom))
                and any(m.split(".")[0] == "sklearn" for m in (
                    [a.name for a in n.names] if isinstance(n, ast.Import) else [n.module or ""]))]

    found = {}
    for path in _port_sources():
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), path)
        rel = os.path.relpath(path, ROOT)
        total = len(sklearn_imports(tree))
        inside = {fn.name: len(sklearn_imports(fn)) for fn in ast.walk(tree)
                  if isinstance(fn, ast.FunctionDef) and sklearn_imports(fn)}
        if total:
            found[rel] = (total, inside)
    train = os.path.join("spacedrive_tpu_torch", "models", "train.py")
    assert found == {train: (1, {"digits_demo_dataset": 1})}


def test_import_builds_nothing_and_needs_no_cuda():
    """Import every module of the port in a fresh interpreter with CUDA
    hidden: no jax module loads, no kernel builds, nothing compiles."""
    modules = []
    for path in _port_sources():
        rel = os.path.relpath(path, ROOT)
        if rel in ("chip_smoke.py", "profile_library.py") or rel.endswith("__main__.py"):
            continue
        modules.append(rel[:-3].replace(os.sep, ".").removesuffix(".__init__"))
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "from spacedrive_tpu_torch.ops import blake3_cuda\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "assert 'sklearn' not in sys.modules\n"
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
