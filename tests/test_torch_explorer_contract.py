"""Port twins of tests/test_explorer_contract.py: the explorer's
contract, held against the port's API host and its own copy of the
assets (`spacedrive_tpu_torch/api/static/`).

Each case runs the JAX test's own body with its server factory swapped
for a port `Node(device="cpu")` and `start_api()`: the assets and the
generated client's shape, the six main flows, quick preview and drag and
drop, ephemeral browsing, network and keys, the third ring of flows and
the wrong-master-password refusal, all over the HTTP and websocket
frames `client.js` sends, driven by aiohttp's client (a mixed case: it
skips without `aiohttp`). The port's copy of the assets is also held
byte for byte to the JAX package's.
"""

import contextlib
import os
import signal

import pytest

aiohttp = pytest.importorskip("aiohttp")

import test_explorer_contract as jcontract  # noqa: E402

PORT_STATIC = os.path.join(os.path.dirname(__file__), os.pardir, "spacedrive_tpu_torch",
                           "api", "static")
JAX_STATIC = os.path.join(os.path.dirname(__file__), os.pardir, "spacedrive_tpu", "api",
                          "static")


async def _port_server(tmp_path):
    from spacedrive_tpu_torch.node.node import Node

    node = Node(str(tmp_path / "node"), device="cpu", with_labeler=False)
    node.config.config.p2p.enabled = False
    await node.start()
    port = await node.start_api()
    return node, f"http://127.0.0.1:{port}"


@pytest.fixture
def port_server(monkeypatch):
    monkeypatch.setattr(jcontract, "_fresh_server", _port_server)


CASES = [
    "test_explorer_assets_and_client_shape",
    "test_explorer_six_flows",
    "test_explorer_quickpreview_and_dnd",
    "test_explorer_ephemeral_network_keys",
    "test_explorer_ring3_flows",
    "test_keys_wrong_master_password_refused",
]


@contextlib.contextmanager
def _deadline(seconds: int):
    """A timeout around a JAX body that runs its own event loop."""
    def expire(signum, frame):
        raise TimeoutError(f"case ran past {seconds} s")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, previous)


@pytest.mark.parametrize("case", CASES)
def test_explorer_contract_on_the_port(case, tmp_path, port_server):
    with _deadline(120):
        getattr(jcontract, case)(tmp_path)


def test_port_assets_are_the_jax_assets():
    def tree(root):
        out = {}
        for d, _dirs, files in os.walk(root):
            for f in files:
                if f.endswith((".pyc",)):
                    continue
                p = os.path.join(d, f)
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, root)] = fh.read()
        return out

    got, want = tree(PORT_STATIC), tree(JAX_STATIC)
    assert sorted(got) == sorted(want)
    assert got == want
