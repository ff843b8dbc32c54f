"""The port's HTTP API host (`spacedrive_tpu_torch/api/server.py` on the
port's own HTTP/1.1 and websocket layer) against the JAX package's
`ApiServer` on `aiohttp`.

- side by side: a JAX `Node(use_device=False)` and a port
  `Node(device="cpu")`, each over its own copy of one seeded corpus,
  both gated, each serving `start_api()` on 127.0.0.1; the same requests
  from the port's client to both servers give the same statuses, the
  same `Content-Type`, `X-SD-Cache`, `Retry-After`, `Content-Range` and
  `Accept-Ranges`, and the same JSON bodies after `_norm` (corpus root,
  data dir and library id as placeholders; `search.semantic` scores
  within 1e-5): the routes of tests/test_api.py:410 (explorer, client,
  rspc, custom URIs, websocket), the host guard of :524, byte ranges
  (206, suffix ranges, 416 with `bytes */size`), websocket messages for
  a query, a mutation and a subscription, sheds from a budget made full
  on purpose, `GET /search`, thumbnails, and `SD_SERVE_GATE=0`, whose
  bodies equal the gated ones without `X-SD-Cache`;
- port twins of tests/test_api_surface.py (its body, aiohttp's client
  against the port's server), tests/test_observability_smoke.py,
  test_attrib.py::test_rspc_exec_feeds_interactive_request_seconds, the
  HTTP halves of test_telemetry.py's dry-run index pass and
  test_profile.py's smoke pass, and test_mesh_observability.py's
  `GET /mesh` over two port Nodes on the loopback duplex;
- the CLI: `serve` in a child process, `serve-status` and the `--url`
  commands against a port node.

Every case binds 127.0.0.1 and runs under its own timeout.
"""

import asyncio
import json
import os
import shutil
import subprocess
import sys
import uuid

import pytest

import spacedrive_tpu.telemetry as jtelemetry
from spacedrive_tpu_torch import cli, telemetry
from spacedrive_tpu_torch.utils import http

from test_torch_api import _norm, _scanned_node, make_corpus

HEADERS = ("Content-Type", "X-SD-Cache", "Retry-After", "Content-Range", "Accept-Ranges",
           "Cache-Control", "Content-Disposition", "X-Prometheus-Format")


@pytest.fixture(autouse=True)
def _clean_telemetry(monkeypatch):
    monkeypatch.delenv("SD_SERVE_GATE", raising=False)
    telemetry.reset()
    jtelemetry.reset()
    yield
    telemetry.reset()
    jtelemetry.reset()


def _run(coro, timeout: float = 90.0):
    async def bounded():
        async with asyncio.timeout(timeout):
            return await coro

    return asyncio.run(bounded())


class _Side:
    """One package's served node and what `_norm` replaces."""

    def __init__(self, pkg, node, lib, loc_id, base, corpus):
        self.pkg, self.node, self.lib, self.loc_id, self.base = pkg, node, lib, loc_id, base
        self.corpus = corpus
        self.lid = str(lib.id)
        self.roots = [(os.path.realpath(corpus), "<corpus>"), (corpus, "<corpus>"),
                      (node.data_dir, "<data>"), (self.lid, "<lib>")]


async def _served(tmp_path, pkgs=("jax", "port")):
    sides = {}
    for pkg in pkgs:
        corpus = make_corpus(str(tmp_path / f"corpus-{pkg}"))
        node, lib, loc_id = await _scanned_node(pkg, str(tmp_path / pkg), corpus)
        await node.thumbnailer.wait_library_batch(str(lib.id))
        port = await node.start_api()
        sides[pkg] = _Side(pkg, node, lib, loc_id, f"http://127.0.0.1:{port}", corpus)
    return sides


async def _shutdown(sides):
    for side in sides.values():
        await side.node.shutdown()


def _answer(resp, roots):
    """(status, the compared headers, the body: normalised JSON or bytes)."""
    heads = {h: resp.headers.get(h) for h in HEADERS if resp.headers.get(h) is not None}
    ctype = resp.headers.get("Content-Type") or ""
    # the generated client names the module that generated it
    body = resp.body.replace(b"spacedrive_tpu_torch.api.client_gen",
                             b"spacedrive_tpu.api.client_gen")
    if "json" in ctype and body:
        body = _norm(json.loads(body), roots)
    return resp.status, heads, body


async def _ask(client, side, method, path, **kw):
    resp = await client.request(method, side.base + path, **kw)
    return _answer(resp, side.roots)


def _close(a, b, tol=1e-5):
    """Equal, but floats within `tol` (semantic scores)."""
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_close(a[k], b[k], tol) for k in a)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(_close(x, y, tol) for x, y in zip(a, b))
    if isinstance(a, float) or isinstance(b, float):
        return abs(a - b) <= tol
    return a == b


# --- side by side: tests/test_api.py:410 and :524 -------------------------------------


def test_http_server_and_custom_uri_beside_jax(tmp_path):
    async def run():
        sides = await _served(tmp_path)
        client = http.HttpClient()
        try:
            got = {}
            for pkg, side in sides.items():
                out = got[pkg] = []
                out.append(await _ask(client, side, "GET", "/"))
                out.append(await _ask(client, side, "GET", "/rspc/client.js"))
                out.append(await _ask(client, side, "GET", "/rspc/manifest"))
                out.append(await _ask(client, side, "POST", "/rspc/buildInfo", json={}))
                for _ in range(2):  # miss, then hit
                    out.append(await _ask(client, side, "POST", "/rspc/search.paths",
                                          json={"library_id": side.lid, "arg": {"take": 5}}))
                out.append(await _ask(client, side, "POST", "/rspc/unknown.key", json={}))
                out.append(await _ask(client, side, "POST", "/rspc/tags.list",
                                      data=b"{not json"))
                out.append(await _ask(client, side, "POST", "/rspc/tags.create",
                                      json={"library_id": side.lid, "arg": {"name": "t"}}))
                out.append(await _ask(client, side, "POST", "/rspc/search.paths",
                                      json={"library_id": side.lid, "arg": {"take": 5}}))
                out.append(await _ask(client, side, "POST", "/rspc/tags.list", json={
                    "library_id": side.lid.upper()}))
                out.append(await _ask(client, side, "POST", "/rspc/locations.relink",
                                      json={"library_id": side.lid, "arg": "just-a-string"}))
                url = f"/spacedrive/file/{side.lid}/{side.loc_id}/beta.bin"
                out.append(await _ask(client, side, "GET", url))
                out.append(await _ask(client, side, "GET", url,
                                      headers={"Range": "bytes=100-199"}))
                out.append(await _ask(client, side, "GET",
                                      f"/spacedrive/file/{side.lid}/{side.loc_id}/../../x"))
                out.append(await _ask(client, side, "GET",
                                      f"/spacedrive/file/{side.lid}/{side.loc_id}/nope.bin"))
                out.append(await _ask(client, side, "GET",
                                      f"/spacedrive/file/not-a-uuid/{side.loc_id}/beta.bin"))
                out.append(await _ask(client, side, "GET", "/static/js/app.js"))
                out.append(await _ask(client, side, "GET", "/static/nope.js"))
                out.append(await _ask(client, side, "GET", "/static/explorer.html.bak"))
                out.append(await _ask(client, side, "GET", "/no/such/route"))
                out.append(await _ask(client, side, "DELETE", "/health"))
            assert len(got["port"]) == len(got["jax"])
            for i, (p, j) in enumerate(zip(got["port"], got["jax"])):
                assert p == j, i
            page = got["port"][0]
            assert page[0] == 200 and b"spacedrive-tpu explorer" in page[2]
            assert [a[1].get("X-SD-Cache") for a in got["port"][4:6]] == ["miss", "hit"]
            ranged = got["port"][13]
            assert ranged[0] == 206 and ranged[1]["Content-Range"] == "bytes 100-199/2000"
            assert ranged[2] == got["port"][12][2][100:200]
        finally:
            await client.close()
            await _shutdown(sides)

    _run(run())


def test_host_header_guard_beside_jax(tmp_path):
    async def run():
        sides = await _served(tmp_path)
        client = http.HttpClient()
        try:
            got = {}
            for pkg, side in sides.items():
                port = side.base.rsplit(":", 1)[1]
                local = os.path.join(side.corpus, "alpha.txt")
                rows = got[pkg] = []
                rows.append(await _ask(client, side, "GET",
                                       f"/spacedrive/local?path={os.path.abspath(__file__)}",
                                       headers={"Host": "attacker.example.com"}))
                rows.append(await _ask(client, side, "POST", "/rspc/buildInfo", json={},
                                       headers={"Host": "attacker.example.com:1234"}))
                for h in (f"127.0.0.1:{port}", f"localhost:{port}", "127.0.0.1",
                          "[::1]:8080", "LOCALHOST.", "evil.example"):
                    rows.append((await _ask(client, side, "POST", "/rspc/buildInfo", json={},
                                            headers={"Host": h}))[0])
                rows.append(await _ask(client, side, "GET", f"/spacedrive/local?path={local}"))
                rows.append(await _ask(client, side, "GET", "/spacedrive/local?path=rel/x"))
            assert got["port"] == got["jax"]
            assert got["port"][0][:1] == (403,) and got["port"][0][2] == b"bad host"
            assert got["port"][2:8] == [200, 200, 200, 200, 200, 403]
        finally:
            await client.close()
            await _shutdown(sides)

    _run(run())


RANGES = [None, "bytes=100-199", "bytes=0-0", "bytes=-10", "bytes=-5000", "bytes=1990-",
          "bytes=1999-5000", "bytes=2000-", "bytes=5000-6000", "bytes=10-5", "bytes=abc",
          "bytes=0-1,5-6", "items=0-1"]


def test_byte_ranges_beside_jax(tmp_path):
    async def run():
        sides = await _served(tmp_path)
        client = http.HttpClient()
        try:
            got = {}
            for pkg, side in sides.items():
                rows = got[pkg] = []
                for rng in RANGES:
                    headers = {"Range": rng} if rng else None
                    for path in (f"/spacedrive/file/{side.lid}/{side.loc_id}/beta.bin",
                                 "/spacedrive/local?path="
                                 + os.path.join(side.corpus, "nested", "gamma.txt")):
                        rows.append((rng, await _ask(client, side, "GET", path,
                                                     headers=headers)))
            assert got["port"] == got["jax"]
            with open(os.path.join(sides["port"].corpus, "beta.bin"), "rb") as f:
                data = f.read()
            by = {(rng, i % 2): a for i, (rng, a) in enumerate(got["port"])}
            assert by[("bytes=-10", 0)][2] == data[-10:]
            assert by[("bytes=2000-", 0)][:2] == (416, {
                "Content-Type": "application/octet-stream",
                "Content-Range": "bytes */2000", "Accept-Ranges": "bytes"})
            assert by[(None, 0)][1]["Accept-Ranges"] == "bytes"
        finally:
            await client.close()
            await _shutdown(sides)

    _run(run())


def test_websocket_query_mutation_subscription_beside_jax(tmp_path):
    async def run():
        sides = await _served(tmp_path)
        try:
            got = {}
            for pkg, side in sides.items():
                ws = await http.ws_connect(side.base + "/rspc/ws")
                out = got[pkg] = []

                async def ask(msg, n=1):
                    await ws.send_str(json.dumps(msg))
                    frames = []
                    for _ in range(n):
                        frames.append(json.loads((await ws.receive(timeout=20)).data))
                    return sorted((_norm(f, side.roots) for f in frames),
                                  key=lambda f: json.dumps(f, sort_keys=True))

                out += await ask({"id": "1", "type": "query", "key": "buildInfo"})
                out += await ask({"id": "2", "type": "query", "key": "search.paths",
                                  "library_id": side.lid, "arg": {"take": 3}})
                out += await ask({"id": "3", "type": "query", "key": "no.such"})
                await ws.send_str(json.dumps({"id": "s", "type": "subscriptionAdd",
                                              "key": "invalidation.listen"}))
                # a round trip, so the subscription listens before the
                # mutation below
                out += await ask({"id": "1b", "type": "query", "key": "buildInfo"})
                # the mutation's answer and the invalidation it fires
                out += await ask({"id": "4", "type": "mutation", "key": "tags.create",
                                  "library_id": side.lid, "arg": {"name": "ws"}}, n=2)
                out += await ask({"id": "5", "type": "subscriptionAdd", "key": "no.such"})
                await ws.send_str(json.dumps({"id": "s", "type": "subscriptionRemove"}))
                out += await ask({"id": "6", "type": "mutation", "key": "tags.create",
                                  "library_id": side.lid, "arg": {"name": "quiet"}})
                await ws.send_bytes(b"\x00binary frames are ignored")
                out += await ask({"id": "7", "type": "query", "key": "tags.list",
                                  "library_id": side.lid})
                assert await ws.close()
                assert ws.close_code == 1000
            assert got["port"] == got["jax"]
            ids = [m.get("id") for m in got["port"]]
            assert ids == ["1", "2", "3", "1b", "s", "4", "5", "6", "7"]
            assert got["port"][4]["event"]["key"] == "tags.list"
        finally:
            await _shutdown(sides)

    _run(run())


def _fill_interactive(node, policy_cls, budget_cls):
    """Give the node's gate a policy whose interactive class queues
    nothing, and hold its whole budget: every further interactive
    request sheds at once."""
    gate = node.serve.gate
    pol = policy_cls()
    pol.budgets["interactive"] = budget_cls(max_inflight=2, max_queue=0, queue_deadline_s=0.0)
    gate._policy = pol
    release = asyncio.Event()

    async def hold(entered):
        async with gate.admit("interactive"):
            entered.set()
            await release.wait()

    events = [asyncio.Event() for _ in range(2)]
    tasks = [asyncio.ensure_future(hold(e)) for e in events]
    return release, tasks, events


def test_sheds_with_retry_after_beside_jax(tmp_path):
    from spacedrive_tpu.serve.policy import ClassBudget as JBudget
    from spacedrive_tpu.serve.policy import ServePolicy as JPolicy
    from spacedrive_tpu_torch.serve.policy import ClassBudget, ServePolicy

    async def run():
        sides = await _served(tmp_path)
        client = http.HttpClient()
        held = []
        try:
            got = {}
            for pkg, side in sides.items():
                cls = (JPolicy, JBudget) if pkg == "jax" else (ServePolicy, ClassBudget)
                release, tasks, events = _fill_interactive(side.node, *cls)
                held.append((release, tasks))
                for e in events:
                    await e.wait()
                rows = got[pkg] = []
                image = os.path.join(side.corpus, "nested", "grad0.png")
                rows.append(await _ask(client, side, "POST", "/rspc/search.paths", json={
                    "library_id": side.lid, "arg": {"take": 1}}))
                rows.append(await _ask(client, side, "GET",
                                       f"/search?library_id={side.lid}&q={image}"))
                rows.append(await _ask(client, side, "GET", "/mesh"))
                rows.append(await _ask(client, side, "GET", "/rspc/manifest"))
                health = await _ask(client, side, "GET", "/health")
                rows.append((health[0], health[2]["subsystems"]["serve"]["status"]))
                metrics = (await client.request("GET", side.base + "/metrics")).text()
                rows.append([line for line in metrics.splitlines()
                             if line.startswith("sd_gate_requests_total{")
                             and 'klass="interactive"' in line])
                rows.append((await client.request("POST", side.base + "/rspc/telemetry.serve",
                                                  json={})).json()["result"]["gate"]["classes"])
                release.set()
                await asyncio.gather(*tasks)
            assert got["port"] == got["jax"]
            shed = got["port"][0]
            assert shed[0] == 429 and shed[1]["Retry-After"] == "1"
            assert shed[2] == {"error": "SHED: queue full", "code": 429}
            assert got["port"][2][0] == 429 and got["port"][2][2]["error"] == "SHED"
            assert got["port"][4] == (200, "degraded")
        finally:
            for release, tasks in held:
                release.set()
                await asyncio.gather(*tasks, return_exceptions=True)
            await client.close()
            await _shutdown(sides)

    _run(run())


def test_search_and_thumbnails_beside_jax(tmp_path):
    async def run():
        sides = await _served(tmp_path)
        client = http.HttpClient()
        try:
            got = {}
            for pkg, side in sides.items():
                rows = got[pkg] = []
                image = os.path.join(side.corpus, "nested", "grad1.png")
                for _ in range(2):  # miss, then hit
                    rows.append(await _ask(client, side, "GET",
                                           f"/search?library_id={side.lid}&q={image}&take=3"))
                rows.append(await _ask(client, side, "GET", f"/search?library_id={side.lid}"))
                rows.append(await _ask(client, side, "GET",
                                       f"/search?library_id={side.lid}&q=x&take=many"))
                rows.append(await _ask(client, side, "GET",
                                       f"/search?library_id={uuid.UUID(int=7)}&q={image}"))
                cas = side.lib.db.find_one("file_path", name="grad1")["cas_id"]
                store = side.node.thumbnailer.store
                ns = str(side.lib.id)
                disk = store.path_for(ns, cas)
                shard = os.path.basename(os.path.dirname(disk))
                for _ in range(2):
                    resp = await client.request(
                        "GET", f"{side.base}/spacedrive/thumbnail/{ns}/{shard}/{cas}.webp")
                    with open(disk, "rb") as f:
                        assert resp.body == f.read()
                    rows.append(_answer(resp, side.roots)[:2])
                rows.append(await _ask(client, side, "GET",
                                       f"/spacedrive/thumbnail/{ns}/{shard}/{cas}.png"))
                rows.append(await _ask(client, side, "GET",
                                       f"/spacedrive/thumbnail/{ns}/{shard}/0000.webp"))
            port_rows, jax_rows = got["port"], got["jax"]
            assert len(port_rows) == len(jax_rows)
            for i, (p, j) in enumerate(zip(port_rows, jax_rows)):
                assert p[:2] == j[:2], i
                assert _close(p[2], j[2]) if len(p) > 2 else True, i
            first = port_rows[0][2]["result"]
            assert first["resolved"] and first["nodes"][0]["name"] == "grad1"
            assert first["nodes"][0]["score"] == pytest.approx(1.0, abs=1e-4)
            assert [r[1].get("X-SD-Cache") for r in port_rows[:2]] == ["miss", "hit"]
            assert [r[1]["X-SD-Cache"] for r in port_rows[5:7]] == ["miss", "hit"]
        finally:
            await client.close()
            await _shutdown(sides)

    _run(run())


def test_serve_gate_0_equals_gated_beside_jax(tmp_path, monkeypatch):
    """The same requests gated and with SD_SERVE_GATE=0: equal bodies on
    both packages, and no X-SD-Cache header without the gate."""
    def script(side):
        return [("POST", "/rspc/search.paths", {"json": {"library_id": side.lid,
                                                         "arg": {"take": 4}}}),
                ("POST", "/rspc/tags.list", {"json": {"library_id": side.lid}}),
                ("POST", "/rspc/labels.list", {"json": {"library_id": side.lid}}),
                ("GET", "/search?library_id=" + side.lid + "&q="
                 + os.path.join(side.corpus, "nested", "grad2.png"), {}),
                ("POST", "/rspc/buildInfo", {"json": {}})]

    async def collect():
        sides = await _served(tmp_path / os.environ.get("SD_SERVE_GATE", "1"))
        client = http.HttpClient()
        try:
            out = {}
            for pkg, side in sides.items():
                out[pkg] = [await _ask(client, side, m, p, **kw) for m, p, kw in script(side)]
            return out
        finally:
            await client.close()
            await _shutdown(sides)

    gated = _run(collect())
    monkeypatch.setenv("SD_SERVE_GATE", "0")
    ungated = _run(collect())
    for pkg in ("jax", "port"):
        for g, u in zip(gated[pkg], ungated[pkg]):
            assert "X-SD-Cache" not in u[1]
            assert g[0] == u[0]
            assert _close(g[2], u[2])
    for g, u in zip(gated["port"], gated["jax"]):
        assert g[:2] == u[:2] and _close(g[2], u[2])
    for g, u in zip(ungated["port"], ungated["jax"]):
        assert g[:2] == u[:2] and _close(g[2], u[2])


# --- port twins ----------------------------------------------------------------------


def test_every_uncovered_procedure_answers_without_500(tmp_path, monkeypatch):
    """tests/test_api_surface.py's body against a port server (aiohttp's
    client and websocket frames)."""
    pytest.importorskip("aiohttp")
    import test_api_surface as jsurface

    async def port_server(tmp):
        from spacedrive_tpu_torch.node.node import Node

        node = Node(str(tmp / "node"), device="cpu", with_labeler=False)
        node.config.config.p2p.enabled = False
        await node.start()
        port = await node.start_api()
        return node, f"http://127.0.0.1:{port}"

    from test_torch_explorer_contract import _deadline

    monkeypatch.setattr(jsurface, "_server", port_server)
    with _deadline(120):
        jsurface.test_every_uncovered_procedure_answers_without_500(tmp_path)


PLANTED_KEY = "sk-live-planted-0123456789abcdef"


def test_metrics_trace_and_debug_bundle_end_to_end(tmp_path):
    """tests/test_observability_smoke.py's first case on a port Node."""
    from spacedrive_tpu_torch.node.node import Node
    from spacedrive_tpu_torch.telemetry.events import record_error

    corpus = make_corpus(str(tmp_path / "corpus"))

    async def run():
        node = Node(str(tmp_path / "node"), device="cpu", with_labeler=False)
        node.config.config.p2p.enabled = False
        node.config.config.preferences["cloud_api_token"] = PLANTED_KEY
        node.config.save()
        identity_hex = node.config.config.identity.to_bytes().hex()
        try:
            raise RuntimeError(f"cloud api said 401: bad token {PLANTED_KEY} "
                               f"(id {identity_hex})")
        except RuntimeError as e:
            record_error("excepthook", e)
        await node.start()
        client = http.HttpClient()
        try:
            r = node.router
            lid = (await r.exec(node, "library.create", {"name": "obs-lib"}))["uuid"]
            await r.exec(node, "locations.create", {"path": corpus}, library_id=lid)
            await node.jobs.wait_idle()
            port = await node.start_api()
            base = f"http://127.0.0.1:{port}"
            metrics = await client.request("GET", base + "/metrics")
            trace = await client.request("GET", base + "/trace")
            bundle = await client.request("POST", base + "/rspc/telemetry.debug_bundle",
                                          json={})
            assert (metrics.status, trace.status, bundle.status) == (200, 200, 200)
            assert metrics.headers["X-Prometheus-Format"] == "0.0.4"
            assert trace.headers["Content-Disposition"] == "inline; filename=sd-trace.json"
            return metrics.text(), trace.json(), bundle.json()["result"], identity_hex
        finally:
            await client.close()
            await node.shutdown()

    metrics_text, trace_doc, bundle, identity_hex = _run(run())
    assert "sd_tasks_dispatched_total" in metrics_text
    assert "sd_identifier_files_total" in metrics_text
    spans = [e for e in trace_doc["traceEvents"] if e.get("ph") == "X"]
    names = {e["name"] for e in spans}
    assert {"walk", "identify.hash", "task.dispatch"} <= names, names
    walk = next(e for e in spans if e["name"] == "walk")
    hash_ev = next(e for e in spans if e["name"] == "identify.hash")
    assert walk["args"]["trace_id"] == hash_ev["args"]["trace_id"]
    assert bundle["node_config"] and bundle["metrics"] and bundle["versions"]
    assert bundle["events"].get("jobs")
    assert bundle["trace_summary"]["spans"] > 0
    doc = json.dumps(bundle)
    assert PLANTED_KEY not in doc and identity_hex not in doc
    assert bundle["node_config"]["identity"] == "[redacted]"
    assert bundle["node_config"]["preferences"]["cloud_api_token"] == "[redacted]"
    assert any("bad token [redacted]" in e["fields"]["message"]
               for e in bundle["events"]["errors"])


def test_slo_attribution_and_profile_surfaces_over_http(tmp_path, monkeypatch):
    """The HTTP halves of tests/test_observability_smoke.py's SLO smoke,
    test_profile.py's smoke pass and test_telemetry.py's dry-run index
    pass: /attrib, telemetry.slo, telemetry.attrib, /profile (JSON and
    folded), /trace, /metrics and telemetry.snapshot of a port Node
    after a scan."""
    from spacedrive_tpu_torch.node.node import Node

    monkeypatch.setenv("SD_SLO_FILES_PER_S", "0.001")
    monkeypatch.setenv("SD_SLO_INTERACTIVE_P99_MS", "60000")
    corpus = make_corpus(str(tmp_path / "corpus"))

    async def run():
        node = Node(str(tmp_path / "node"), device="cpu", with_labeler=False)
        node.config.config.p2p.enabled = False
        await node.start()
        client = http.HttpClient()
        try:
            r = node.router
            lid = (await r.exec(node, "library.create", {"name": "slo-lib"}))["uuid"]
            await r.exec(node, "locations.create", {"path": corpus}, library_id=lid)
            await node.jobs.wait_idle()
            node.history.sample()
            port = await node.start_api()
            base = f"http://127.0.0.1:{port}"
            out = {}
            for path in ("/attrib", "/profile", "/profile?format=folded", "/trace",
                         "/metrics", "/tenants", "/attrib?refresh=1"):
                resp = await client.request("GET", base + path)
                assert resp.status == 200, path
                out[path] = resp
            for key in ("telemetry.slo", "telemetry.attrib", "telemetry.snapshot"):
                resp = await client.request("POST", f"{base}/rspc/{key}", json={})
                assert resp.status == 200, key
                out[key] = resp.json()["result"]
            return out
        finally:
            await client.close()
            await node.shutdown()

    out = _run(run())
    report = out["/attrib"].json()
    assert "error" not in report and report["spans"] > 0
    assert sum(report["buckets"].values()) == pytest.approx(report["wall_seconds"], abs=1e-4)
    assert set(report["buckets"]) == {"device", "host_cpu", "link", "queue_wait", "gap"}
    assert out["telemetry.attrib"]["trace_id"] == report["trace_id"]
    assert {s["name"] for s in out["telemetry.slo"]["slos"]} == {
        "interactive_p99", "sync_lag", "pass_throughput", "protected_sheds", "rss_growth",
        "fd_growth", "tenant_fairness"}
    assert out["telemetry.slo"]["status"] in ("ok", "no_data")
    prof = out["/profile"].json()
    assert {"samples", "states", "frame_groups"} <= set(prof)
    assert out["/profile?format=folded"].headers["Content-Type"] == "text/plain; charset=utf-8"
    assert "/" not in "".join(line.rsplit(" ", 1)[0]
                              for line in out["/profile?format=folded"].text().splitlines())
    assert out["/trace"].json()["traceEvents"]
    metrics = out["/metrics"].text()
    for family in ("sd_job_phase_seconds", "sd_identifier_files_total",
                   "sd_serve_request_seconds", "sd_gate_requests_total"):
        assert family in metrics, family
    assert out["telemetry.snapshot"]["metrics"]["sd_job_phase_seconds"]["series"]
    assert "surfaces" in out["/tenants"].json()


def test_rspc_exec_feeds_interactive_request_seconds(tmp_path):
    """test_attrib.py:393's twin: the rspc surface records the
    interactive class's request latency."""
    from spacedrive_tpu_torch.node.node import Node
    from spacedrive_tpu_torch.telemetry import histogram_recent

    async def run():
        node = Node(str(tmp_path / "rspc-node"), device="cpu", with_labeler=False)
        node.config.config.p2p.enabled = False
        assert node.serve is not None
        try:
            await node.router.exec(node, "library.list")
        finally:
            await node.shutdown()

    _run(run())
    assert histogram_recent("sd_serve_request_seconds", klass="interactive")


def test_two_node_mesh_view_over_http(tmp_path):
    """test_mesh_observability.py:497's GET /mesh and /health over two
    port Nodes on the loopback duplex: alpha's view holds beta, fresh."""
    from spacedrive_tpu_torch.p2p.loopback import make_mesh_pair

    async def run():
        a, b, lib_a, lib_b, _tasks = await make_mesh_pair(tmp_path)
        client = http.HttpClient()
        try:
            a.p2p.federation.refresh_interval = 0.0
            port = await a.start_api()
            base = f"http://127.0.0.1:{port}"
            mesh = await client.request("GET", base + "/mesh")
            health = await client.request("GET", base + "/health")
            again = await client.request("GET", base + "/mesh?refresh=0")
            assert mesh.status == 200 and health.status in (200, 503)
            return mesh.json(), health.json(), again.json(), str(b.p2p.p2p.remote_identity)
        finally:
            await client.close()
            await a.shutdown()
            await b.shutdown()

    mesh, health, again, b_key = _run(run(), timeout=120.0)
    assert "sync" in health["subsystems"] and "serve" in health["subsystems"]
    assert health["subsystems"]["serve"]["status"] == "healthy"
    assert mesh["local"]["v"] == 1 and mesh["local"]["node"]["name"] == "alpha"
    assert b_key in mesh["mesh"]["peers"]
    entry = mesh["mesh"]["peers"][b_key]
    assert entry["stale"] is False and entry["snapshot"]["node"]["name"] == "beta"
    assert b_key in again["mesh"]["peers"]


def test_cli_serve_status_and_url_commands(tmp_path):
    """`serve-status --url` and the --url commands read a port node's
    API; without --url, serve-status reports an idle node's gate."""
    corpus = make_corpus(str(tmp_path / "corpus"))
    outs = {name: str(tmp_path / f"{name}.out") for name in (
        "serve-status", "trace-export", "profile", "attrib", "slo", "tenants", "mesh-status",
        "debug-bundle", "idle")}

    async def run():
        node, lib, _loc = await _scanned_node("port", str(tmp_path / "node"), corpus)
        try:
            port = await node.start_api()
            url = f"http://127.0.0.1:{port}"
            rcs = {}
            for name in ("serve-status", "trace-export", "profile", "tenants", "mesh-status",
                         "debug-bundle", "slo"):
                rcs[name] = await asyncio.to_thread(
                    cli.main, [name, "--url", url, "--out", outs[name]])
            rcs["attrib"] = await asyncio.to_thread(
                cli.main, ["attrib", "--url", url, "--out", outs["attrib"]])
            return rcs
        finally:
            await node.shutdown()

    rcs = _run(run())
    assert rcs == dict.fromkeys(rcs, 0)
    status = json.load(open(outs["serve-status"]))
    assert status["enabled"] is True and set(status) == {"enabled", "gate", "caches"}
    assert json.load(open(outs["trace-export"]))["traceEvents"]
    assert "frame_groups" in json.load(open(outs["profile"]))
    assert json.load(open(outs["mesh-status"]))["local"]["v"] == 1
    assert json.load(open(outs["debug-bundle"]))["node_config"]["identity"] == "[redacted]"
    assert cli.main(["serve-status", "--data-dir", str(tmp_path / "idle"),
                     "--out", outs["idle"]]) == 0
    idle = json.load(open(outs["idle"]))
    assert idle["gate"]["mode"] == "normal"
    assert all(c["inflight"] == 0 for c in idle["gate"]["classes"].values())
    assert cli.main(["serve-status"]) == 1
    assert cli.main(["serve-status", "--url", "http://127.0.0.1:9"]) == 1


def test_cli_serve_runs_a_node_with_its_api(tmp_path):
    """`serve` in a child process: it prints its address, answers
    /health and rspc, and stops on SIGINT."""
    data_dir = str(tmp_path / "srv")
    proc = subprocess.Popen(
        [sys.executable, "-m", "spacedrive_tpu_torch", "serve", "--data-dir", data_dir,
         "--device", "cpu", "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "SD_PROFILE": "0", "SD_HISTORY": "0", "SD_RESOURCES": "0"})
    try:
        line = ""
        for _ in range(50):
            line = proc.stdout.readline()
            if line.startswith("serving on "):
                break
        assert line.startswith("serving on http://127.0.0.1:"), line
        base = line.split()[2]

        async def ask():
            client = http.HttpClient()
            try:
                health = await client.request("GET", base + "/health")
                info = await client.request("POST", base + "/rspc/buildInfo", json={})
                return health.status, info.json()["result"]
            finally:
                await client.close()

        status, info = _run(ask(), timeout=60.0)
        assert status in (200, 503) and info["version"]
    finally:
        proc.send_signal(2)
        try:
            proc.wait(30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(10)
    assert proc.returncode == 0, proc.stderr.read()[-2000:]
