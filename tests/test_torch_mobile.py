"""Port twins of tests/test_mobile.py: the port's mobile core bridge
(`spacedrive_tpu_torch/mobile.py`), the embedded-host surface the
platform shims call (ref:apps/mobile/modules/sd-core/core/src/lib.rs),
its Node on the CPU (``device="cpu"``, the bridge's keyword).

Driven exactly the way JNI/ObjC would: `handle_core_msg` invoked from a
FOREIGN thread (this test thread) with string payloads and callbacks,
`spawn_core_event_listener` for the subscription channel — lazy core
init on first message, batching, subscriptions with stop, error
echoes, and full teardown/restart.
"""

import json
import threading

import pytest

from spacedrive_tpu_torch import mobile


@pytest.fixture
def bridge(tmp_path):
    data_dir = str(tmp_path / "core")
    yield data_dir
    mobile.shutdown_core()


def _call(query, data_dir, timeout=30.0):
    """One handle_core_msg round trip, foreign-thread style."""
    done = threading.Event()
    box = {}

    def cb(payload):
        box["resp"] = json.loads(payload)
        done.set()

    mobile.handle_core_msg(
        query if isinstance(query, str) else json.dumps(query),
        data_dir, cb, device="cpu")
    assert done.wait(timeout), "bridge never called back"
    return box["resp"]


def test_lazy_init_single_and_batch(bridge):
    # first message boots the core (ref:lib.rs NODE lazy init)
    [resp] = _call({"id": 1, "method": "nodeState", "params": {}}, bridge)
    assert resp["id"] == 1
    assert resp["result"]["type"] == "response"
    assert resp["result"]["data"]["name"]

    # batch: create a library, then list — order preserved
    r1, r2 = _call([
        {"id": 2, "method": "library.create", "params": {"arg": {"name": "m"}}},
        {"id": 3, "method": "library.list", "params": {}},
    ], bridge)
    assert r1["result"]["type"] == "response"
    lib_id = r1["result"]["data"]["uuid"]
    assert [l["uuid"] for l in r2["result"]["data"]] == [lib_id]

    # library-scoped call with params.library_id
    [r4] = _call({"id": 4, "method": "search.paths",
                  "params": {"arg": {"filter": {}},
                             "library_id": lib_id}}, bridge)
    assert r4["result"]["type"] == "response"
    assert r4["result"]["data"]["nodes"] == []


def test_error_shapes(bridge):
    [r] = _call({"id": 9, "method": "no.such.proc", "params": {}}, bridge)
    assert r["result"]["type"] == "error"
    assert r["result"]["data"]["code"] == 404

    # undecodable input echoes the query in the error, like the
    # reference's callback(Err(query))
    [r] = _call("{not json", bridge)
    assert r["result"]["type"] == "error"
    assert "{not json" in r["result"]["data"]["message"]


def test_subscription_event_channel_and_stop(bridge):
    events = []
    got_event = threading.Event()

    def on_event(payload):
        events.append(json.loads(payload))
        got_event.set()

    mobile.spawn_core_event_listener(on_event)

    [r] = _call({"id": 1, "method": "library.create",
                 "params": {"arg": {"name": "sub"}}}, bridge)
    lib_id = r["result"]["data"]["uuid"]

    [r] = _call({"id": "sub-1", "method": "invalidation.listen",
                 "params": {}}, bridge)
    assert r["result"]["type"] == "started"

    # a mutation fires an invalidation → arrives on the EVENT channel
    [r] = _call({"id": 2, "method": "tags.create",
                 "params": {"arg": {"name": "t"}, "library_id": lib_id}},
                bridge)
    assert r["result"]["type"] == "response"
    assert got_event.wait(15), "subscription event never arrived"
    ev = events[0]
    assert ev["id"] == "sub-1"
    assert ev["result"]["type"] == "event"
    assert ev["result"]["data"]["key"]

    # stop → no further events for this id
    [r] = _call({"id": 3, "method": "subscriptionStop",
                 "params": {"id": "sub-1"}}, bridge)
    assert r["result"]["type"] == "response"
    before = len(events)
    _call({"id": 4, "method": "tags.create",
           "params": {"arg": {"name": "t2"}, "library_id": lib_id}}, bridge)
    import time

    time.sleep(0.5)
    assert len(events) == before, "events after subscriptionStop"


def test_subscription_requires_listener(bridge):
    [r] = _call({"id": "s", "method": "invalidation.listen", "params": {}},
                bridge)
    assert r["result"]["type"] == "error"
    assert "event listener" in r["result"]["data"]["message"]


def test_shutdown_and_reinit(tmp_path):
    d1 = str(tmp_path / "one")
    [r] = _call({"id": 1, "method": "nodeState", "params": {}}, d1)
    assert r["result"]["type"] == "response"
    mobile.shutdown_core()
    # a fresh init after teardown works (app relaunch)
    d2 = str(tmp_path / "two")
    [r] = _call({"id": 1, "method": "nodeState", "params": {}}, d2)
    assert r["result"]["type"] == "response"
    mobile.shutdown_core()


def test_responses_equal_jax(tmp_path):
    """The same batch through both packages' bridges: the same response
    shapes, ids, types and data after the library id is replaced."""
    from spacedrive_tpu import mobile as jmobile

    batch = [
        {"id": 1, "method": "library.create", "params": {"arg": {"name": "eq"}}},
        {"id": "x", "method": "no.such", "params": {}},
        {"id": 2, "method": "library.list", "params": {}},
        "not-an-object",
        {"id": [1], "method": "nodeState"},
    ]

    def call(mod, data_dir, **kw):
        done = threading.Event()
        box = {}

        def cb(payload):
            box["resp"] = json.loads(payload)
            done.set()

        mod.handle_core_msg(json.dumps(batch), data_dir, cb, **kw)
        assert done.wait(60), "bridge never called back"
        return box["resp"]

    try:
        got = call(mobile, str(tmp_path / "p"), device="cpu")
    finally:
        mobile.shutdown_core()
    try:
        want = call(jmobile, str(tmp_path / "j"))
    finally:
        jmobile.shutdown_core()

    def norm(resp):
        lid = resp[0]["result"]["data"]["uuid"]
        text = json.dumps(resp).replace(lid, "<lib>")
        doc = json.loads(text)
        for lib in doc[2]["result"]["data"]:
            lib["instance_id"] = bool(lib.get("instance_id"))
            for k in list(lib):
                if "date" in k or k in ("instance_pub_id", "instance_public_key", "config"):
                    lib[k] = bool(lib[k])
        return doc

    assert norm(got) == norm(want)
