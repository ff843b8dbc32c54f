"""The port's node control plane against the JAX package's: the cases of
tests/test_node.py over both packages.

- identity: from a fixed 32-byte seed both packages give the same
  `RemoteIdentity` string and the same (deterministic ed25519)
  signatures, each verifiable by the other, under the `cryptography`
  package and under the pure-Python fallback both;
- node config: a `node.json` written by either package loads in the
  other with equal fields, and a v1 file migrates to equal v2 files;
- actors, preferences and notifications: the reference cases on both;
  the preference and notification rows are byte-equal whichever package
  wrote them, and each package reads the other's;
- the Node: its lifecycle on "cpu" (the reference case), library
  identity and feature flags, `image_labeler_version` against a JAX
  Node's on the same data dir, the thumbnailer's background share.
"""

import asyncio
import json
import os
import types
import uuid

import pytest

import spacedrive_tpu.db.database as jdb
import spacedrive_tpu.node.actors as jactors
import spacedrive_tpu.node.config as jconfig
import spacedrive_tpu.node.notifications as jnotifications
import spacedrive_tpu.node.preferences as jpreferences
import spacedrive_tpu.p2p.identity as jidentity
import spacedrive_tpu.utils.ed25519_fallback as jfallback
import spacedrive_tpu_torch.db.database as pdb
import spacedrive_tpu_torch.node.actors as pactors
import spacedrive_tpu_torch.node.config as pconfig
import spacedrive_tpu_torch.node.notifications as pnotifications
import spacedrive_tpu_torch.node.preferences as ppreferences
import spacedrive_tpu_torch.p2p.identity as pidentity
import spacedrive_tpu_torch.utils.ed25519_fallback as pfallback

JAX = types.SimpleNamespace(identity=jidentity, fallback=jfallback, config=jconfig,
                            actors=jactors, preferences=jpreferences,
                            notifications=jnotifications, db=jdb)
PORT = types.SimpleNamespace(identity=pidentity, fallback=pfallback, config=pconfig,
                             actors=pactors, preferences=ppreferences,
                             notifications=pnotifications, db=pdb)
PKGS = {"jax": JAX, "port": PORT}

SEED = bytes(range(7, 39))


# --- identity ------------------------------------------------------------


@pytest.fixture(params=["cryptography", "fallback"])
def ed25519(request, monkeypatch):
    """Both identity modules on the gate's `cryptography` branch, or both
    on the pure-Python fallback."""
    if request.param == "fallback":
        for pkg in (JAX, PORT):
            monkeypatch.setattr(pkg.identity, "_HAVE_CRYPTOGRAPHY", False)
            monkeypatch.setattr(pkg.identity, "serialization", None)
            monkeypatch.setattr(pkg.identity, "Ed25519PrivateKey", pkg.fallback.Ed25519PrivateKey)
            monkeypatch.setattr(pkg.identity, "Ed25519PublicKey", pkg.fallback.Ed25519PublicKey)
    else:
        pytest.importorskip("cryptography")
        assert PORT.identity._HAVE_CRYPTOGRAPHY and JAX.identity._HAVE_CRYPTOGRAPHY
    return request.param


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_identity_roundtrip_and_sign(pkg, ed25519):
    """tests/test_node.py:39 on each package."""
    Identity, RemoteIdentity = PKGS[pkg].identity.Identity, PKGS[pkg].identity.RemoteIdentity
    ident = Identity()
    seed = ident.to_bytes()
    assert len(seed) == 32
    again = Identity.from_bytes(seed)
    remote = ident.to_remote_identity()
    assert again.to_remote_identity() == remote
    sig = ident.sign(b"hello")
    assert remote.verify(sig, b"hello")
    assert not remote.verify(sig, b"tampered")
    assert RemoteIdentity.from_str(str(remote)) == remote


def test_identity_from_one_seed_matches_jax(ed25519):
    port = PORT.identity.Identity.from_bytes(SEED)
    jax = JAX.identity.Identity.from_bytes(SEED)
    assert str(port.to_remote_identity()) == str(jax.to_remote_identity())
    assert port.to_bytes() == jax.to_bytes() == SEED
    for msg in (b"", b"hello", bytes(range(256)) * 3):
        sig = port.sign(msg)
        assert sig == jax.sign(msg)  # ed25519 signing is deterministic
        assert jax.to_remote_identity().verify(sig, msg)
        assert port.to_remote_identity().verify(jax.sign(msg), msg)
        assert not port.to_remote_identity().verify(sig, msg + b"x")
    # the display form parses in the other package
    remote = PORT.identity.RemoteIdentity.from_str(str(jax.to_remote_identity()))
    assert remote.to_bytes() == jax.to_remote_identity().to_bytes()


def test_fallback_signatures_equal_the_cryptography_package():
    pytest.importorskip("cryptography")
    from cryptography.hazmat.primitives.asymmetric.ed25519 import Ed25519PrivateKey

    ref = Ed25519PrivateKey.from_private_bytes(SEED)
    key = PORT.fallback.Ed25519PrivateKey.from_private_bytes(SEED)
    assert key.public_key().public_bytes() == ref.public_key().public_bytes_raw()
    for msg in (b"", b"spacedrive", os.urandom(1000)):
        assert key.sign(msg) == ref.sign(msg)
        key.public_key().verify(ref.sign(msg), msg)
    with pytest.raises(PORT.fallback.InvalidSignature):
        key.public_key().verify(key.sign(b"a"), b"b")


# --- node config ---------------------------------------------------------


def _configured(pkg, data_dir):
    """A config of `pkg` in `data_dir` with every field off its default."""
    cfg = pkg.config
    mgr = cfg.ConfigManager(data_dir)
    mgr.config.name = "station"
    mgr.config.identity = pkg.identity.Identity.from_bytes(SEED)
    mgr.config.features.extend([cfg.BackendFeature.CLOUD_SYNC, cfg.BackendFeature.REMOTE_RSPC])
    mgr.config.p2p.discovery = cfg.P2PDiscoveryState.CONTACTS_ONLY
    mgr.config.p2p.port = 7373
    mgr.config.p2p.relay = "relay.example:443"
    mgr.config.preferences["cloud_api_origin"] = "https://api.example"
    mgr.config.image_labeler_version = "checkpoint:weights.npz"
    mgr.save()
    return mgr


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_node_config_written_by_one_loads_in_the_other(tmp_path, writer, reader):
    w = _configured(PKGS[writer], tmp_path)
    with open(tmp_path / "node.json") as f:
        written = json.load(f)
    r = PKGS[reader].config.ConfigManager(tmp_path)
    assert r.config.to_dict() == w.config.to_dict() == written
    assert r.config.id == w.config.id
    assert str(r.config.identity.to_remote_identity()) == \
        str(w.config.identity.to_remote_identity())
    assert [f.value for f in r.config.features] == ["cloudSync", "remoteRspc"]
    # the reader persisted nothing new: the file is the writer's
    with open(tmp_path / "node.json") as f:
        assert json.load(f) == written


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_node_config_persist_and_reload(tmp_path, pkg):
    """tests/test_node.py:56 on each package."""
    cfg = PKGS[pkg].config
    mgr = cfg.ConfigManager(tmp_path)
    node_id = mgr.config.id
    mgr.config.name = "station"
    mgr.config.features.append(cfg.BackendFeature.CLOUD_SYNC)
    mgr.config.p2p.discovery = cfg.P2PDiscoveryState.CONTACTS_ONLY
    mgr.save()
    mgr2 = cfg.ConfigManager(tmp_path)
    assert mgr2.config.id == node_id
    assert mgr2.config.name == "station"
    assert mgr2.config.features == [cfg.BackendFeature.CLOUD_SYNC]
    assert mgr2.config.p2p.discovery == cfg.P2PDiscoveryState.CONTACTS_ONLY
    assert mgr2.config.identity.to_bytes() == mgr.config.identity.to_bytes()


@pytest.mark.parametrize("with_identity", [True, False])
def test_node_config_migration_v1_matches_jax(tmp_path, with_identity):
    """tests/test_node.py:73: a v1 file migrates to v2 in both packages,
    and the migrated files are equal (but for the keypair each package
    mints when the v1 file has none); a restart keeps the minted one."""
    v1 = {"version": 1, "id": str(uuid.UUID(int=12345)), "name": "old"}
    if with_identity:
        v1["identity"] = SEED.hex()
    files = {}
    for name, pkg in PKGS.items():
        d = tmp_path / name
        d.mkdir()
        (d / "node.json").write_text(json.dumps(v1))
        mgr = pkg.config.ConfigManager(d)
        assert mgr.config.version == 2 and mgr.config.features == []
        files[name] = json.loads((d / "node.json").read_text())
        assert pkg.config.ConfigManager(d).config.identity.to_bytes() == \
            mgr.config.identity.to_bytes()
    if not with_identity:
        for f in files.values():
            assert len(bytes.fromhex(f.pop("identity"))) == 32
    assert files["port"] == files["jax"]
    assert files["port"]["version"] == 2 and files["port"]["features"] == []


# --- actors --------------------------------------------------------------


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_actors_declare_start_stop_restart(pkg):
    """tests/test_node.py:90 on each package."""
    Actors = PKGS[pkg].actors.Actors

    async def run():
        actors = Actors()
        ticks = []

        async def actor():
            while True:
                ticks.append(1)
                await asyncio.sleep(0.01)

        actors.declare("ticker", actor)
        assert not actors.is_running("ticker")
        assert actors.start("ticker")
        await asyncio.sleep(0.05)
        assert actors.is_running("ticker")
        assert ticks
        assert actors.stop("ticker")
        await asyncio.sleep(0.02)
        assert not actors.is_running("ticker")
        assert actors.restart("ticker")
        assert actors.states() == {"ticker": True}
        before = len(ticks)
        assert actors.restart("ticker")
        await asyncio.sleep(0.05)
        assert actors.is_running("ticker") and len(ticks) > before
        assert not actors.start("unknown")
        await actors.shutdown()
        assert not actors.is_running("ticker")

    asyncio.run(run())


# --- preferences ---------------------------------------------------------

PREFS = {
    "location": {"1": {"explorer": {"layout": "grid", "size": 3, "zoom": 1.25}}},
    "theme": "dark",
    "tags": [1, 2, "x"],
    "flags": {"a": True, "b": None, "c": -70000},
}


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_preferences_roundtrip(pkg):
    """tests/test_node.py:139 on each package."""
    p = PKGS[pkg]
    db = p.db.LibraryDb(None, memory=True)
    doc = {"location": {"1": {"explorer": {"layout": "grid", "size": 3}}}, "theme": "dark"}
    p.preferences.write_preferences(db, doc)
    assert p.preferences.read_preferences(db) == doc
    p.preferences.write_preferences(db, {"theme": "light"})
    out = p.preferences.read_preferences(db)
    assert out["theme"] == "light" and out["location"] == doc["location"]
    p.preferences.clear_preference(db, "location")
    assert "location" not in p.preferences.read_preferences(db)
    p.preferences.write_preferences(db, {"theme": {"mode": "system"}})
    assert p.preferences.read_preferences(db)["theme"] == {"mode": "system"}
    p.preferences.write_preferences(db, {"theme": "dark"})
    assert p.preferences.read_preferences(db)["theme"] == "dark"


def _rows(db, table, order):
    return db.query(f"SELECT * FROM {table} ORDER BY {order}")


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_preference_rows_equal_and_read_across(tmp_path, writer, reader):
    dbs = {}
    for name, pkg in PKGS.items():
        db = pkg.db.LibraryDb(tmp_path / f"{name}.db")
        pkg.preferences.write_preferences(db, PREFS)
        pkg.preferences.write_preferences(db, {"location": {"1": {"explorer": "flat"}}})
        dbs[name] = db
    assert _rows(dbs["port"], "preference", "key") == _rows(dbs["jax"], "preference", "key")
    dbs[writer].close()
    other = PKGS[reader].db.LibraryDb(tmp_path / f"{writer}.db")
    want = PKGS[writer].preferences.read_preferences(dbs[reader])
    assert PKGS[reader].preferences.read_preferences(other) == want
    assert want["location"] == {"1": {"explorer": "flat"}} and want["flags"] == PREFS["flags"]


# --- notifications -------------------------------------------------------


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_notifications_node_and_library(pkg):
    """tests/test_node.py:164 on each package (the port's event bus has
    no callbacks: the events are read through a subscription)."""
    p = PKGS[pkg]
    db = p.db.LibraryDb(None, memory=True)
    notif = p.notifications.Notifications()
    sub = notif.event_bus.subscribe()
    n1 = notif.emit_node({"kind": "info", "title": "hi"})
    assert n1.id.library_id is None and n1.id.local_id == 1
    lib_id = str(uuid.uuid4())
    n2 = notif.emit_library(db, lib_id, {"kind": "error", "title": "bad"})
    assert n2.id.library_id == lib_id
    assert [e[1] for e in sub.poll()] == [n1, n2]
    rows = p.notifications.Notifications.list_library(db, lib_id)
    assert rows[0].data["title"] == "bad" and not rows[0].read
    p.notifications.Notifications.mark_read(db, rows[0].id.local_id)
    assert p.notifications.Notifications.list_library(db, lib_id)[0].read
    assert notif.list_node() == [n1]


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_notification_rows_equal_and_read_across(tmp_path, writer, reader):
    lib_id = str(uuid.UUID(int=7))
    datas = [{"kind": "ok", "job": "media_processor", "status": "COMPLETED", "message": None},
             {"kind": "warning", "job": "file_identifier", "message": "3 items failed",
              "n": 3, "ratio": 0.5, "tags": ["a", "b"]}]
    dbs = {}
    for name, pkg in PKGS.items():
        db = pkg.db.LibraryDb(tmp_path / f"{name}.db")
        notif = pkg.notifications.Notifications()
        for d in datas:
            notif.emit_library(db, lib_id, d, expires_at="2030-01-01T00:00:00Z")
        dbs[name] = db
    cols = "id, data, read, expires_at"
    assert dbs["port"].query(f"SELECT {cols} FROM notification ORDER BY id") == \
        dbs["jax"].query(f"SELECT {cols} FROM notification ORDER BY id")
    dbs[writer].close()
    other = PKGS[reader].db.LibraryDb(tmp_path / f"{writer}.db")
    got = PKGS[reader].notifications.Notifications.list_library(other, lib_id)
    assert [n.data for n in got] == datas
    assert [(n.id.library_id, n.id.local_id) for n in got] == [(lib_id, 1), (lib_id, 2)]


# --- the Node ------------------------------------------------------------


def test_node_lifecycle(tmp_path):
    """tests/test_node.py:233 on a port Node on "cpu"."""
    from spacedrive_tpu_torch.node.config import BackendFeature
    from spacedrive_tpu_torch.node.node import Node

    async def run():
        node = Node(tmp_path, device="cpu")
        node.config.config.p2p.enabled = False
        await node.start()
        lib = await node.create_library("home", "my files")
        assert node.libraries.libraries.get(lib.id) is lib and lib.node is node
        inst = lib.db.find_one("instance", id=lib.config.instance_id)
        assert inst["node_id"] == node.id.bytes and inst["node_name"] == node.config.config.name
        assert lib.config.description == "my files"
        node.toggle_feature(BackendFeature.FILES_OVER_P2P, True)
        assert node.is_feature_enabled(BackendFeature.FILES_OVER_P2P)
        await node.shutdown()

        node2 = Node(tmp_path, device="cpu")
        node2.config.config.p2p.enabled = False
        assert node2.id == node.id
        assert node2.identity.to_bytes() == node.identity.to_bytes()
        await node2.start()
        assert node2.libraries.libraries.get(lib.id) is not None
        assert node2.is_feature_enabled(BackendFeature.FILES_OVER_P2P)
        node2.toggle_feature(BackendFeature.FILES_OVER_P2P, False)
        assert not node2.is_feature_enabled(BackendFeature.FILES_OVER_P2P)
        await node2.close_library(lib.id)
        assert node2.libraries.libraries.get(lib.id) is None
        await node2.shutdown()

    asyncio.run(run())


def test_node_loads_a_jax_nodes_data_dir(tmp_path):
    """A data dir a JAX Node made (node.json, a library) boots a port
    Node with the same id, identity and library."""
    from spacedrive_tpu.node.node import Node as JNode
    from spacedrive_tpu_torch.node.node import Node as PNode

    async def run():
        jnode = JNode(tmp_path, use_device=False, with_labeler=False)
        jnode.config.config.p2p.enabled = False
        await jnode.start()
        jlib = await jnode.create_library("shared")
        await jnode.shutdown()
        pnode = PNode(tmp_path, device="cpu", with_labeler=False)
        pnode.config.config.p2p.enabled = False
        await pnode.start()
        try:
            assert pnode.id == jnode.id
            assert str(pnode.identity.to_remote_identity()) == \
                str(jnode.identity.to_remote_identity())
            assert pnode.libraries.libraries.get(jlib.id).name == "shared"
        finally:
            await pnode.shutdown()

    asyncio.run(run())


@pytest.mark.parametrize("provisioned", [False, True])
def test_image_labeler_version_matches_jax(tmp_path, provisioned):
    """`image_labeler_version` names the labeler's resolved artifact as
    the JAX Node writes it: "none" before provisioning, the bundled
    checkpoint's after."""
    from spacedrive_tpu.node.node import Node as JNode
    from spacedrive_tpu_torch.models import provision
    from spacedrive_tpu_torch.node.node import Node as PNode

    if provisioned:
        for name in ("jax", "port"):
            provision.install_bundled(str(tmp_path / name / "image_labeler"))
    jnode = JNode(tmp_path / "jax", use_device=False)
    pnode = PNode(tmp_path / "port", device="cpu")
    want = jnode.config.config.image_labeler_version
    assert pnode.config.config.image_labeler_version == want
    assert (want == "none") is not provisioned
    reloaded = json.loads((tmp_path / "port" / "node.json").read_text())
    assert reloaded["image_labeler_version"] == want


def test_thumbnailer_background_percentage_matches_jax(tmp_path):
    """`set_background_percentage(25)` gives the background parallelism
    the JAX actor computes; the share is clamped to 0-100 and read back
    by `nodeState`."""
    from spacedrive_tpu.object.media.thumbnail.actor import Thumbnailer as JThumbnailer
    from spacedrive_tpu_torch.node.node import Node
    from spacedrive_tpu_torch.object.media.thumbnail.actor import Thumbnailer

    port = Thumbnailer(tmp_path / "p", device="cpu")
    jax = JThumbnailer(tmp_path / "j")
    assert port.background_percentage == jax.background_percentage == 50
    for pct in (25, 0, 100, 150, -5, 1):
        port.set_background_percentage(pct)
        jax.set_background_percentage(pct)
        assert port.background_percentage == jax.background_percentage
        assert port._bg_parallelism == jax._bg_parallelism
    port.set_background_percentage(25)
    assert port._bg_parallelism == max(1, (os.cpu_count() or 1) * 25 // 100)

    async def run():
        node = Node(tmp_path / "n", device="cpu", with_labeler=False)
        node.config.config.p2p.enabled = False
        await node.start()
        try:
            await node.router.exec(node, "nodes.updateThumbnailerPreferences",
                                   {"background_processing_percentage": 25})
            state = await node.router.exec(node, "nodeState")
            assert state["thumbnailer_background_percentage"] == 25
            assert node.thumbnailer._bg_parallelism == port._bg_parallelism
        finally:
            await node.shutdown()

    asyncio.run(run())


def test_tracing_hooks_record_into_the_error_ring(tmp_path):
    """`init_logger` writes the rolling log under the data dir and its
    hooks put uncaught exceptions in the port's error ring."""
    import logging
    import sys
    import threading

    from spacedrive_tpu_torch.telemetry.events import ERROR_EVENTS
    from spacedrive_tpu_torch.utils import tracing

    saved = (sys.excepthook, threading.excepthook, logging.getLogger().handlers[:],
             logging.getLogger().level)
    try:
        tracing.init_logger(tmp_path, "warning,spacedrive_tpu_torch.x=debug")
        assert logging.getLogger("spacedrive_tpu_torch.x").level == logging.DEBUG
        mark = f"thread crash {uuid.uuid4()}"

        def boom():
            raise RuntimeError(mark)

        t = threading.Thread(target=boom)
        t.start()
        t.join()
        events = [e["fields"] for e in ERROR_EVENTS.snapshot()
                  if e["fields"].get("message") == mark]
        assert [(e["source"], e["exc_type"]) for e in events] == [("thread", "RuntimeError")]
        assert os.path.exists(tmp_path / "logs" / "sd.log")
    finally:
        sys.excepthook, threading.excepthook = saved[0], saved[1]
        root = logging.getLogger()
        for h in root.handlers[:]:
            root.removeHandler(h)
            if h not in saved[2]:
                h.close()
        for h in saved[2]:
            root.addHandler(h)
        root.setLevel(saved[3])
