"""The port's rspc router against the JAX package's: the router-level
cases of tests/test_api.py, each run through a JAX
`Node(use_device=False, with_labeler=False)` (serve gate off, the JAX
router's direct path) and a port `Node(device="cpu",
with_labeler=False)` over one seeded corpus, one copy each.

The results are compared after `_norm`: the corpus root, the data dir
and the library id become placeholders; pub_ids, public keys, inodes
and timestamps become whether they are set. Everything else is exact:
rows, ids, counts, orders, cursors, cas_ids, checksums, statistics,
tags and labels, and the invalidated keys of a rescan;
`search.semantic` scores agree within 1e-5.

Also: the port's key set is the JAX router's less `DEFERRED` (the five
`cloud.*` keys, each naming its ROADMAP plane), `client_gen` emits the JAX package's
module for the ported keys, and with the bundled labeler checkpoint a
labelled scan invalidates `labels.list` as the JAX actor does. The
`sync.*` procedures answer as JAX's after the same writes; `keys.*`
run through the router, and a wrong-password retry leaves the vault
as tests/test_api.py:572 asserts, which the JAX router fails (a key
added with `automount` is not mounted until the next unlock there).
"""

import asyncio
import json
import os
import shutil
import uuid

import numpy as np
import pytest
from PIL import Image

import spacedrive_tpu.api as japi
import spacedrive_tpu.telemetry as jtelemetry
import spacedrive_tpu.api.client_gen as jclient_gen
import spacedrive_tpu_torch.api as papi
import spacedrive_tpu_torch.api.client_gen as pclient_gen
from spacedrive_tpu.api.router import CoreEventKind as JCoreEventKind
from spacedrive_tpu_torch.api.router import CoreEventKind

#: JAX plane numbers in ROADMAP.md's plane list
PLANES = {"6.8"}


@pytest.fixture(autouse=True)
def _direct_path(monkeypatch):
    """The JAX router takes its direct path, the port's only one. After
    each test the JAX package's telemetry is reset, so its scans leave
    no spans or series to later tests of the worker (the observability
    smoke reads the first `walk` span of the process-wide trace ring)."""
    monkeypatch.setenv("SD_SERVE_GATE", "0")
    yield
    jtelemetry.reset()


def _gradient(rng, size=40):
    yy, xx = np.mgrid[0:size, 0:size] / float(size)
    a, b, c = rng.uniform(-3, 3, 3)
    img = np.stack([np.sin(a * xx + b * yy + c + k) * 0.5 + 0.5 for k in range(3)], axis=-1)
    return (img * 255).astype(np.uint8)


def make_corpus(root, seed=0):
    """tests/test_api.py's corpus from a seed, plus three gradient PNGs
    for the semantic search."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "nested"))
    with open(os.path.join(root, "alpha.txt"), "wb") as f:
        f.write(b"a" * 1000)
    with open(os.path.join(root, "beta.bin"), "wb") as f:
        f.write(rng.bytes(2000))
    with open(os.path.join(root, "photo.jpg"), "wb") as f:
        f.write(b"\xff\xd8\xff\xe0" + rng.bytes(500))
    Image.new("RGB", (48, 36), (200, 40, 40)).save(os.path.join(root, "real.png"))
    with open(os.path.join(root, "nested", "gamma.txt"), "wb") as f:
        f.write(b"g" * 300)
    for i in range(3):
        Image.fromarray(_gradient(rng)).save(os.path.join(root, "nested", f"grad{i}.png"))
    return root


def _jax_node(data_dir, **kw):
    from spacedrive_tpu.node import Node

    node = Node(data_dir, use_device=False, with_labeler=False, **kw)
    node.config.config.p2p.enabled = False
    return node


def _port_node(data_dir, **kw):
    from spacedrive_tpu_torch.node.node import Node

    node = Node(data_dir, device="cpu", with_labeler=False, **kw)
    node.config.config.p2p.enabled = False
    return node


NODES = {"jax": _jax_node, "port": _port_node}
EVENTS = {"jax": JCoreEventKind, "port": CoreEventKind}


async def _scanned_node(pkg, data_dir, corpus):
    """tests/test_api.py's `_scanned_node`, through the routers: a started
    node, a library and a scanned location."""
    node = NODES[pkg](data_dir)
    await node.start()
    r = node.router
    lib = await r.exec(node, "library.create", {"name": "api-lib"})
    lid = lib["uuid"]
    loc_id = await r.exec(node, "locations.create", {"path": corpus, "name": "corpus"},
                          library_id=lid)
    await node.jobs.wait_idle()
    return node, node.libraries.libraries.get(uuid.UUID(lid)), loc_id


VOLATILE = ("pub_id", "public_key", "inode", "date_", "_date", "timestamp", "created_at",
            "completed_at", "expires_at")


def _norm(x, roots):
    """Placeholders for the corpus root, the data dir and the library id;
    pub_ids, inodes and timestamps reduced to whether they are set, and
    so are the hashes of the location's `.spacedrive` marker (whose bytes
    are the random location pub_id and library id)."""
    if isinstance(x, dict):
        volatile = VOLATILE + (("cas_id", "integrity_checksum")
                               if x.get("name") == ".spacedrive" else ())
        return {k: (bool(v) if any(t in k for t in volatile) else _norm(v, roots))
                for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_norm(v, roots) for v in x]
    if isinstance(x, str):
        for root, name in roots:
            x = x.replace(root, name)
        return x
    return x


def _names(res):
    return [n["name"] for n in res["nodes"]]


# --- router semantics ------------------------------------------------------


def test_keys_equal_jax_less_deferred():
    jkeys = set(japi.mount().keys())
    pkeys = set(papi.mount().keys())
    assert len(japi.mount().keys()) == 127
    assert len(papi.DEFERRED) == 5 and len(pkeys) == 122
    assert set(papi.DEFERRED) <= jkeys
    assert pkeys == jkeys - set(papi.DEFERRED)
    # the router's keys are JAX's less the five cloud.* procedures
    assert pkeys == jkeys - {f"cloud.{k}" for k in (
        "getApiOrigin", "setApiOrigin", "library.get", "sync.enable", "sync.state")}
    assert set(papi.DEFERRED.values()) == PLANES
    counts = {}
    for key, plane in papi.DEFERRED.items():
        counts[plane] = counts.get(plane, 0) + 1
    assert counts == {"6.8": 5}
    assert {k.split(".")[0] for k in papi.DEFERRED} == {"cloud"}
    assert not any(k.startswith("telemetry.") for k in papi.DEFERRED)


def test_registrations_equal_jax():
    """Kind and library scope of every ported procedure, in the JAX
    registration order; the manifest of the ported keys is JAX's."""
    jr, pr = japi.mount(), papi.mount()
    jprocs = [(k, p.kind, p.library_scoped) for k, p in jr.procedures.items()
              if k not in papi.DEFERRED]
    pprocs = [(k, p.kind, p.library_scoped) for k, p in pr.procedures.items()]
    assert pprocs == jprocs
    jman = {kind: [p for p in procs if p["key"] not in papi.DEFERRED]
            for kind, procs in jr.manifest().items()}
    assert pr.manifest() == jman


def test_client_bindings_equal_jax_on_ported_keys():
    jr, pr = japi.mount(), papi.mount()
    jman = {kind: [p for p in procs if p["key"] not in papi.DEFERRED]
            for kind, procs in jr.manifest().items()}
    want = jclient_gen.generate_js(jman)
    got = pclient_gen.generate_js(pr.manifest())
    assert got.replace("spacedrive_tpu_torch.api.client_gen",
                       "spacedrive_tpu.api.client_gen") == want
    assert "spacedrive_tpu_torch.api.client_gen" in got.splitlines()[0]
    assert '"semantic"' in got and "telemetry.trace_export" in got
    assert "telemetry.tenants" in got and "p2p.state" in got and "cloud.sync.state" not in got


def test_router_keys_unique_and_library_resolution(tmp_path):
    """tests/test_api.py:53 on a port Node."""
    async def run():
        router = papi.mount()
        assert len(router.keys()) > 70
        with pytest.raises(ValueError):
            router.query("buildInfo")(lambda node: None)  # a duplicate key
        node = _port_node(tmp_path)
        await node.start()
        try:
            info = await router.exec(node, "buildInfo")
            assert info == {"version": "0.1.0", "commit": "tpu-native"}
            with pytest.raises(papi.RspcError) as e:
                await router.exec(node, "nope.nothing")
            assert e.value.code == 404
            with pytest.raises(papi.RspcError) as e:
                await router.exec(node, "locations.list")
            assert e.value.code == 400
            with pytest.raises(papi.RspcError) as e:
                await router.exec(node, "locations.list", library_id=str(uuid.uuid4()))
            assert e.value.code == 404
            with pytest.raises(papi.RspcError) as e:
                await router.exec(node, "invalidation.listen")
            assert e.value.code == 400
            # a handler indexing a wrong arg shape is the caller's error
            with pytest.raises(papi.RspcError) as e:
                await router.exec(node, "toggleFeatureFlag", {})
            assert e.value.code == 400
            assert await router.exec(
                node, "toggleFeatureFlag", {"feature": "filesOverP2P", "enabled": True})
        finally:
            await node.shutdown()

    asyncio.run(run())


@pytest.mark.parametrize("model,rows", [
    ("tag", [{"id": 1, "name": "x", "pub_id": b"\x01\x02"}]),
    ("file_path", [{"id": 3, "name": "a", "cas_id": "00ff", "pub_id": b"\xff" * 16},
                   {"id": 9, "name": "b", "cas_id": None, "pub_id": b""}]),
    ("job", [{"id": b"\x00\x01", "name": "indexer"}]),
])
def test_normalised_cache_shape(model, rows):
    """tests/test_api.py:76 on both packages' caches."""
    from spacedrive_tpu.api import cache as jcache
    from spacedrive_tpu_torch.api import cache as pcache

    out = pcache.normalise(model, rows)
    assert out == jcache.normalise(model, rows)
    assert out["items"] == [{"__type": model, "__id": jcache._node_id(model, r)} for r in rows]
    assert pcache.normalise_one(model, rows[0]) == jcache.normalise_one(model, rows[0])
    if model == "tag":
        assert out["items"] == [{"__type": "tag", "__id": 1}]
        assert out["nodes"][0]["pub_id"] == "0102"


# --- end-to-end over procedures --------------------------------------------


async def _full_flow(pkg, tmp, corpus):
    """tests/test_api.py:86 through one package's router (without
    `ephemeralFiles.list`, deferred); returns each step's result and
    holds the reference's assertions."""
    node, lib, loc_id = await _scanned_node(pkg, os.path.join(tmp, "node"), corpus)
    r, lid = node.router, str(lib.id)
    out = {"library_id": lid}
    try:
        locs = await r.exec(node, "locations.list", library_id=lid)
        assert len(locs["items"]) == 1 and locs["nodes"][0]["online"] is True
        out["locations.list"] = locs
        out["locations.get"] = await r.exec(node, "locations.get", loc_id, library_id=lid)

        res = await r.exec(node, "search.paths",
                           {"filter": {"extension": "txt"}, "orderBy": "name"}, library_id=lid)
        assert _names(res) == ["alpha", "gamma"]
        out["paths.txt"] = res
        page1 = await r.exec(node, "search.paths", {"take": 2, "filter": {}}, library_id=lid)
        page2 = await r.exec(node, "search.paths", {"take": 50, "cursor": page1["cursor"]},
                             library_id=lid)
        assert len(page1["items"]) == 2 and page1["cursor"] is not None
        assert not {n["__id"] for n in page1["items"]} & {n["__id"] for n in page2["items"]}
        out["paths.pages"] = [page1, page2]
        for order in ("name", "sizeInBytes"):
            seen, cursor, vals, cursors = [], None, [], []
            while True:
                page = await r.exec(node, "search.paths",
                                    {"take": 2, "orderBy": order, "cursor": cursor},
                                    library_id=lid)
                seen += [n["__id"] for n in page["items"]]
                vals += [n["name" if order == "name" else "size_in_bytes"]
                         for n in page["nodes"]]
                cursor = page["cursor"]
                cursors.append(cursor)
                if cursor is None:
                    break
            assert len(seen) == len(set(seen)) == lib.db.count("file_path")
            assert vals == sorted(vals)
            out[f"paths.keyset.{order}"] = [seen, vals, cursors]

        fp = lib.db.find_one("file_path", name="alpha")
        tag_id = await r.exec(node, "tags.create", {"name": "keep", "color": "#f00"},
                              library_id=lid)
        await r.exec(node, "tags.assign", {"tag_id": tag_id, "object_ids": [fp["object_id"]]},
                     library_id=lid)
        tagged = await r.exec(node, "search.paths", {"filter": {"tags": [tag_id]}},
                              library_id=lid)
        assert _names(tagged) == ["alpha"]
        for_obj = await r.exec(node, "tags.getForObject", fp["object_id"], library_id=lid)
        assert for_obj["nodes"][0]["name"] == "keep"
        out["tags"] = [tag_id, tagged, for_obj, await r.exec(node, "tags.list", library_id=lid)]
        await r.exec(node, "tags.update", {"id": tag_id, "color": "#0f0"}, library_id=lid)
        out["tags.updated"] = await r.exec(node, "tags.list", library_id=lid)

        await r.exec(node, "files.setFavorite", {"id": fp["id"], "favorite": True},
                     library_id=lid)
        favs = await r.exec(node, "search.objects", {"filter": {"favorite": True}},
                            library_id=lid)
        assert len(favs["items"]) == 1
        await r.exec(node, "files.setNote", {"id": fp["id"], "note": "keep me"},
                     library_id=lid)
        out["files.favorite"] = [favs, await r.exec(node, "files.get", {"id": fp["id"]},
                                                    library_id=lid)]

        await r.exec(node, "files.renameFile", {"id": fp["id"], "new_name": "alpha-renamed.txt"},
                     library_id=lid)
        assert os.path.exists(os.path.join(corpus, "alpha-renamed.txt"))
        assert lib.db.find_one("file_path", name="alpha-renamed") is not None
        ops = lib.db.query("SELECT model, kind, COUNT(*) AS n FROM crdt_operation "
                           "GROUP BY model, kind ORDER BY model, kind")
        out["crdt_ops"] = ops

        reports = await r.exec(node, "jobs.reports", library_id=lid)
        assert {rep["name"] for rep in reports} >= {"indexer", "file_identifier",
                                                     "media_processor"}
        out["jobs.reports"] = sorted(
            [(rep["name"], rep["action"], rep["status"], rep["task_count"],
              rep["completed_task_count"], rep["errors"], rep["parent_id"] is not None)
             for rep in reports])
        out["jobs.isActive"] = await r.exec(node, "jobs.isActive", library_id=lid)

        stats = await r.exec(node, "library.statistics", library_id=lid)
        assert stats["total_object_count"] > 0
        out["library.statistics"] = {k: stats[k] for k in (
            "total_object_count", "total_bytes_used", "total_unique_bytes")}
        vols = await r.exec(node, "volumes.list")
        assert vols
        out["volumes.list"] = [(v["name"], v["mount_point"], v["is_system"]) for v in vols]
        out["volumes.track"] = await r.exec(node, "volumes.track", library_id=lid)
        await r.exec(node, "preferences.update", {"explorer": {"layout": "grid"}},
                     library_id=lid)
        prefs = await r.exec(node, "preferences.get", library_id=lid)
        assert prefs["explorer"]["layout"] == "grid"
        out["preferences.get"] = prefs

        sid = await r.exec(node, "search.saved.create",
                           {"name": "txts", "filters": json.dumps({"extension": "txt"})},
                           library_id=lid)
        saved = await r.exec(node, "search.saved.list", library_id=lid)
        assert saved["nodes"][0]["id"] == sid
        out["search.saved"] = saved
        await r.exec(node, "search.saved.delete", sid, library_id=lid)
        assert (await r.exec(node, "search.saved.list", library_id=lid))["items"] == []

        sub = node.event_bus.subscribe()
        await r.exec(node, "tags.create", {"name": "x"}, library_id=lid)
        await asyncio.sleep(0.05)
        seen = [ev[1].to_wire() for ev in sub.poll()
                if isinstance(ev, tuple) and ev[0] == EVENTS[pkg].INVALIDATE_OPERATION]
        sub.close()
        assert "tags.list" in [s["key"] for s in seen]
        out["invalidations.tags.create"] = seen

        for ns in ("spaces", "albums"):
            cid = await r.exec(node, f"{ns}.create", {"name": f"my-{ns}"}, library_id=lid)
            await r.exec(node, f"{ns}.addObjects", {"id": cid, "object_ids": [fp["object_id"]]},
                         library_id=lid)
            objs = await r.exec(node, f"{ns}.getObjects", cid, library_id=lid)
            assert len(objs["items"]) == 1
            listing = await r.exec(node, f"{ns}.list", library_id=lid)
            assert listing["nodes"][0]["name"] == f"my-{ns}"
            out[ns] = [cid, objs, listing]
            await r.exec(node, f"{ns}.addObjects",
                         {"id": cid, "object_ids": [fp["object_id"]], "remove": True},
                         library_id=lid)
            assert (await r.exec(node, f"{ns}.getObjects", cid, library_id=lid))["items"] == []
            await r.exec(node, f"{ns}.delete", cid, library_id=lid)
            assert (await r.exec(node, f"{ns}.list", library_id=lid))["items"] == []

        scratch = os.path.join(tmp, "scratch")
        os.makedirs(scratch, exist_ok=True)
        folder = await r.exec(node, "ephemeralFiles.createFolder",
                              {"path": scratch, "name": "made-here"})
        assert os.path.isdir(folder)
        with open(os.path.join(scratch, "loose.txt"), "w") as f:
            f.write("x")
        renamed = await r.exec(node, "ephemeralFiles.renameFile",
                               {"path": os.path.join(scratch, "loose.txt"),
                                "new_name": "kept.txt"})
        assert os.path.exists(renamed)
        deleted = await r.exec(node, "ephemeralFiles.deleteFiles",
                               {"paths": [renamed, folder, "/nonexistent/zzz"]})
        assert deleted == {"deleted": 2, "errors": []} and not os.path.exists(folder)
        with pytest.raises(Exception) as e:
            await r.exec(node, "ephemeralFiles.createFolder", {"path": scratch, "name": "a/b"})
        out["ephemeral"] = [folder, renamed, deleted, e.value.code]

        lib.db.upsert("media_data", {"object_id": fp["object_id"]}, epoch_time=1_700_000_000)
        hits = await r.exec(node, "search.paths",
                            {"filter": {"mediaDate": {"from": 1_600_000_000,
                                                      "to": 1_800_000_000}}}, library_id=lid)
        assert [n["__id"] for n in hits["items"]] == [fp["id"]]
        out["paths.mediaDate"] = hits

        out["labels.list"] = await r.exec(node, "labels.list", library_id=lid)
        out["models"] = await r.exec(node, "models.imageDetection.list")
        out["auth"] = [await r.exec(node, "auth.me"), await r.exec(node, "auth.logout")]
        out["rules"] = await r.exec(node, "locations.indexerRules.list", library_id=lid)
        out["rules.for_location"] = await r.exec(
            node, "locations.indexerRules.listForLocation", loc_id, library_id=lid)

        backup_id = await r.exec(node, "backups.backup", library_id=lid)
        await r.exec(node, "tags.create", {"name": "doomed"}, library_id=lid)
        assert lib.db.find_one("tag", name="doomed") is not None
        backups = await r.exec(node, "backups.getAll")
        assert backups and backups[0]["id"] == backup_id
        await r.exec(node, "backups.restore", {"path": backups[0]["path"]})
        lib2 = node.libraries.libraries.get(lib.id)
        assert lib2.db.find_one("tag", name="doomed") is None
        assert lib2.db.find_one("tag", name="keep") is not None
        assert [os.path.basename(b["path"]) for b in backups] == [f"{backup_id}.zip"]
        out["backups"] = [{k: v for k, v in b.items() if k not in ("id", "path")}
                          for b in backups]
        out["library.list"] = await r.exec(node, "library.list")
    finally:
        await node.shutdown()
    return out


def _both(tmp_path, flow, *args):
    """Run `flow(pkg, tmp, corpus)` on each package over its own copy of
    one seeded corpus; return both results, normalised."""
    base = make_corpus(str(tmp_path / "seed"))
    outs = {}
    for pkg in ("jax", "port"):
        tmp = str(tmp_path / pkg)
        corpus = os.path.join(tmp, "corpus")
        shutil.copytree(base, corpus)
        got = asyncio.run(flow(pkg, tmp, corpus, *args))
        outs[pkg] = _norm(got, [(corpus, "<corpus>"), (tmp, "<tmp>"),
                                (got.pop("library_id"), "<library>")])
    return outs


def _assert_equal_by_key(outs):
    assert outs["port"].keys() == outs["jax"].keys()
    for key in outs["jax"]:
        assert outs["port"][key] == outs["jax"][key], key


def test_api_full_flow_matches_jax(tmp_path):
    _assert_equal_by_key(_both(tmp_path, _full_flow))


async def _overview_flow(pkg, tmp, corpus):
    """tests/test_api.py:317 through one package's router."""
    node, lib, _loc = await _scanned_node(pkg, os.path.join(tmp, "node"), corpus)
    r, lid = node.router, str(lib.id)
    out = {"library_id": lid}
    try:
        ks = await r.exec(node, "library.kindStatistics", library_id=lid)
        stats = {s["name"]: s for s in ks["statistics"]}
        assert stats["Text"]["count"] == 2
        assert int(stats["Text"]["total_bytes"]) == 1300
        assert all(s["count"] > 0 for s in ks["statistics"])
        out["kindStatistics"] = ks

        fp = lib.db.find_one("file_path", name="alpha")
        await r.exec(node, "files.setFavorite", {"id": fp["id"], "favorite": True},
                     library_id=lid)
        favs = await r.exec(node, "search.paths", {"filter": {"favorite": True}},
                            library_id=lid)
        assert _names(favs) == ["alpha"]
        out["favorites"] = favs
        rec = await r.exec(node, "search.paths", {"filter": {"accessed": True}},
                           library_id=lid)
        assert rec["nodes"] == []

        beta = lib.db.find_one("file_path", name="beta")
        await r.exec(node, "files.updateAccessTime", {"ids": [fp["id"]]}, library_id=lid)
        await asyncio.sleep(0.01)
        await r.exec(node, "files.updateAccessTime", {"ids": [999999, beta["id"]]},
                     library_id=lid)
        rec = await r.exec(node, "search.paths",
                           {"filter": {"accessed": True}, "orderBy": "dateAccessed",
                            "orderDir": "desc"}, library_id=lid)
        assert _names(rec) == ["beta", "alpha"]
        assert all(n["object_date_accessed"] for n in rec["nodes"])
        out["recents"] = rec
        allrows = await r.exec(node, "search.paths",
                               {"orderBy": "dateAccessed", "orderDir": "asc"}, library_id=lid)
        flags = [bool(n["object_date_accessed"]) for n in allrows["nodes"]]
        assert flags[:2] == [True, True] and not any(flags[2:])
        assert _names(allrows)[:2] == ["alpha", "beta"]
        out["all_by_access"] = _names(allrows)[:2] + sorted(_names(allrows)[2:])
        objs = await r.exec(node, "search.objects",
                            {"orderBy": "dateAccessed", "orderDir": "asc"}, library_id=lid)
        obj_flags = [bool(o.get("date_accessed")) for o in objs["nodes"]]
        assert obj_flags[:2] == [True, True] and not any(obj_flags[2:])

        notifs = await r.exec(node, "notifications.get")
        done = [n for n in notifs if n["data"].get("job") == "media_processor"]
        assert len(done) == 1 and done[0]["data"]["kind"] == "ok"
        out["notifications.get"] = notifs
        local_id = done[0]["id"]["local_id"]
        await r.exec(node, "notifications.dismiss", local_id, library_id=lid)
        assert all(n["read"] for n in await r.exec(node, "notifications.get"))
        await r.exec(node, "notifications.dismissAll", library_id=lid)

        png = lib.db.find_one("file_path", name="real")
        md = await r.exec(node, "files.getMediaData", png["object_id"], library_id=lid)
        assert md["resolution"] == [48, 36]
        assert await r.exec(node, "files.getMediaData", fp["object_id"], library_id=lid) is None
        out["getMediaData"] = md
    finally:
        await node.shutdown()
    return out


def test_overview_favorites_recents_match_jax(tmp_path):
    _assert_equal_by_key(_both(tmp_path, _overview_flow))


async def _rescan_flow(pkg, tmp, corpus):
    """tests/test_api.py:492 through one package's router: a rescan's
    JobProgress events and invalidations on the node bus; then the
    semantic search, the duplicates query and the validator."""
    node, lib, loc_id = await _scanned_node(pkg, os.path.join(tmp, "node"), corpus)
    r, lid = node.router, str(lib.id)
    out = {"library_id": lid}
    try:
        sub = node.event_bus.subscribe()
        with open(os.path.join(corpus, "fresh.txt"), "w") as f:
            f.write("new content")
        await r.exec(node, "locations.fullRescan", {"location_id": loc_id}, library_id=lid)
        await node.jobs.wait_idle()
        progress, invalidated = [], []
        for ev in sub.poll():
            if isinstance(ev, tuple) and ev[0] == "JobProgress":
                progress.append(ev[1])
            if isinstance(ev, tuple) and ev[0] == EVENTS[pkg].INVALIDATE_OPERATION:
                invalidated.append(ev[1].to_wire())
        assert progress and progress[0].name
        keys = {i["key"] for i in invalidated}
        assert {"search.paths", "locations.list"} <= keys
        out["rescan.invalidated"] = sorted(keys)
        out["rescan.progress"] = sorted({(p.name, str(p.library_id) == lid) for p in progress})
        out["rescan.notifications"] = [n["data"] for n in await r.exec(node, "notifications.get")]

        await r.exec(node, "locations.subPathRescan",
                     {"location_id": loc_id, "sub_path": "/nested"}, library_id=lid)
        await node.jobs.wait_idle()
        reports = await r.exec(node, "jobs.reports", library_id=lid)
        out["jobs"] = sorted((rep["name"], rep["status"]) for rep in reports)

        probe = os.path.join(corpus, "nested", "grad1.png")
        sem = await r.exec(node, "search.semantic", {"query": probe, "take": 5}, library_id=lid)
        assert sem["resolved"] and sem["nodes"][0]["name"] == "grad1"
        out["semantic"] = sem

        await r.exec(node, "files.validate", {"location_id": loc_id}, library_id=lid)
        await node.jobs.wait_idle()
        out["checksums"] = lib.db.query(
            "SELECT materialized_path, name, extension, cas_id, integrity_checksum "
            "FROM file_path WHERE is_dir = 0 ORDER BY materialized_path, name")
        assert all(row["integrity_checksum"] for row in out["checksums"])

        job_id = await r.exec(node, "search.detectDuplicates", {}, library_id=lid)
        await node.jobs.wait_idle()
        assert uuid.UUID(job_id)
        out["duplicates"] = await r.exec(node, "search.duplicates", {}, library_id=lid)
        # the flat red PNG's AC coefficients are ~0, so its bits are coin
        # flips about the median (tests/test_torch_phash.py): only which
        # objects are hashed is compared there
        hashed = lib.db.query(
            "SELECT o.id, o.phash, fp.name FROM object o JOIN file_path fp "
            "ON fp.object_id = o.id WHERE o.phash IS NOT NULL ORDER BY o.id")
        out["phash"] = [(h["id"], h["name"], h["phash"] if h["name"].startswith("grad") else None)
                        for h in hashed]

        await r.exec(node, "jobs.clearAll", library_id=lid)
        out["jobs.cleared"] = await r.exec(node, "jobs.reports", library_id=lid)
        await r.exec(node, "locations.update", {"id": loc_id, "name": "renamed", "hidden": 1},
                     library_id=lid)
        out["locations.updated"] = await r.exec(node, "locations.list", library_id=lid)
        await r.exec(node, "locations.delete", loc_id, library_id=lid)
        out["after_delete"] = [lib.db.count("file_path"), lib.db.count("location")]
    finally:
        await node.shutdown()
    return out


def test_job_progress_invalidation_and_device_procedures_match_jax(tmp_path):
    outs = _both(tmp_path, _rescan_flow)
    sem = {pkg: outs[pkg].pop("semantic") for pkg in outs}
    _assert_equal_by_key(outs)
    jscores, pscores = sem["jax"].pop("scores"), sem["port"].pop("scores")
    assert pscores.keys() == jscores.keys()
    np.testing.assert_allclose([pscores[k] for k in jscores], list(jscores.values()),
                               rtol=1e-5, atol=1e-5)
    for a, b in zip(sem["port"]["nodes"], sem["jax"]["nodes"]):
        assert abs(a.pop("score") - b.pop("score")) <= 1e-5
    assert sem["port"] == sem["jax"]


async def _subscriptions_flow(pkg, tmp, corpus):
    """`invalidation.listen`, `notifications.listen` and `jobs.progress`
    through `Router.subscribe` while a location scans and a tag is
    created; each stream's events in arrival order."""
    node = NODES[pkg](os.path.join(tmp, "node"))
    await node.start()
    r = node.router
    try:
        lid = (await r.exec(node, "library.create", {"name": "subs"}))["uuid"]
        streams = {"invalidation.listen": (None, []), "notifications.listen": (None, []),
                   "jobs.progress": (lid, [])}

        async def consume(key, library_id, out):
            async for ev in r.subscribe(node, key, library_id=library_id):
                out.append(ev)

        tasks = [asyncio.ensure_future(consume(k, l, out)) for k, (l, out) in streams.items()]
        await asyncio.sleep(0.05)
        with pytest.raises(Exception) as e:
            r.subscribe(node, "tags.list", library_id=lid)
        assert e.value.code == 404
        await r.exec(node, "locations.create", {"path": corpus}, library_id=lid)
        await node.jobs.wait_idle()
        await r.exec(node, "tags.create", {"name": "sub"}, library_id=lid)
        await asyncio.sleep(0.3)
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        inv, notes, progress = (out for _l, out in streams.values())
        assert {"locations.list", "search.paths", "tags.list"} <= {i["key"] for i in inv}
        assert [n["data"]["job"] for n in notes] == ["media_processor"]
        assert {p.name for p in progress} == {"indexer", "file_identifier", "media_processor"}
        return {"library_id": lid,
                "invalidation.listen": sorted({(i["key"], i["library_id"], i["arg"])
                                               for i in inv}),
                "notifications.listen": notes,
                "jobs.progress": sorted({(p.name, str(p.library_id)) for p in progress})}
    finally:
        await node.shutdown()


def test_subscriptions_match_jax(tmp_path):
    _assert_equal_by_key(_both(tmp_path, _subscriptions_flow))


async def _status_flow(pkg, tmp, corpus, capsys):
    """A scanned library, then `status` on its data dir: the port's
    `python -m spacedrive_tpu_torch status --device cpu` or the JAX
    `sdx status` on the CPU; the printed JSON."""
    import argparse

    from spacedrive_tpu import cli as jcli
    from spacedrive_tpu_torch import cli as pcli

    data_dir = os.path.join(tmp, "node")
    node, lib, _loc = await _scanned_node(pkg, data_dir, corpus)
    n_files = lib.db.count("file_path")
    await node.shutdown()
    capsys.readouterr()
    if pkg == "jax":
        await jcli.cmd_status(argparse.Namespace(data_dir=data_dir, backend="cpu", no_p2p=True))
    else:
        await asyncio.to_thread(pcli.main, ["status", "--data-dir", data_dir, "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    (got,) = out["libraries"]
    assert got["file_paths"] == n_files
    assert [j["name"] for j in got["recent_jobs"]][:3] == \
        ["media_processor", "file_identifier", "indexer"]
    # each node mints its own id and keypair; the JAX one lists JAX's CPU
    # device and runs with P2P off
    for k in ("id", "identity", "accelerators", "device_model", "p2p"):
        out.pop(k)
    for job in got["recent_jobs"]:  # random job ids
        job["id"], job["parent_id"] = True, job["parent_id"] is not None
    return {"library_id": got["id"], "status": out}


def test_status_matches_sdx_status(tmp_path, capsys):
    _assert_equal_by_key(_both(tmp_path, _status_flow, capsys))


# --- sync.* and keys.* ---------------------------------------------------------


async def _sync_flow(pkg, tmp, corpus):
    """The four `sync.*` procedures through one package's router after a
    scan and a tag: `sync.newMessage` sees the tag's write, `messages`
    pages the op log oldest first, `backfill` covers the rows written
    without ops."""
    node, lib, _loc = await _scanned_node(pkg, os.path.join(tmp, "node"), corpus)
    r, lid = node.router, str(lib.id)
    out = {"library_id": lid}
    try:
        seen = []

        async def consume():
            async for ev in r.subscribe(node, "sync.newMessage", library_id=lid):
                seen.append(ev)

        task = asyncio.ensure_future(consume())
        await asyncio.sleep(0.05)
        await r.exec(node, "tags.create", {"name": "synced", "color": "#123456"},
                     library_id=lid)
        await asyncio.sleep(0.2)
        task.cancel()
        out["newMessage"] = seen
        out["enabled"] = await r.exec(node, "sync.enabled", library_id=lid)
        msgs = await r.exec(node, "sync.messages", {"count": 10_000}, library_id=lid)
        assert len(msgs) == lib.db.count("crdt_operation")
        assert [m["timestamp"] for m in msgs] == sorted(m["timestamp"] for m in msgs)
        out["messages"] = sorted((m["model"], next(iter(m["data"])),
                                  (m["data"].get("u") or {}).get("field")) for m in msgs)
        out["first_page"] = len(await r.exec(node, "sync.messages", library_id=lid))
        out["backfill"] = await r.exec(node, "sync.backfill", library_id=lid)
    finally:
        await node.shutdown()
    return out


def test_sync_procedures_match_jax(tmp_path):
    outs = _both(tmp_path, _sync_flow)
    _assert_equal_by_key(outs)
    assert outs["port"]["newMessage"] == ["Created"]
    # both media jobs write the four images' media_data rows without ops:
    # backfill covers them (a create and three fields each), as a pairing
    # owner's backfill does before a joiner pulls
    assert outs["port"]["backfill"] == 16 and outs["port"]["first_page"] == 100


async def _keys_flow(pkg, tmp, corpus):
    """`keys.*` through one package's router (light Argon2id): unlock an
    empty vault, add keys, mount / unmount / delete, lock and unlock
    again, a wrong password on a locked vault."""
    from spacedrive_tpu_torch.crypto import hashing as phashing
    from spacedrive_tpu.crypto import hashing as jhashing

    light = {"Argon2id": (1024, 1, 1)}
    node = NODES[pkg](os.path.join(tmp, "node"))
    await node.start()
    r = node.router
    mod = jhashing if pkg == "jax" else phashing
    saved = dict(mod._ARGON2)
    for p in mod.Params:
        mod._ARGON2[p] = light["Argon2id"]
    try:
        lid = (await r.exec(node, "library.create", {"name": "keys"}))["uuid"]
        out = {"library_id": lid}

        async def state():
            st = await r.exec(node, "keys.state", library_id=lid)
            return {"unlocked": st["unlocked"],
                    "keys": sorted((k["automount"], k["mounted"], k["algorithm"])
                                   for k in st["keys"])}

        out["locked"] = await state()
        out["unlock_empty"] = await r.exec(node, "keys.unlock", {"password": "hunter2"},
                                           library_id=lid)
        plain = (await r.exec(node, "keys.add", {"material": "ab" * 32}, library_id=lid))["uuid"]
        auto = (await r.exec(node, "keys.add", {"automount": True}, library_id=lid))["uuid"]
        out["added"] = await state()
        await r.exec(node, "keys.mount", plain, library_id=lid)
        out["mounted"] = await state()
        await r.exec(node, "keys.unmount", plain, library_id=lid)
        await r.exec(node, "keys.lock", library_id=lid)
        out["relocked"] = await state()
        with pytest.raises(Exception):
            await r.exec(node, "keys.unlock", {"password": "wrong"}, library_id=lid)
        out["after_wrong_on_locked"] = await state()
        out["unlock_again"] = await r.exec(node, "keys.unlock", {"password": "hunter2"},
                                           library_id=lid)
        out["unlocked"] = await state()
        await r.exec(node, "keys.delete", auto, library_id=lid)
        out["deleted"] = await state()
        with pytest.raises(Exception):
            await r.exec(node, "keys.add", {"material": "zz"}, library_id=lid)
    finally:
        mod._ARGON2.update(saved)
        await node.shutdown()
    return out


def test_keys_procedures_match_jax_but_for_the_added_automount_key(tmp_path):
    outs = _both(tmp_path, _keys_flow)
    port, jax = outs["port"], outs["jax"]
    # the one difference: the port mounts a key added with automount to an
    # unlocked vault at once; JAX mounts it at the next unlock
    assert port["added"] == {"unlocked": True, "keys": [[False, False, 0], [True, True, 0]]}
    assert jax["added"] == {"unlocked": True, "keys": [[False, False, 0], [True, False, 0]]}
    assert port["mounted"]["keys"] == [[False, True, 0], [True, True, 0]]
    for k in ("added", "mounted"):
        port.pop(k), jax.pop(k)
    _assert_equal_by_key(outs)
    assert port["unlock_again"] == {"automounted": 1}
    assert port["deleted"] == {"unlocked": True, "keys": [[False, False, 0]]}


def test_keys_unlock_wrong_password_retry_keeps_vault_intact(tmp_path):
    """What tests/test_api.py:572 asserts, through a port Node: a
    wrong-password `keys.unlock` retry on an unlocked vault keeps it
    unlocked with every mounted key mounted, and the true password still
    unlocks. The JAX router fails it: its `keys.add` with automount does
    not mount the key, so the first `mounted` check fails."""
    from spacedrive_tpu_torch.api.router import RspcError

    async def run():
        node = _port_node(os.path.join(tmp_path, "node"))
        await node.start()
        try:
            lib = await node.create_library("keys-lib")
            r = node.router
            lid = str(lib.id)
            await r.exec(node, "keys.unlock", {"password": "hunter2"}, library_id=lid)
            await r.exec(node, "keys.add", {"automount": True}, library_id=lid)
            st = await r.exec(node, "keys.state", None, library_id=lid)
            assert st["unlocked"] and st["keys"][0]["mounted"]

            with pytest.raises(RspcError):
                await r.exec(node, "keys.unlock", {"password": "wrong"}, library_id=lid)
            st = await r.exec(node, "keys.state", None, library_id=lid)
            assert st["unlocked"], "wrong-password retry locked the vault"
            assert all(k["mounted"] for k in st["keys"]), "wrong-password retry unmounted keys"
            # the true password still unlocks (master wasn't corrupted)
            out = await r.exec(node, "keys.unlock", {"password": "hunter2"}, library_id=lid)
            assert out is not None
        finally:
            await node.shutdown()

    asyncio.run(run())


# --- the labeler closes ------------------------------------------------------


async def _labelled_scan(pkg, tmp, corpus):
    from spacedrive_tpu_torch.models import provision

    data_dir = os.path.join(tmp, "node")
    provision.install_bundled(os.path.join(data_dir, "image_labeler"))
    if pkg == "jax":
        from spacedrive_tpu.node import Node

        node = Node(data_dir, use_device=False)
        node.config.config.p2p.enabled = False
    else:
        from spacedrive_tpu_torch.node.node import Node

        node = Node(data_dir, device="cpu")
        node.config.config.p2p.enabled = False
    await node.start()
    try:
        r = node.router
        lib = await r.exec(node, "library.create", {"name": "labelled"})
        lid = lib["uuid"]
        out = {"library_id": lid}
        sub = node.event_bus.subscribe()
        await r.exec(node, "locations.create", {"path": corpus}, library_id=lid)
        await node.jobs.wait_idle()
        library = node.libraries.libraries.get(uuid.UUID(lid))
        for _ in range(600):  # the actor labels after the media job settles
            if library.db.count("label_on_object") and not node.image_labeler._batch_pending:
                break
            await asyncio.sleep(0.05)
        await asyncio.sleep(0.2)
        keys = [ev[1].key for ev in sub.poll()
                if isinstance(ev, tuple) and ev[0] == EVENTS[pkg].INVALIDATE_OPERATION]
        out["labels.list invalidated"] = "labels.list" in keys
        out["state"] = await r.exec(node, "nodeState")
        out["labelled_objects"] = library.db.count("label_on_object") > 0
    finally:
        await node.shutdown()
    return out


def test_labelled_scan_invalidates_labels_and_names_the_version(tmp_path):
    outs = _both(tmp_path, _labelled_scan)
    for out in outs.values():
        assert out["labels.list invalidated"] and out["labelled_objects"]
    jstate, pstate = outs["jax"]["state"], outs["port"]["state"]
    assert pstate["image_labeler_version"] == jstate["image_labeler_version"] != "none"
    # each node mints its own id and keypair; the JAX one lists JAX's CPU
    # device, and runs with P2P off
    for k in ("id", "identity", "accelerators", "device_model", "p2p"):
        jstate.pop(k), pstate.pop(k)
    assert pstate == jstate
