"""The port's process pool (parallel/procpool.py, procworker.py).

- the cases of `tests/test_procpool.py` that apply to the port's
  stages: `SD_PROCS=0` spawns nothing, refcounted holds, echo and the
  worker gauge, payload purity, a worker error, a crash that restarts
  once and re-dispatches, a stall, a wedge the watchdog kills, the
  telemetry delta round trip, no double count on a retry;
- the workers import neither torch nor jax;
- the `embed.decode` and `phash.gray` planes are bit-identical to the
  JAX worker's `_stage_embed_decode` and `_stage_phash_gray` on seeded
  JPEG and PNG images, inline and through the pool;
- the `thumb.cpu` webp of every decodable kind (image, HEIF, video,
  PDF, SVG) equals inline `generate_one_cpu` and the JAX worker's stage,
  and a software-path actor (`use_device=False`) stores the same bytes
  with `SD_PROCS=0`, with `SD_PROCS=2`, with every pool job failing
  (the inline retry) and as the JAX actor; a Node on "cpu" takes that
  path in `index --library`, inline and on the pool;
- a media job and a duplicates job on `device="cpu"` with `SD_PROCS=2`
  equal `SD_PROCS=0` (cas_ids, media_data rows, pHash bits, groups and
  webp bytes exact, embeddings within 1e-5), also under
  `procpool.worker:crash:times=1`, and with every worker job failing
  (the call sites decode inline).

Every test runs `SD_PROCS=2` (or 1), stops the pool in teardown and
waits with a timeout of a few seconds.
"""

import asyncio
import os
import subprocess
import sys
import time

import numpy as np
import pytest
from PIL import Image

from test_pdf_svg import vector_pdf_bytes
from test_torch_decoders import CLIP, KINDS, _kinds

from spacedrive_tpu.object.media.thumbnail import Thumbnailer as JaxThumbnailer
from spacedrive_tpu.parallel import procworker as jworker
from spacedrive_tpu_torch import cli
from spacedrive_tpu_torch.node.library import Libraries
from spacedrive_tpu_torch.object.media.thumbnail import host as thumb_host
from spacedrive_tpu_torch.object.media.thumbnail.actor import Thumbnailer
from spacedrive_tpu_torch.parallel import procpool, procworker
from spacedrive_tpu_torch.telemetry.registry import MetricsRegistry
from spacedrive_tpu_torch.telemetry.snapshot import counter_value, gauge_value
from spacedrive_tpu_torch.utils import faults, msgpack_codec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 10.0  # every wait of these tests, far under REQUEST_TIMEOUT_S


@pytest.fixture(autouse=True)
def _clean_plane():
    faults.clear()
    yield
    faults.clear()
    # a test that forgot to balance its holds must not leak workers
    while procpool.POOL.running():
        procpool.POOL.stop()


@pytest.fixture
def pool(monkeypatch):
    monkeypatch.setenv("SD_PROCS", "2")
    assert procpool.POOL.start()
    try:
        procpool.POOL.warm(timeout=WAIT_S)
        yield procpool.POOL
    finally:
        procpool.POOL.stop()


def _wait_for(cond, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.02)
    return cond()


# --- lifecycle -------------------------------------------------------------


def test_sd_procs_zero_is_a_true_noop(monkeypatch):
    monkeypatch.setenv("SD_PROCS", "0")
    assert not procpool.enabled()
    assert procpool.POOL.start() is False
    assert procpool.get() is None
    assert gauge_value("sd_procpool_workers") == 0.0


@pytest.mark.parametrize("raw, want", [("0", 0), ("3", 3), ("-2", 0), ("junk", 0), ("999", 64)])
def test_sd_procs_parses_and_caps(monkeypatch, raw, want):
    monkeypatch.setenv("SD_PROCS", raw)
    assert procpool.procs() == want


def test_refcounted_start_stop(monkeypatch):
    monkeypatch.setenv("SD_PROCS", "1")
    assert procpool.POOL.start()
    assert procpool.POOL.start()  # a second node's hold
    procpool.POOL.stop()
    assert procpool.POOL.running(), "the first stop must not kill the survivor"
    assert procpool.get() is procpool.POOL
    procpool.POOL.stop()
    assert not procpool.POOL.running()
    assert procpool.get() is None
    assert gauge_value("sd_procpool_workers") == 0.0


def test_echo_roundtrip_and_worker_gauge(pool):
    assert gauge_value("sd_procpool_workers") == 2.0
    assert pool.worker_count() == 2
    payload = {"x": [1, 2, [3, None]], "b": b"\x00\xff", "f": 0.5, "neg": -7, "t": True}
    assert pool.request("echo", payload, timeout=WAIT_S) == payload
    assert counter_value("sd_procpool_jobs_total", result="ok") >= 1


async def test_run_awaits_on_the_loop(pool):
    import asyncio

    got = await asyncio.wait_for(pool.run("echo", {"loop": 1}), WAIT_S)
    assert got == {"loop": 1}
    with pytest.raises(procpool.ProcPoolError):
        await asyncio.wait_for(pool.run("no-such-stage", {}), WAIT_S)


def test_payload_purity_enforced_at_submit(pool):
    with pytest.raises(procpool.ProcPoolError):
        pool.submit("echo", {"db": object()})
    with pytest.raises(procpool.ProcPoolError):
        pool.submit("echo", {"arr": np.zeros(3)})


def test_worker_error_fails_future_pool_survives(pool):
    before = counter_value("sd_procpool_jobs_total", result="error")
    with pytest.raises(procpool.ProcPoolError, match="unknown procpool stage"):
        pool.request("no-such-stage", {}, timeout=WAIT_S)
    assert counter_value("sd_procpool_jobs_total", result="error") == before + 1
    assert pool.request("echo", {"ok": 1}, timeout=WAIT_S) == {"ok": 1}


def test_submit_after_stop_raises(monkeypatch):
    monkeypatch.setenv("SD_PROCS", "1")
    assert procpool.POOL.start()
    procpool.POOL.stop()
    with pytest.raises(procpool.ProcPoolError, match="not running"):
        procpool.POOL.submit("echo", {})


def test_concurrent_submits_from_many_threads_all_answer(pool):
    """12 threads (more than the cores) submit 20 jobs each through 2
    workers with a short switch interval: every future resolves to its
    own payload, and the ok counter moves by exactly the job count."""
    import threading

    ok0 = counter_value("sd_procpool_jobs_total", result="ok")
    results, errors = {}, []
    interval = sys.getswitchinterval()

    def client(t):
        try:
            futs = [(i, pool.submit("echo", {"t": t, "i": i})) for i in range(20)]
            for i, f in futs:
                results[(t, i)] = f.result(WAIT_S)
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(t,)) for t in range(12)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=2 * WAIT_S)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads) and not errors
    assert results == {(t, i): {"t": t, "i": i} for t in range(12) for i in range(20)}
    assert counter_value("sd_procpool_jobs_total", result="ok") == ok0 + 240


# --- crash, stall and wedge recovery ---------------------------------------


def test_crash_fault_restarts_once_and_redispatches(pool):
    # the kill races the echo answer: a worker that answers first leaves
    # nothing in flight to re-dispatch, so re-arm until the kill wins
    for _ in range(5):
        before = counter_value("sd_procpool_restarts_total")
        retried0 = counter_value("sd_procpool_jobs_total", result="retried")
        plan = faults.FaultPlan.parse("procpool.worker:crash:times=1", seed=3)
        with faults.active(plan):
            assert pool.request("echo", {"v": 42}, timeout=WAIT_S) == {"v": 42}
        assert plan.activations().get("procpool.worker") == 1
        assert _wait_for(lambda: counter_value("sd_procpool_restarts_total") >= before + 1)
        assert counter_value("sd_procpool_restarts_total") == before + 1
        assert _wait_for(lambda: pool.worker_count() == 2)
        if counter_value("sd_procpool_jobs_total", result="retried") > retried0:
            return
    pytest.fail("the kill never beat the echo answer in 5 attempts")


def test_stall_fault_delays_inside_worker(pool):
    plan = faults.FaultPlan.parse("procpool.worker:stall:times=1,delay_s=0.4", seed=3)
    t0 = time.monotonic()
    with faults.active(plan):
        assert pool.request("echo", {"s": 1}, timeout=WAIT_S) == {"s": 1}
    assert time.monotonic() - t0 >= 0.4


def test_watchdog_kills_a_wedged_worker(pool, monkeypatch):
    """A job stalled past WEDGE_TIMEOUT_S is a wedge: the watchdog kills
    its worker, the job is re-dispatched once (and stalls again), the
    second kill fails its future, and the pool keeps both workers."""
    default_wedge_s = procpool.WEDGE_TIMEOUT_S
    monkeypatch.setattr(procpool, "WEDGE_TIMEOUT_S", 0.3)
    monkeypatch.setattr(procpool, "_WATCHDOG_INTERVAL_S", 0.05)
    pool.stop()  # restart so the watchdog thread polls at the short cadence
    assert pool.start()
    restarts = counter_value("sd_procpool_restarts_total")
    plan = faults.FaultPlan.parse("procpool.worker:stall:times=1,delay_s=5", seed=3)
    t0 = time.monotonic()
    with faults.active(plan):
        with pytest.raises(procpool.ProcPoolError, match="died twice"):
            pool.request("echo", {"w": 1}, timeout=WAIT_S)
    assert time.monotonic() - t0 < 4
    assert _wait_for(lambda: counter_value("sd_procpool_restarts_total") == restarts + 2)
    assert _wait_for(lambda: pool.worker_count() == 2)
    # the restarted worker's first answer includes its spawn and imports,
    # which pass 0.3 s on a loaded host: the pool is held to serve after
    # the wedges under its own wedge timeout
    monkeypatch.setattr(procpool, "WEDGE_TIMEOUT_S", default_wedge_s)
    assert pool.request("echo", {"after": 1}, timeout=WAIT_S) == {"after": 1}


# --- telemetry delta merge -------------------------------------------------


def test_delta_capture_diff_merge_roundtrip():
    """What a worker accumulates equals what the owner holds after the
    merge (counters, histogram sums, buckets, the recent ring), and the
    delta survives the port's codec, as it does on the wire."""
    worker, owner = MetricsRegistry(), MetricsRegistry()
    for reg in (worker, owner):
        reg.counter("sd_t_total", "t", labels=("result",))
        reg.histogram("sd_t_seconds", "t")
    base = worker.delta_capture()
    worker.get("sd_t_total").inc(3, result="ok")
    worker.get("sd_t_total").inc(1, result="err")
    worker.get("sd_t_seconds").observe(0.5)
    worker.get("sd_t_seconds").observe(2.0)
    delta = worker.delta_diff(base, worker.delta_capture())
    owner.merge_delta(msgpack_codec.unpackb(msgpack_codec.packb(delta)))
    assert owner.get("sd_t_total").value(result="ok") == 3
    assert owner.get("sd_t_total").value(result="err") == 1
    stats = owner.get("sd_t_seconds").stats()
    assert stats["count"] == 2 and stats["sum"] == pytest.approx(2.5)
    assert owner.get("sd_t_seconds").recent() == [0.5, 2.0]
    base2 = worker.delta_capture()
    worker.get("sd_t_total").inc(2, result="ok")
    owner.merge_delta(worker.delta_diff(base2, worker.delta_capture()))
    assert owner.get("sd_t_total").value(result="ok") == 5


def test_no_double_count_on_crash_retry(pool):
    """A job whose worker died never answered: the re-dispatched run
    counts once as ok and once as a round trip."""
    for _ in range(5):
        ok0 = counter_value("sd_procpool_jobs_total", result="ok")
        retried0 = counter_value("sd_procpool_jobs_total", result="retried")
        rt0 = procpool._tm.PROCPOOL_ROUNDTRIP_SECONDS.stats()["count"]
        plan = faults.FaultPlan.parse("procpool.worker:crash:times=1", seed=7)
        with faults.active(plan):
            assert pool.request("echo", {"n": 1}, timeout=WAIT_S) == {"n": 1}
        assert counter_value("sd_procpool_jobs_total", result="ok") == ok0 + 1
        assert procpool._tm.PROCPOOL_ROUNDTRIP_SECONDS.stats()["count"] == rt0 + 1
        assert _wait_for(lambda: pool.worker_count() == 2)
        if counter_value("sd_procpool_jobs_total", result="retried") == retried0 + 1:
            return
    pytest.fail("the kill never beat the echo answer in 5 attempts")


# --- frames and the codec --------------------------------------------------


def test_frames_round_trip_and_bound_the_size(tmp_path):
    path = tmp_path / "frames"
    blobs = [b"", b"x", os.urandom(70_000)]
    with open(path, "wb") as f:
        for b in blobs:
            procworker.write_frame(f, b)
    with open(path, "rb") as f:
        assert [procworker.read_frame(f) for _ in blobs] == blobs
        assert procworker.read_frame(f) is None
    with open(path, "wb") as f:
        f.write(procworker._HDR.pack(procworker.MAX_FRAME + 1))
    with open(path, "rb") as f, pytest.raises(ValueError, match="exceeds"):
        procworker.read_frame(f)
    with open(path, "wb") as f:
        f.write(procworker._HDR.pack(10) + b"abc")
    with open(path, "rb") as f, pytest.raises(EOFError):
        procworker.read_frame(f)


def test_codec_packs_a_32_path_embed_reply_in_milliseconds():
    planes = [np.random.default_rng(i).random((32, 32, 3), np.float32).tobytes()
              for i in range(32)]
    reply = {"planes": planes[:31] + [None]}
    t0 = time.perf_counter()
    blob = msgpack_codec.packb(reply)
    back = msgpack_codec.unpackb(blob)
    elapsed = time.perf_counter() - t0
    assert back == reply and len(planes[0]) == 12288
    assert elapsed < 0.05, elapsed
    big = {"b": b"\x01" * (procworker.MAX_FRAME // 2), "nested": [[{"k": None}]]}
    assert msgpack_codec.unpackb(msgpack_codec.packb(big)) == big


# --- the workers import neither torch nor jax ------------------------------


def test_worker_and_its_stages_import_no_torch_or_jax(tmp_path):
    img = tmp_path / "a.png"
    Image.fromarray(np.zeros((40, 30, 3), np.uint8)).save(img)
    pdf = tmp_path / "v.pdf"
    pdf.write_bytes(vector_pdf_bytes())
    clip = CLIP
    code = (
        "import sys\n"
        "from spacedrive_tpu_torch.parallel import procworker\n"
        "import spacedrive_tpu_torch.models.embed_decode, spacedrive_tpu_torch.ops.phash_gray\n"
        "import spacedrive_tpu_torch.telemetry.metrics, spacedrive_tpu_torch.utils.faults\n"
        "import spacedrive_tpu_torch.object.media.thumbnail.host, spacedrive_tpu_torch.native.video\n"
        "import spacedrive_tpu_torch.object.media.pdf, spacedrive_tpu_torch.object.media.pdf_raster\n"
        "import spacedrive_tpu_torch.object.media.pdf_fonts, spacedrive_tpu_torch.object.media.svg\n"
        "import spacedrive_tpu_torch.ops.thumbnail_dims\n"
        f"r = procworker._stage_embed_decode({{'paths': [{str(img)!r}]}})\n"
        "assert r['planes'][0] is not None\n"
        f"r = procworker._stage_phash_gray({{'path': {str(img)!r}, 'thumb_path': None}})\n"
        "assert r['gray'] is not None\n"
        f"r = procworker._stage_thumb_cpu({{'path': {str(img)!r}, 'ext': 'png'}})\n"
        "assert r['webp'][:4] == b'RIFF' and r['error'] is None\n"
        f"r = procworker._stage_thumb_cpu({{'path': {str(pdf)!r}, 'ext': 'pdf'}})\n"
        "assert r['webp'][:4] == b'RIFF' and r['error'] is None\n"
        f"r = procworker._stage_thumb_cpu({{'path': {str(clip)!r}, 'ext': 'mp4'}})\n"
        "assert r['webp'][:4] == b'RIFF' and r['error'] is None\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax', 'jaxlib'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# --- the stages against the JAX worker's -----------------------------------


def _images(root, seed=0, n=6):
    """Seeded JPEG and PNG images (one undecodable file among them)."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    paths = []
    for i in range(n):
        h, w = int(rng.integers(40, 300)), int(rng.integers(40, 300))
        arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        ext = "jpg" if i % 2 else "png"
        path = root / f"img{i}.{ext}"
        Image.fromarray(arr).save(path, quality=90) if ext == "jpg" else Image.fromarray(arr).save(path)
        paths.append(str(path))
    (root / "broken.jpg").write_bytes(b"not an image")
    return paths + [str(root / "broken.jpg")]


@pytest.mark.parametrize("job_max", [64, 2])
def test_embed_decode_splits_the_chunk_over_the_workers(tmp_path, pool, monkeypatch, job_max):
    """The media job's decode leg ships one job per worker (at most
    EMBED_DECODE_JOB_MAX files each) and returns the inline planes, in
    order, the undecodable file's slot None."""
    from spacedrive_tpu_torch.object.media import job as media_job

    monkeypatch.setattr(media_job, "EMBED_DECODE_JOB_MAX", job_max)
    paths = _images(tmp_path / "imgs")
    inline = [media_job._embedder.decode_image(p) for p in paths]
    ok0 = counter_value("sd_procpool_jobs_total", result="ok")
    got = media_job.MediaProcessorJob._decode_for_embed(paths)
    jobs = counter_value("sd_procpool_jobs_total", result="ok") - ok0
    assert jobs == -(-len(paths) // min(-(-len(paths) // 2), job_max))
    assert len(got) == len(inline) and got[-1] is None and inline[-1] is None
    assert all(np.array_equal(a, b) for a, b in zip(got[:-1], inline[:-1]))


def test_stage_planes_equal_jax_inline_and_pooled(tmp_path, pool):
    paths = _images(tmp_path / "imgs")
    want = jworker._stage_embed_decode({"paths": paths})
    assert procworker._stage_embed_decode({"paths": paths}) == want
    assert pool.request("embed.decode", {"paths": paths}, rows=len(paths), timeout=WAIT_S) == want
    assert want["planes"][-1] is None and all(p is not None for p in want["planes"][:-1])
    thumb = paths[0]
    for payload in ([{"path": p, "thumb_path": None} for p in paths]
                    + [{"path": paths[-1], "thumb_path": thumb},   # fallback to the thumbnail
                       {"path": str(tmp_path / "gone.jpg"), "thumb_path": None},
                       {"path": None, "thumb_path": None}]):
        want = jworker._stage_phash_gray(payload)
        assert procworker._stage_phash_gray(payload) == want
        assert pool.request("phash.gray", payload, timeout=WAIT_S) == want


@pytest.mark.parametrize("name", KINDS)
def test_thumb_cpu_equals_inline_and_jax(tmp_path, pool, name):
    kinds = _kinds(tmp_path)
    if name not in kinds:
        pytest.skip(f"{name}: its decoder's library is unavailable here")
    path, ext = kinds[name]
    payload = {"path": path, "ext": ext}
    inline = thumb_host.generate_one_cpu(path, ext)
    assert procworker._stage_thumb_cpu(payload) == {"webp": inline, "error": None}
    assert pool.request("thumb.cpu", payload, timeout=WAIT_S) == {"webp": inline, "error": None}
    assert jworker._stage_thumb_cpu(payload)["webp"] == inline


def test_thumb_cpu_reports_an_undecodable_file(tmp_path, pool):
    bad = tmp_path / "broken.pdf"
    bad.write_bytes(b"%PDF-1.4 nothing")
    got = pool.request("thumb.cpu", {"path": str(bad), "ext": "pdf"}, timeout=WAIT_S)
    assert got["webp"] is None and got["error"].startswith("ThumbError")


async def _software_thumbs(actor, entries):
    batch_id = actor.new_indexed_thumbnails_batch("lib", entries)
    await asyncio.wait_for(actor.wait_batch(batch_id), 120)
    out = {}
    for cas_id, _path, _ext in entries:
        p = actor.store.path_for("lib", cas_id)
        if os.path.exists(p):
            with open(p, "rb") as f:
                out[cas_id] = f.read()
    return out


async def _jax_software_thumbs(data_dir, entries):
    actor = JaxThumbnailer(data_dir, use_device=False)
    try:
        await asyncio.wait_for(actor.wait_batch(
            actor.new_indexed_thumbnails_batch("lib", entries)), 120)
    finally:
        await actor.shutdown()
    out = {}
    for cas_id, _path, _ext in entries:
        p = actor.store.path_for("lib", cas_id)
        if os.path.exists(p):
            with open(p, "rb") as f:
                out[cas_id] = f.read()
    return out


@pytest.mark.parametrize("leg", ["pool", "pool_failing"])
async def test_software_actor_stores_the_same_bytes_inline_and_pooled(tmp_path, monkeypatch, leg):
    """`use_device=False`: every kind takes the software path; the bytes
    stored with SD_PROCS=0, with SD_PROCS=2 (`thumb.cpu`, one job per
    file) and with every pool job failing (the inline retry) are equal,
    and equal the JAX actor's with use_device=False."""
    (tmp_path / "in").mkdir()
    kinds = _kinds(tmp_path / "in")
    (tmp_path / "in" / "broken.pdf").write_bytes(b"%PDF-1.4 nothing")
    kinds["broken.pdf"] = (str(tmp_path / "in" / "broken.pdf"), "pdf")
    entries = [(f"{i:016x}", path, ext) for i, (path, ext) in enumerate(kinds.values(), 1)]

    monkeypatch.setenv("SD_PROCS", "0")
    inline_actor = Thumbnailer(tmp_path / "inline", device="cpu", use_device=False)
    try:
        inline = await _software_thumbs(inline_actor, entries)
    finally:
        await inline_actor.shutdown()
    assert len(inline) == len(entries) - 1 and inline_actor.errors == 1
    for cas_id, path, ext in entries[:-1]:
        assert inline[cas_id] == thumb_host.generate_one_cpu(path, ext)

    monkeypatch.setenv("SD_PROCS", "2")
    assert procpool.POOL.start()
    try:
        procpool.POOL.warm(timeout=WAIT_S)
        if leg == "pool_failing":
            async def fail(*a, **k):
                raise procpool.ProcPoolError("injected")

            monkeypatch.setattr(procpool.POOL, "run", fail)
        ok0 = counter_value("sd_procpool_jobs_total", result="ok")
        pooled_actor = Thumbnailer(tmp_path / "pooled", device="cpu", use_device=False)
        assert pooled_actor._pool() is procpool.POOL
        assert Thumbnailer(tmp_path / "card", device="cpu")._pool() is None
        try:
            pooled = await _software_thumbs(pooled_actor, entries)
        finally:
            await pooled_actor.shutdown()
        jobs = counter_value("sd_procpool_jobs_total", result="ok") - ok0
    finally:
        procpool.POOL.stop()
    assert pooled == inline and pooled_actor.errors == 1
    assert jobs == (len(entries) if leg == "pool" else 0)
    assert await _jax_software_thumbs(str(tmp_path / "jax"), entries) == inline


@pytest.mark.parametrize("procs", ["0", "2"])
async def test_a_cpu_node_thumbnails_through_the_software_path(tmp_path, monkeypatch, procs):
    """A Node on "cpu" gives its thumbnailer `use_device=False`, as the
    JAX CLI's `--backend cpu` does, and a Node on "cuda" keeps the device
    path. `index --library` on the CPU then stores, for every decodable
    kind, the bytes of `generate_one_cpu` (the JAX software path's):
    inline with `SD_PROCS=0`, one `thumb.cpu` job a file with 2."""
    from spacedrive_tpu_torch.node.node import Node
    from spacedrive_tpu_torch.object.media.thumbnail.store import ThumbnailStore

    assert Node(tmp_path / "c", device="cpu", with_labeler=False).thumbnailer.use_device is False
    assert Node(tmp_path / "g", device="cuda", with_labeler=False).thumbnailer.use_device is True
    (tmp_path / "in").mkdir()
    kinds = _kinds(tmp_path / "in")
    monkeypatch.setenv("SD_PROCS", procs)
    stages = []
    run = procpool.POOL.run

    async def recording_run(stage, payload, *args, **kwargs):
        stages.append(stage)
        return await run(stage, payload, *args, **kwargs)

    monkeypatch.setattr(procpool.POOL, "run", recording_run)
    data = tmp_path / "data"
    summary = await cli.index_library(str(tmp_path / "in"), str(data), "sw", "cpu",
                                      no_p2p=True)
    # the tree also holds files no kind decodes (a truncated clip)
    dispatched = sum(thumb_host.can_generate(f.rsplit(".", 1)[-1])
                     for f in os.listdir(tmp_path / "in"))
    assert summary["thumbnails"] == len(kinds) < dispatched
    assert stages.count("thumb.cpu") == (dispatched if procs == "2" else 0)
    (lib,) = Libraries(str(data)).load_all()
    try:
        cas_of = {os.path.join(str(tmp_path / "in"), r["name"] + "." + r["extension"]): r["cas_id"]
                  for r in lib.db.query("SELECT * FROM file_path WHERE is_dir = 0")}
        lib_id = str(lib.id)
    finally:
        lib.close()
    store = ThumbnailStore(str(data / "thumbnails"))
    for path, ext in kinds.values():
        with open(store.path_for(lib_id, cas_of[path]), "rb") as f:
            assert f.read() == thumb_host.generate_one_cpu(path, ext), path


# --- the media job and the duplicates job, pooled against inline ----------


def _corpus(root):
    _images(root / "pics", seed=3, n=7)
    rng = np.random.default_rng(4)
    (root / "docs").mkdir()
    (root / "docs" / "a.txt").write_bytes(b"hello procs")
    (root / "docs" / "b.txt").write_bytes(b"hello procs")  # same content
    (root / "big.bin").write_bytes(rng.integers(0, 256, 300_000, dtype=np.uint8).tobytes())
    (root / "pics" / "copy.png").write_bytes((root / "pics" / "img0.png").read_bytes())


async def _library_run(corpus, data_dir):
    """`index --library` then `duplicates` on the CPU; everything the
    equality covers."""
    await cli.index_library(str(corpus), str(data_dir), "pool", "cpu", no_p2p=True)
    groups = await cli.duplicates_library(str(data_dir), "pool", 8, "cpu")
    (lib,) = Libraries(str(data_dir)).load_all()
    try:
        db = lib.db
        cas_of = {r["id"]: r["cas_id"] for r in db.query(
            "SELECT o.id, fp.cas_id FROM object o JOIN file_path fp ON fp.object_id = o.id")}
        out = {
            "cas": {(r["materialized_path"], r["name"], r["extension"]): r["cas_id"]
                    for r in db.query("SELECT * FROM file_path WHERE is_dir = 0")},
            "objects": db.count("object"),
            "media_data": sorted(
                (cas_of[r["object_id"]],) + tuple((k, r[k]) for k in sorted(r.keys())
                                                  if k not in ("id", "object_id"))
                for r in db.query("SELECT * FROM media_data")),
            "phash": {cas_of[r["id"]]: bytes(r["phash"])
                      for r in db.query("SELECT id, phash FROM object WHERE phash IS NOT NULL")},
            "groups": sorted((g["kind"], sorted(cas_of[o] for o in g["object_ids"]))
                             for g in groups),
            "vectors": {cas_of[r["object_id"]]: np.frombuffer(r["vector"], "<f4")
                        for r in db.query("SELECT object_id, vector FROM object_embedding")},
        }
        thumbs = {}
        for dirpath, _, files in os.walk(os.path.join(str(data_dir), "thumbnails")):
            for f in files:
                if f.endswith(".webp"):
                    with open(os.path.join(dirpath, f), "rb") as fh:
                        thumbs[f] = fh.read()
        out["thumbs"] = thumbs
    finally:
        lib.close()
    return out


def _assert_same(got, want):
    for key in ("cas", "objects", "media_data", "phash", "groups", "thumbs"):
        assert got[key] == want[key], key
    assert got["vectors"].keys() == want["vectors"].keys()
    for k, v in want["vectors"].items():
        np.testing.assert_allclose(got["vectors"][k], v, atol=1e-5, rtol=0)


@pytest.mark.parametrize("plan", [None, "procpool.worker:crash:times=1",
                                  "procpool.worker:crash:times=inf"])
async def test_library_pass_pooled_equals_inline(tmp_path, monkeypatch, plan):
    """SD_PROCS=2 against SD_PROCS=0: the same rows, bits, groups, webp
    bytes and vectors; under a crash the pool restarts once; with every
    job killed twice the call sites decode inline."""
    corpus = tmp_path / "corpus"
    _corpus(corpus)
    monkeypatch.setenv("SD_PROCS", "0")
    golden = await _library_run(corpus, tmp_path / "inline")
    assert len(golden["vectors"]) == 7 and len(golden["phash"]) == 7
    assert golden["objects"] < len(golden["cas"])  # the copies share objects

    monkeypatch.setenv("SD_PROCS", "2")
    ok0 = counter_value("sd_procpool_jobs_total", result="ok")
    restarts0 = counter_value("sd_procpool_restarts_total")
    errors0 = counter_value("sd_procpool_jobs_total", result="error")
    retried0 = counter_value("sd_procpool_jobs_total", result="retried")
    fault_plan = faults.FaultPlan.parse(plan or "", seed=11)
    with faults.active(fault_plan if plan else None):
        pooled = await _library_run(corpus, tmp_path / "pooled")
    assert not procpool.POOL.running(), "the nodes released every hold"
    _assert_same(pooled, golden)
    jobs_ok = counter_value("sd_procpool_jobs_total", result="ok") - ok0
    restarts = counter_value("sd_procpool_restarts_total") - restarts0
    if plan is None:
        # the chunk's embed.decode split over the 2 workers, one
        # phash.gray job a row
        assert jobs_ok >= 2 + 7 and restarts == 0
        assert counter_value("sd_procpool_jobs_total", result="error") == errors0
    elif plan.endswith("times=1"):
        assert fault_plan.activations() == {"procpool.worker": 1}
        assert restarts == 1 and jobs_ok >= 2 + 7
    else:
        # every submit kills its worker: jobs die, are retried once, and
        # those that die twice fail to the inline decode, all counted
        assert fault_plan.activations()["procpool.worker"] >= 2
        assert restarts >= 2
        assert counter_value("sd_procpool_jobs_total", result="retried") > retried0
