"""The port's trace context against the JAX package's (tests/test_trace.py
pointed at the port).

- context and span identity: nesting, the ambient context, the wire
  form and its tolerant decode, the Chrome-trace export's shape;
- the same scripted span sequence, with the ids and clocks injected
  into both packages, gives equal `trace.export()` documents, equal
  recent-span records and equal flight-recorder events (`trace_id`
  stamped, the slow-op watchdog);
- a port `Node(device="cpu")` scan puts `walk`, `identify.hash`,
  `identify.db`, `task.dispatch`, `feeder.fetch` and `thumbnail.decode`
  under one trace id;
- a paused job serialises its trace and resumes in it, and its
  `serialize_state` bytes equal JAX's for the same job;
- the window pipeline's producer and its restart join the trace of the
  code that built the pipeline; a thumbnail batch persists its trace
  in the JAX package's state-file bytes;
- the p2p header hop: a SYNC or SPACEDROP header carries the
  initiator's context over the wire, and the responder's span records
  under its trace id.

tests/test_trace.py's ingest actor case is in
tests/test_torch_sync_ingest.py.
"""

import asyncio
import collections
import json
import os
import uuid

import numpy as np
import pytest
from PIL import Image

import spacedrive_tpu.telemetry as jtelemetry
from spacedrive_tpu.telemetry import events as jevents
from spacedrive_tpu.telemetry import spans as jspans
from spacedrive_tpu.telemetry import trace as jtrace
from spacedrive_tpu_torch import telemetry
from spacedrive_tpu_torch.telemetry import events, spans, trace

PIPELINE = {"walk", "identify.hash", "identify.db", "task.dispatch", "feeder.fetch",
            "thumbnail.decode"}


@pytest.fixture(autouse=True)
def _reset():
    """Both packages' telemetry is process-wide: each test starts and
    leaves it clean, so no span outlives the test that made it."""
    telemetry.reset()
    jtelemetry.reset()
    yield
    telemetry.reset()
    jtelemetry.reset()


# --- unit: context + span identity ------------------------------------------


def test_nested_spans_share_trace_and_parent():
    with telemetry.span("outer") as outer:
        with telemetry.span("inner") as inner:
            pass
    assert outer.trace_id and outer.parent_id is None
    assert inner.trace_id == outer.trace_id
    assert inner.parent_id == outer.span_id
    assert inner.path == "outer.inner"


def test_root_span_adopts_ambient_context():
    ctx = trace.new_context()
    with trace.use(ctx):
        with telemetry.span("child") as sp:
            pass
    assert sp.trace_id == ctx.trace_id
    assert sp.parent_id == ctx.span_id
    assert trace.current() is None
    with trace.use(None) as none:  # a no-op, so call sites need not branch
        assert none is None and trace.current() is None


def test_trace_context_wire_roundtrip_and_tolerant_decode():
    ctx = trace.new_context()
    back = trace.TraceContext.from_wire(ctx.to_wire())
    assert back.trace_id == ctx.trace_id and back.span_id == ctx.span_id
    assert len(ctx.trace_id) == 32 and len(ctx.span_id) == 16
    for garbage in (None, {}, [], "x", {"trace_id": 1, "span_id": 2}, {"trace_id": "a"}):
        assert trace.TraceContext.from_wire(garbage) is None
        assert jtrace.TraceContext.from_wire(garbage) is None


def test_chrome_trace_export_shape():
    with telemetry.span("export_probe", nbytes=42):
        pass
    doc = json.loads(json.dumps(telemetry.trace_export()))
    probe = [e for e in doc["traceEvents"] if e["name"] == "export_probe"]
    assert probe, doc
    e = probe[0]
    assert e["ph"] == "X" and e["dur"] >= 1 and e["ts"] > 0
    assert isinstance(e["pid"], int) and isinstance(e["tid"], int)
    assert e["args"]["trace_id"] and e["args"]["span_id"]
    assert e["args"]["bytes"] == 42
    only = telemetry.trace_export(e["args"]["trace_id"])["traceEvents"]
    assert all(ev["args"]["trace_id"] == e["args"]["trace_id"] for ev in only if ev["ph"] == "X")


def test_a_span_reraises_what_its_body_raised():
    with pytest.raises(KeyError):
        with telemetry.span("boom"):
            raise KeyError("x")
    (rec,) = trace.recent()
    assert rec["stage"] == "boom" and rec["error"] == "KeyError"


# --- scripted sequences: the port's records equal JAX's ----------------------


class _Clock:
    """time.time / perf_counter / monotonic that advance 0.25 s a read."""

    def __init__(self):
        self.t = 1_700_000_000.0

    def _tick(self):
        self.t += 0.25
        return self.t

    def time(self):
        return self._tick()

    def perf_counter(self):
        return self._tick()

    def monotonic(self):
        return self._tick()


def _inject(monkeypatch, trace_mod, spans_mod, events_mod):
    ids = iter(range(1, 10_000))
    monkeypatch.setattr(trace_mod, "new_trace_id", lambda: f"{next(ids):032x}")
    monkeypatch.setattr(trace_mod, "new_span_id", lambda: f"{next(ids):016x}")
    clock = _Clock()
    monkeypatch.setattr(spans_mod, "time", clock)
    monkeypatch.setattr(events_mod, "time", clock)


async def _script(telemetry_mod, trace_mod, events_mod):
    with telemetry_mod.span("walk", nbytes=10) as walk:
        walk.annotate(journal_hit=3, journal_miss=1)
        events_mod.ring("jobs").emit("queued", job="x")
        with telemetry_mod.span("hash", nbytes=57352):
            pass
    with trace_mod.use(trace_mod.TraceContext("f" * 32, "e" * 16)):
        async with telemetry_mod.span("identify") as ident:
            with telemetry_mod.span("db"):
                pass
            ident.add_bytes(7)
        try:
            with telemetry_mod.span("fails"):
                raise ValueError("no")
        except ValueError:
            pass
    # a slow span (the clock moves 0.25 s a read) fires the watchdog
    with telemetry_mod.span("slow"):
        for _ in range(5):
            events_mod.time.time()
    trace_mod.record_span({"stage": "task.dispatch", "seconds": 0.5, "t0": 1.0e9,
                           "trace_id": "a" * 32, "span_id": "b" * 16, "parent_id": None})


def test_scripted_spans_export_as_jax(monkeypatch):
    _inject(monkeypatch, trace, spans, events)
    _inject(monkeypatch, jtrace, jspans, jevents)
    asyncio.run(_script(telemetry, trace, events))
    asyncio.run(_script(jtelemetry, jtrace, jevents))
    assert trace.export() == jtrace.export()
    assert trace.export("f" * 32) == jtrace.export("f" * 32)
    assert telemetry.recent_spans() == jtelemetry.recent_spans()
    for ring in ("jobs", "watchdog"):
        assert events.ring(ring).snapshot() == jevents.ring(ring).snapshot(), ring
    (queued,) = events.JOB_EVENTS.snapshot()
    assert queued["trace_id"] == f"{1:032x}"  # emitted inside the walk span
    slow = [e for e in events.WATCHDOG_EVENTS.snapshot() if e["fields"]["stage"] == "slow"]
    assert slow and slow[0]["fields"]["seconds"] > 1.0
    for name in ("sd_span_seconds", "sd_span_bytes_total"):
        assert telemetry.REGISTRY.snapshot()[name] == jtelemetry.REGISTRY.snapshot()[name]


def test_events_outside_a_trace_carry_no_trace_id():
    events.ring("test-notrace").emit("x", a=1)
    (e,) = events.ring("test-notrace").snapshot()
    assert "trace_id" not in e


# --- e2e: one port scan = one trace -----------------------------------------


def _corpus(root, n_files=6):
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(0)
    for i in range(n_files):
        with open(os.path.join(root, f"f{i}.bin"), "wb") as f:
            f.write(rng.integers(0, 256, 2048 if i % 2 else 150_000, dtype=np.uint8).tobytes())
    Image.new("RGB", (48, 32), (10, 200, 30)).save(os.path.join(root, "img.png"))
    return root


async def _scan(data_dir, corpus, device="cpu"):
    from spacedrive_tpu_torch.location.locations import LocationCreateArgs, scan_location
    from spacedrive_tpu_torch.node.node import Node

    node = Node(data_dir, device=device, with_labeler=False)
    await node.start()
    try:
        lib = await node.create_library("trace-lib")
        loc = LocationCreateArgs(path=corpus).create(lib)
        await scan_location(lib, loc, node.jobs, backend=str(node.device))
        await node.jobs.wait_idle()
        await node.thumbnailer.wait_library_batch(str(lib.id))
        jobs = {r["name"]: r for r in lib.db.query("SELECT name, data FROM job")}
        return lib, jobs
    finally:
        await node.shutdown()


def test_index_pass_yields_single_trace_across_pipeline(tmp_path):
    """The acceptance trace on the port: walk → identify (hash + db) →
    thumbnail under ONE trace id, through the task-dispatch boundary and
    the feeder's producer thread."""
    corpus = _corpus(os.path.join(tmp_path, "corpus"))
    asyncio.run(_scan(os.path.join(tmp_path, "node"), corpus))
    stages_by_trace = collections.defaultdict(set)
    for rec in trace.recent():
        stages_by_trace[rec["trace_id"]].add(rec["stage"])
    full = [tid for tid, stages in stages_by_trace.items() if PIPELINE <= stages]
    assert len(full) == 1, dict(stages_by_trace)
    # the jobs ring saw the chain settle
    jobs = [e for e in events.JOB_EVENTS.snapshot() if e["type"] == "settled"]
    assert {e["fields"]["job"] for e in jobs} >= {"indexer", "file_identifier",
                                                  "media_processor"}


# --- suspend/resume continues the trace ---------------------------------------


def test_job_pause_serialize_resume_keeps_trace(tmp_path):
    from spacedrive_tpu_torch.jobs import JobManager
    from spacedrive_tpu_torch.jobs.job import StatefulJob, StepResult
    from spacedrive_tpu_torch.jobs.manager import JOB_REGISTRY
    from spacedrive_tpu_torch.node.library import Libraries
    from spacedrive_tpu_torch.tasks import TaskSystem

    span_traces = []

    class SlowJob(StatefulJob):
        NAME = "trace_slow"

        async def init_job(self, ctx):
            for _ in range(20):
                self.steps.append({})

        async def execute_step(self, ctx, step, n):
            with telemetry.span("slowstep") as sp:
                span_traces.append(sp.trace_id)
            await asyncio.sleep(0.02)
            return StepResult()

    async def run():
        libs = Libraries(tmp_path)
        library = libs.create("trace-resume")
        mgr = JobManager(TaskSystem(2))
        job = SlowJob()
        await mgr.ingest(job, library)
        original = job.trace_ctx
        assert original is not None
        await asyncio.sleep(0.05)
        await mgr.pause(job.id)
        report = library.db.find_one("job", id=job.id.bytes)
        assert report is not None and report["data"]
        resumed = StatefulJob.deserialize_state(report["data"], JOB_REGISTRY)
        assert resumed.trace_ctx.trace_id == original.trace_id
        # cold resume (a fresh manager: a process restart) continues it
        await mgr.system.shutdown()
        before = len(span_traces)
        mgr2 = JobManager(TaskSystem(2))
        assert await mgr2.cold_resume(library) == 1
        await mgr2.wait(job.id)
        assert len(span_traces) > before
        assert set(span_traces) == {original.trace_id}
        await mgr2.system.shutdown()
        library.close()

    JOB_REGISTRY[SlowJob.NAME] = SlowJob
    try:
        asyncio.run(run())
    finally:
        JOB_REGISTRY.pop(SlowJob.NAME, None)


@pytest.mark.parametrize("traced", [True, False])
def test_serialized_job_state_equals_jax(traced):
    """The same job state, trace included, packs to JAX's bytes."""
    from spacedrive_tpu.jobs.job import StatefulJob as JStatefulJob
    from spacedrive_tpu_torch.jobs.job import StatefulJob

    def make(base, tmod):
        class J(base):
            NAME = "trace_bytes"

            async def init_job(self, ctx):
                pass

            async def execute_step(self, ctx, step, n):
                pass

        job = J({"location_id": 3, "backend": "cpu"})
        job.id = uuid.UUID(int=7)
        job.data = {"cursor": 12, "chunk_size": 100}
        job.steps.extend([{"kind": "identify"}, {"kind": "identify"}])
        job.step_number = 1
        job.run_metadata = {"hash_time": 0.5}
        job.initialized = True
        if traced:
            job.trace_ctx = tmod.TraceContext("c" * 32, "d" * 16)
        child = J({"location_id": 3})
        child.id = uuid.UUID(int=8)
        child.trace_ctx = job.trace_ctx
        job.next_jobs = [child]
        return job

    got = make(StatefulJob, trace).serialize_state()
    assert got == make(JStatefulJob, jtrace).serialize_state()
    back = StatefulJob.deserialize_state(got, {"trace_bytes": type(make(StatefulJob, trace))})
    assert (back.trace_ctx.trace_id if traced else back.trace_ctx) == ("c" * 32 if traced
                                                                       else None)
    assert back.next_jobs[0].trace_ctx is not None or not traced



# --- the p2p header hop ----------------------------------------------------------


class _PipeStream:
    """Loopback stream: write() appends, read_exact() blocks."""

    def __init__(self):
        self._buf = bytearray()
        self._event = asyncio.Event()

    async def write(self, data: bytes) -> None:
        self._buf += data
        self._event.set()

    async def read_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            self._event.clear()
            await self._event.wait()
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out


def test_sync_header_carries_trace_and_responder_joins_it():
    from spacedrive_tpu_torch.p2p.block import BlockSize, SpaceblockRequest, SpaceblockRequests
    from spacedrive_tpu_torch.p2p.protocol import Header, HeaderType

    async def run():
        telemetry.reset()
        initiator_ctx = trace.new_context()
        pipe = _PipeStream()
        with trace.use(initiator_ctx):
            await Header(HeaderType.SYNC, library_id=uuid.uuid4(),
                         trace=trace.wire_current()).write(pipe)
        # --- remote node ---
        header = await Header.read(pipe)
        wire_ctx = trace.TraceContext.from_wire(header.trace)
        assert wire_ctx is not None
        with trace.use(wire_ctx):
            with telemetry.span("p2p.sync_notify") as sp:
                pass
        assert sp.trace_id == initiator_ctx.trace_id
        assert sp.parent_id == initiator_ctx.span_id

        # spacedrop headers carry it the same way
        reqs = SpaceblockRequests(id=uuid.uuid4(), block_size=BlockSize.from_file_size(10),
                                  requests=[SpaceblockRequest(name="a", size=10)])
        pipe2 = _PipeStream()
        with trace.use(initiator_ctx):
            await Header(HeaderType.SPACEDROP, spacedrop=reqs,
                         trace=trace.wire_current()).write(pipe2)
        back = await Header.read(pipe2)
        assert trace.TraceContext.from_wire(back.trace).trace_id == initiator_ctx.trace_id
        # and headers without a context stay clean
        pipe3 = _PipeStream()
        await Header(HeaderType.SYNC, library_id=uuid.uuid4()).write(pipe3)
        assert (await Header.read(pipe3)).trace is None

    asyncio.run(asyncio.wait_for(run(), 10))


# --- the feeder thread and the thumbnail batch ---------------------------------


def test_feeder_producer_and_its_restart_join_the_trace():
    from spacedrive_tpu_torch.parallel.feeder import WindowPipeline
    from spacedrive_tpu_torch.utils import faults

    ctx = trace.new_context()

    def fetch(key):
        return None if key >= 4 else (key + 1, key)

    with faults.active(faults.FaultPlan.parse("feeder.fetch:crash:times=1")):
        with trace.use(ctx):
            pipe = WindowPipeline(fetch, 0, depth=2)
            got = []
            while (w := pipe.take()) is not None:
                got.append(w)
            pipe.close()
    assert got == [0, 1, 2, 3]
    recs = trace.recent()
    fetches = [r for r in recs if r["stage"] == "feeder.fetch"]
    waits = [r for r in recs if r["stage"] == "feeder.wait"]
    assert len(fetches) == 5 and waits  # 4 windows + the end of the stream
    assert {r["trace_id"] for r in fetches + waits} == {ctx.trace_id}
    assert telemetry.counter_value("sd_feeder_restarts_total") == 1


def test_thumbnail_batch_persists_its_trace_as_jax(tmp_path):
    from spacedrive_tpu.object.media.thumbnail import state as jstate
    from spacedrive_tpu_torch.object.media.thumbnail import state

    wire = {"trace_id": "1" * 32, "span_id": "2" * 16}
    for traced in (wire, None):
        dirs = []
        for mod in (state, jstate):
            d = os.path.join(tmp_path, f"{mod.__name__}-{traced is None}")
            os.makedirs(d)
            batch = mod.Batch(library_id="lib", entries=[("ab" * 8, "/x/a.png", "png")],
                              background=True, trace=traced)
            mod.save_state(d, [batch])
            dirs.append(d)
        blobs = [open(os.path.join(d, state.STATE_FILE), "rb").read() for d in dirs]
        assert blobs[0] == blobs[1]
        (back,) = state.load_state(dirs[0])
        assert back.trace == traced
