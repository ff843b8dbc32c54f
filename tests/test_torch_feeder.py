"""The port's WindowPipeline against the JAX package's: same windows in
the same order, bounded read-ahead, producer errors raised to the
consumer, and a prompt close."""

import threading
import time

import pytest

from spacedrive_tpu.parallel import feeder as jfeeder
from spacedrive_tpu_torch.parallel import feeder
from spacedrive_tpu_torch.parallel.autotune import FEEDER_BASE_DEPTH


def _drain(pipe):
    out = []
    try:
        while (w := pipe.take()) is not None:
            out.append(w)
    finally:
        pipe.close()
    return out


def _fetch(n):
    def fetch(k):
        return None if k >= n else (k + 1, ("window", k))
    return fetch


@pytest.mark.parametrize("depth", [1, 3])
def test_same_windows_as_jax(depth):
    got = _drain(feeder.WindowPipeline(_fetch(25), 0, depth=depth))
    assert got == _drain(jfeeder.WindowPipeline(_fetch(25), 0, depth=depth))
    assert got == [("window", k) for k in range(25)]
    assert feeder.WindowPipeline(_fetch(0), 0).take() is None


def test_default_depth_is_the_jax_single_device_depth():
    assert FEEDER_BASE_DEPTH == jfeeder.pipeline_depth(1)
    pipe = feeder.WindowPipeline(_fetch(0), 0)
    assert pipe._depth == FEEDER_BASE_DEPTH
    pipe.close()


def test_read_ahead_is_bounded_by_depth():
    fetched = []

    def fetch(k):
        fetched.append(k)
        return k + 1, k

    pipe = feeder.WindowPipeline(fetch, 0, depth=2)
    try:
        deadline = time.monotonic() + 5
        while len(fetched) < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.1)
        # two parked windows plus the one the producer holds while blocked
        assert len(fetched) == 3
        assert pipe.take() == 0
    finally:
        pipe.close()


def test_fetch_error_reaches_the_consumer_after_earlier_windows():
    def fetch(k):
        if k == 3:
            raise OSError("disk gone")
        return k + 1, k

    pipe = feeder.WindowPipeline(fetch, 0)
    assert [pipe.take() for _ in range(3)] == [0, 1, 2]
    with pytest.raises(OSError, match="disk gone"):
        pipe.take()
    with pytest.raises(OSError):
        pipe.take()
    pipe.close()


def test_close_wakes_a_blocked_consumer():
    def fetch(k):
        time.sleep(0.3)  # a slow read: the consumer blocks on an empty buffer
        return None

    pipe = feeder.WindowPipeline(fetch, 0)
    got = []
    consumer = threading.Thread(target=lambda: got.append(pipe.take()))
    consumer.start()
    time.sleep(0.05)
    pipe.close()
    consumer.join(timeout=5)
    assert not consumer.is_alive() and got == [None]


def _series(tm):
    return (tm.FEEDER_FETCH_SECONDS.stats()["count"], tm.FEEDER_WAIT_SECONDS.stats()["count"],
            tm.FEEDER_H2D_BYTES.value(), tm.FEEDER_PREFETCH.value(result="hit"),
            tm.FEEDER_PREFETCH.value(result="miss"))


def test_feeder_series_observed_as_jax():
    """The same script (12 windows, each fetch 20 ms, a measure of 1000
    bytes a window) through both pipelines moves the five series alike:
    13 fetches (the last finds the end), 13 waits, 12,000 H2D bytes, a
    hit or a miss per take, and the in-flight gauge back at 0."""
    from spacedrive_tpu.telemetry import metrics as jtm
    from spacedrive_tpu_torch.telemetry import metrics as tm

    def fetch(k):
        time.sleep(0.02)
        return None if k >= 12 else (k + 1, k)

    deltas = []
    for mod, m in ((feeder, tm), (jfeeder, jtm)):
        before = _series(m)
        pipe = mod.WindowPipeline(fetch, 0, depth=2, measure=lambda w: 1000)
        assert _drain(pipe) == list(range(12))
        fetches, waits, h2d, hits, misses = (a - b for a, b in zip(_series(m), before))
        deltas.append((fetches, waits, h2d, hits + misses))
        assert m.FEEDER_INFLIGHT.value() == 0
    assert deltas[0] == deltas[1] == (13, 13, 12_000, 13)


def test_instant_handoffs_count_as_prefetch_hits():
    from spacedrive_tpu_torch.telemetry import metrics as tm

    pipe = feeder.WindowPipeline(_fetch(5), 0, depth=8)
    pipe._thread.join(timeout=5)  # every window parked before the first take
    hits = tm.FEEDER_PREFETCH.value(result="hit")
    misses = tm.FEEDER_PREFETCH.value(result="miss")
    assert _drain(pipe) == [("window", k) for k in range(5)]
    got = (tm.FEEDER_PREFETCH.value(result="hit") - hits,
           tm.FEEDER_PREFETCH.value(result="miss") - misses)
    # a parked take is a hit unless the thread lost the GIL for 2 ms
    assert sum(got) == 6 and got[0] >= 1


def test_callable_depth_is_read_on_each_fetch():
    """A callable depth is re-read for every parked window: raising it
    mid-run lets the producer read further ahead at once."""
    reads = []
    depth = {"n": 1}
    fetched = []

    def depth_fn():
        reads.append(depth["n"])
        return depth["n"]

    def fetch(k):
        fetched.append(k)
        return k + 1, k

    pipe = feeder.WindowPipeline(fetch, 0, depth=depth_fn)
    try:
        deadline = time.monotonic() + 5
        while len(fetched) < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.1)
        assert len(fetched) == 2  # one parked window, one held while blocked
        n_reads = len(reads)
        assert n_reads >= 2
        with pipe._cond:
            depth["n"] = 4
            pipe._cond.notify_all()
        deadline = time.monotonic() + 5
        while len(fetched) < 5 and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.1)
        assert len(fetched) == 5 and len(reads) > n_reads
        assert pipe.take() == 0
    finally:
        pipe.close()


def test_broken_depth_callable_degrades_to_one():
    def bad():
        raise RuntimeError("policy gone")

    pipe = feeder.WindowPipeline(_fetch(4), 0, depth=bad)
    assert _drain(pipe) == [("window", k) for k in range(4)]
