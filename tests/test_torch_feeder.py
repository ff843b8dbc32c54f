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
