"""Unified resilience layer — retries, circuit breakers, deadlines.

An owned copy of `spacedrive_tpu/utils/resilience.py`, with its policy,
breaker and deadline rules unchanged. One policy object replaces ad-hoc
per-call-site handling of dead relays, flapping peers and wedged
streams:

- **bounded retries** with decorrelated-jitter backoff (each sleep is
  ``uniform(base, prev * 3)`` capped, so synchronized clients
  de-correlate instead of thundering together);
- a **per-target circuit breaker** (CLOSED → OPEN after
  ``failure_threshold`` consecutive failures; after ``reset_timeout`` a
  single HALF_OPEN probe is admitted — success closes, failure re-opens
  and restarts the clock);
- **deadline propagation** over a contextvar: ``deadline_scope(s)``
  bounds everything underneath — attempt timeouts and backoff sleeps
  are clipped to the remaining budget and ``DeadlineExceeded`` fires
  instead of overshooting.

Breaker state is exported as ``sd_breaker_open`` /
``sd_breaker_transitions_total``, per-target detail lands on the
``resilience`` flight ring, and the ``resilience`` health subsystem
reads :func:`breaker_snapshot`. Nothing on the scan adopts a policy
yet: the p2p, cloud and serve planes do, as in the JAX package.
"""

from __future__ import annotations

import asyncio
import contextlib
import contextvars
import random
import threading
import time
from dataclasses import dataclass
from typing import Any, Awaitable, Callable, Iterable

# --- outcome classification -------------------------------------------------

#: retry the attempt (counts as a breaker failure)
RETRY = "retry"
#: give up now, but still count a breaker failure (the target is sick)
FAIL = "fail"
#: give up now WITHOUT counting a failure (the target answered; the
#: request itself was bad — a 4xx must never open a breaker)
PASS = "pass"

Classifier = Callable[[BaseException], str]


class BreakerOpen(ConnectionError):
    """Fast-failed: the target's circuit breaker is open."""


class DeadlineExceeded(asyncio.TimeoutError):
    """The ambient deadline expired before the call succeeded."""


# --- deadline propagation ---------------------------------------------------

_deadline: contextvars.ContextVar[float | None] = contextvars.ContextVar(
    "sd_resilience_deadline", default=None
)


@contextlib.contextmanager
def deadline_scope(seconds: float):
    """Bound everything under this block to ``seconds`` from now. Nested
    scopes only ever tighten — an inner scope cannot outlive an outer
    one."""
    now = time.monotonic()
    new = now + max(0.0, seconds)
    prev = _deadline.get()
    token = _deadline.set(new if prev is None else min(prev, new))
    try:
        yield
    finally:
        _deadline.reset(token)


def deadline_remaining() -> float | None:
    """Seconds left in the ambient deadline, or None when unbounded."""
    d = _deadline.get()
    if d is None:
        return None
    return max(0.0, d - time.monotonic())


# --- circuit breaker --------------------------------------------------------

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitBreaker:
    """Per-target failure gate. Thread-safe; cheap enough per call that
    the hot paths can consult it unconditionally."""

    def __init__(self, target: str, *, failure_threshold: int = 5,
                 reset_timeout: float = 30.0, policy: str = ""):
        self.target = str(target)
        self.policy = policy
        self.failure_threshold = max(1, failure_threshold)
        self.reset_timeout = reset_timeout
        self.state = CLOSED
        self.failures = 0
        self.opened_at = 0.0
        self.half_open_since = 0.0
        self._lock = threading.Lock()

    def allow(self) -> bool:
        """May a call proceed? An OPEN breaker past its reset timeout
        admits exactly one half-open probe. A probe that never reports
        back (cancelled mid-flight) must not wedge the breaker: after
        another reset window, HALF_OPEN re-admits a fresh probe."""
        now = time.monotonic()
        with self._lock:
            if self.state == CLOSED:
                return True
            if self.state == OPEN:
                if now - self.opened_at >= self.reset_timeout:
                    self._transition(HALF_OPEN)
                    self.half_open_since = now
                    return True
                return False
            # HALF_OPEN: the single probe is in flight — unless it was
            # abandoned a full reset window ago
            if now - self.half_open_since >= self.reset_timeout:
                self.half_open_since = now
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self.failures = 0
            if self.state != CLOSED:
                self._transition(CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            self.failures += 1
            if self.state == HALF_OPEN or (
                self.state == CLOSED
                and self.failures >= self.failure_threshold
            ):
                self.opened_at = time.monotonic()
                self._transition(OPEN)
            elif self.state == OPEN:
                # a failure while open (raced probe) restarts the clock
                self.opened_at = time.monotonic()

    def _transition(self, state: str) -> None:
        # caller holds self._lock
        from ..telemetry import metrics as _tm
        from ..telemetry.events import RESILIENCE_EVENTS
        from ..telemetry.peers import peer_label

        prev, self.state = self.state, state
        if state == OPEN:
            _tm.BREAKER_TRANSITIONS.inc(state="open")
        elif state == HALF_OPEN:
            _tm.BREAKER_TRANSITIONS.inc(state="half_open")
        else:
            _tm.BREAKER_TRANSITIONS.inc(state="closed")
        _tm.BREAKER_OPEN.set(float(_count_open()))
        RESILIENCE_EVENTS.emit(
            "breaker",
            policy=self.policy,
            target=peer_label(self.target),
            state=state,
            prev=prev,
            failures=self.failures,
        )


# every live breaker, for the open-count gauge + health/mesh snapshots
_breakers: "dict[tuple[str, str], CircuitBreaker]" = {}
_breakers_lock = threading.Lock()


def _count_open() -> int:
    with _breakers_lock:
        return sum(1 for b in _breakers.values() if b.state == OPEN)


def breaker_snapshot() -> dict[str, Any]:
    """Per-breaker state for /health signals and debugging. Targets are
    peer_label short-hashes — raw peer ids never leave the node."""
    from ..telemetry.peers import peer_label

    with _breakers_lock:
        items = list(_breakers.values())
    return {
        f"{b.policy}:{peer_label(b.target)}": {
            "state": b.state, "failures": b.failures,
        }
        for b in items
    }


def reset_breakers() -> None:
    """Test hook: drop every registered breaker."""
    from ..telemetry import metrics as _tm

    with _breakers_lock:
        _breakers.clear()
    _tm.BREAKER_OPEN.set(0.0)


# --- retry policy -----------------------------------------------------------


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded retries with decorrelated jitter.

    ``attempt_timeout`` bounds each try (clipped to the ambient
    deadline); ``max_attempts`` bounds the ladder. The expected worst
    case is therefore ``max_attempts × attempt_timeout + Σ sleeps`` —
    finite by construction, which is what sdlint SD011 cannot prove
    about a hand-rolled loop."""

    max_attempts: int = 3
    base_delay: float = 0.05
    max_delay: float = 2.0
    attempt_timeout: float | None = 30.0

    def sleeps(self, rng: random.Random) -> Iterable[float]:
        prev = self.base_delay
        for _ in range(self.max_attempts - 1):
            prev = min(self.max_delay, rng.uniform(self.base_delay, prev * 3))
            yield prev


def default_classifier(exc: BaseException) -> str:
    if isinstance(exc, asyncio.CancelledError):
        return PASS
    return RETRY


class ResiliencePolicy:
    """Retry + breaker + deadline in one adoptable object.

    ``call(target, fn)`` runs ``fn`` (an async thunk) under the
    target's breaker with bounded, jittered retries. ``classify`` maps
    an exception to RETRY / FAIL / PASS (default: everything but
    cancellation retries)."""

    def __init__(self, name: str, retry: RetryPolicy | None = None, *,
                 failure_threshold: int = 5, reset_timeout: float = 30.0,
                 classify: Classifier | None = None, seed: int | None = None):
        self.name = name
        self.retry = retry or RetryPolicy()
        self.failure_threshold = failure_threshold
        self.reset_timeout = reset_timeout
        self.classify = classify or default_classifier
        self._rng = random.Random(seed)

    def breaker(self, target: str) -> CircuitBreaker:
        key = (self.name, str(target))
        with _breakers_lock:
            b = _breakers.get(key)
            if b is None:
                b = _breakers[key] = CircuitBreaker(
                    target,
                    failure_threshold=self.failure_threshold,
                    reset_timeout=self.reset_timeout,
                    policy=self.name,
                )
        return b

    def allow(self, target: str) -> bool:
        return self.breaker(target).allow()

    async def call(self, target: str, fn: Callable[[], Awaitable[Any]], *,
                   classify: Classifier | None = None) -> Any:
        """Run ``fn`` with retries/breaker/deadline. Raises
        :class:`BreakerOpen` without calling ``fn`` when the target's
        breaker rejects, :class:`DeadlineExceeded` when the ambient
        deadline runs out, else the final attempt's exception."""
        from ..telemetry import metrics as _tm
        from ..telemetry.events import RESILIENCE_EVENTS
        from ..telemetry.peers import peer_label

        classify = classify or self.classify
        breaker = self.breaker(target)
        if not breaker.allow():
            raise BreakerOpen(
                f"{self.name}: breaker open for {peer_label(target)}"
            )
        sleeps = iter(self.retry.sleeps(self._rng))
        attempt = 0
        while True:
            attempt += 1
            remaining = deadline_remaining()
            if remaining is not None and remaining <= 0.0:
                raise DeadlineExceeded(f"{self.name}: deadline exhausted")
            budget = self.retry.attempt_timeout
            if remaining is not None:
                budget = remaining if budget is None else min(budget, remaining)
            try:
                if budget is None:
                    result = await fn()
                else:
                    from .compat import timeout

                    async with timeout(budget):
                        result = await fn()
            except (asyncio.CancelledError, KeyboardInterrupt, SystemExit):
                # cancellation/exit is never an attempt failure: it must
                # propagate immediately — not feed the breaker, not be
                # slept on, and not depend on a custom classifier
                # remembering to pass it through
                raise
            except BaseException as exc:  # noqa: BLE001 - classified below
                outcome = classify(exc)
                if outcome == PASS:
                    # the target ANSWERED (a 4xx, a refusal): proof of
                    # liveness — settle a half-open probe so the breaker
                    # can't wedge. While CLOSED, though, leave the
                    # failure streak alone: interleaved 4xx answers must
                    # not keep a half-dead target's breaker from opening
                    if breaker.state != CLOSED:
                        breaker.record_success()
                    raise
                breaker.record_failure()
                delay = next(sleeps, None)
                if outcome == FAIL or delay is None or not breaker.allow():
                    raise
                remaining = deadline_remaining()
                if remaining is not None:
                    if remaining <= 0.0:
                        raise DeadlineExceeded(
                            f"{self.name}: deadline exhausted"
                        ) from exc
                    delay = min(delay, remaining)
                _tm.RESILIENCE_RETRIES.inc()
                RESILIENCE_EVENTS.emit(
                    "retry",
                    policy=self.name,
                    target=peer_label(target),
                    attempt=attempt,
                    sleep_s=round(delay, 4),
                    error=str(exc)[:200],
                )
                await asyncio.sleep(delay)
                continue
            breaker.record_success()
            return result
