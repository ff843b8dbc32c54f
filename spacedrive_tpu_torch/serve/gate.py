"""Admission gate — per-priority-class budgets with queue-then-shed.

Counterpart of `spacedrive_tpu/serve/gate.py`. The gate reads its clock
through ``clock`` (``time.monotonic`` by default), so a test can drive
the queue deadlines and the brownout hold without sleeping.

The overload failure mode this closes: every read (explorer listing,
thumbnail fetch, search, /mesh poll) used to go straight at per-library
SQLite on the shared event loop, so a traffic burst or a slow disk
queued unbounded work, the loop-lag monitor went red, and the node
stopped answering *everything* — including the health probe that would
have told a balancer to route around it, and the sync legs that keep
replicas converging.

The gate puts a budget in front of each priority class
(:mod:`.policy`): control and sync always admit
(counted, never blocked); interactive and background requests run up to
their in-flight budget, park in a bounded FIFO with a deadline when the
budget is full, and **shed fast-fail** (:class:`Shed` → HTTP 429 +
``Retry-After``) beyond that. Every shed lands on the ``serve`` flight
ring with the active trace id and bumps ``sd_gate_requests_total``.

Brownout: when the event-loop-lag gauge (the existing health signal)
crosses the degraded threshold, or sheds/queue-saturation happened
within the hold window, :meth:`AdmissionGate.in_brownout` reports True
— background requests shed immediately, queue deadlines shrink, and the
read cache serves stale entries instead of shedding
(:mod:`.cache`). Gate state rides
``telemetry.health`` → federation snapshots → ``GET /mesh``.

``SD_SERVE_GATE=0``: :meth:`admit` yields immediately with zero
bookkeeping — the ungated path, golden-tested identical to pre-serve
behavior.
"""

from __future__ import annotations

import asyncio
import collections
import contextlib
import time
from typing import Any, AsyncIterator, Callable

from ..telemetry import metrics as _tm
from ..telemetry import tenants as _tenants
from ..telemetry.events import SERVE_EVENTS
from ..telemetry.snapshot import gauge_value
from . import policy as _policy
from .policy import BACKGROUND, CLASSES, CONTROL, INTERACTIVE, SYNC, ServePolicy

NORMAL = "normal"
BROWNOUT = "brownout"


def observe_request_seconds(klass: str, seconds: float,
                            tenant: Any = None) -> None:
    """Admitted-request wall time per priority class — the ONE record
    site both serve surfaces share (the HTTP admission middleware and
    the rspc Router.exec leg), so the `interactive_p99` SLO input
    covers rspc traffic, not just raw HTTP routes. The conditional maps
    onto the class-constant vocabulary (an unknown string — which the
    gate itself degrades to background — records as background too).
    ``tenant`` (the request's library id, when the surface knows one)
    rides the same call into the per-tenant serve sketch
    (telemetry/tenants.py) so request latency and volume attribute to
    the library that caused them."""
    _tm.SERVE_REQUEST_SECONDS.observe(
        seconds,
        klass="control" if klass == CONTROL
        else "sync" if klass == SYNC
        else "interactive" if klass == INTERACTIVE
        else "background",
    )
    _tenants.observe("serve", tenant, seconds=seconds)


class Shed(Exception):
    """Admission refused — answer 429/``SHED`` with Retry-After and move
    on; the caller must NOT fall back to doing the work anyway."""

    def __init__(self, klass: str, retry_after_s: float, reason: str):
        super().__init__(f"shed {klass} request: {reason}")
        self.klass = klass
        self.retry_after_s = retry_after_s
        self.reason = reason


class _Waiter:
    __slots__ = ("future", "enqueued_at")

    def __init__(self, future: "asyncio.Future[None]", now: float) -> None:
        self.future = future
        self.enqueued_at = now


class AdmissionGate:
    """Per-class admission control over one node's serve surface."""

    def __init__(self, policy: ServePolicy | None = None,
                 clock: Callable[[], float] = time.monotonic):
        self._policy = policy
        self._clock = clock
        self.inflight: dict[str, int] = {c: 0 for c in CLASSES}
        self._queues: dict[str, collections.deque[_Waiter]] = {
            c: collections.deque() for c in CLASSES
        }
        self.admitted: dict[str, int] = {c: 0 for c in CLASSES}
        self.shed: dict[str, int] = {c: 0 for c in CLASSES}
        self._mode = NORMAL
        self._brownout_until = 0.0

    @property
    def policy(self) -> ServePolicy:
        return self._policy if self._policy is not None else _policy.policy()

    # --- mode -----------------------------------------------------------

    def in_brownout(self) -> bool:
        return self._refresh_mode() == BROWNOUT

    def _refresh_mode(self) -> str:
        pol = self.policy
        now = self._clock()
        lag = gauge_value("sd_event_loop_lag_seconds")
        saturated = False
        for klass, budget in pol.budgets.items():
            if not budget.sheddable:
                continue
            if (
                self.inflight.get(klass, 0) >= budget.max_inflight
                and len(self._queues[klass]) >= max(1, budget.max_queue // 2)
            ):
                saturated = True
                break
        if lag >= pol.brownout_loop_lag_s or saturated:
            self._brownout_until = now + pol.brownout_hold_s
        mode = BROWNOUT if now < self._brownout_until else NORMAL
        if mode != self._mode:
            self._mode = mode
            _tm.GATE_MODE.set(1.0 if mode == BROWNOUT else 0.0)
            SERVE_EVENTS.emit(
                "mode", mode=mode, loop_lag_s=round(lag, 4),
                saturated=saturated,
            )
            if mode == BROWNOUT:
                # brownout ENTRY opens a host-profiler deep capture:
                # the overload incident's flight record gains the
                # frames that were burning the loop (hysteresis in the
                # sampler keeps a flapping gate to one window)
                from ..telemetry import sampler as _sampler

                _sampler.trigger("brownout")
        return mode

    def _note_shed(self) -> None:
        """A shed is itself overload evidence: extend the brownout hold
        so the cache keeps serving stale instead of thrashing."""
        self._brownout_until = self._clock() + self.policy.brownout_hold_s

    # --- admission ------------------------------------------------------

    @contextlib.asynccontextmanager
    async def admit(self, klass: str, key: str = "") -> AsyncIterator[None]:
        """Hold one slot of ``klass``'s budget for the block. Raises
        :class:`Shed` instead of entering when the class is saturated
        past its queue. No-op when the serve layer is disabled."""
        if not _policy.enabled():
            yield
            return
        from ..utils.resilience import deadline_scope

        pol = self.policy
        budget = pol.budgets.get(klass)
        if budget is None or klass not in self.inflight:
            # a mistyped priority= (class_for_key returns it verbatim)
            # degrades to background gating — never a KeyError 500
            klass = BACKGROUND
            budget = pol.budgets[BACKGROUND]
        mode = self._refresh_mode()
        queue_wait_s = None
        if budget.sheddable and self.inflight[klass] >= budget.max_inflight:
            queue_wait_s = await self._queue_for_slot(klass, budget, mode, key)
        else:
            self.inflight[klass] += 1
        # from here the slot is HELD (counted here or reserved for us by
        # the releasing request's _grant_next) — every statement that can
        # raise, the admission bookkeeping included, lives inside the
        # try so the finally always gives the slot back; a metric-
        # registry error between acquire and try would permanently
        # shrink the class budget
        try:
            self.admitted[klass] += 1
            # bounded-IfExp labels: the class vocabulary is fixed
            # (CLASSES), spelled out at the call site
            _tm.GATE_REQUESTS.inc(
                klass="control" if klass == "control"
                else "sync" if klass == "sync"
                else "background" if klass == "background"
                else "interactive",
                outcome="admitted")
            _tm.GATE_INFLIGHT.set(
                self.inflight[klass],
                klass="control" if klass == "control"
                else "sync" if klass == "sync"
                else "background" if klass == "background"
                else "interactive")
            if queue_wait_s is not None:
                # observed HERE, with the slot protected by the finally
                # — inside _queue_for_slot a failing observe would leak
                # the just-granted slot
                _tm.GATE_QUEUE_SECONDS.observe(
                    queue_wait_s,
                    klass="control" if klass == "control"
                    else "sync" if klass == "sync"
                    else "background" if klass == "background"
                    else "interactive",
                )
            if budget.sheddable and pol.request_deadline_s:
                with deadline_scope(pol.request_deadline_s):
                    yield
            else:
                yield
        finally:
            self.inflight[klass] -= 1
            self._grant_next(klass, budget)
            _tm.GATE_INFLIGHT.set(
                self.inflight[klass],
                klass="control" if klass == "control"
                else "sync" if klass == "sync"
                else "background" if klass == "background"
                else "interactive")

    async def _queue_for_slot(
        self, klass: str, budget: Any, mode: str, key: str
    ) -> float:
        """Park until a slot frees or the queue deadline passes. On
        success the releasing request has already transferred its slot
        (inflight stays reserved for us); returns the queue wait in
        seconds — recorded by the CALLER inside its try/finally, so a
        failing metric write cannot leak the granted slot."""
        queue = self._queues[klass]
        deadline = budget.queue_deadline_s
        if mode == BROWNOUT:
            # saturated (the event-loop-lag / in-flight signals said so):
            # stop queueing and fast-fail — parking more work behind a
            # full budget only converts future sheds into slow sheds,
            # and the admitted stream must keep its latency bound
            self._shed(klass, key, "brownout fast-fail")
        if len(queue) >= budget.max_queue or deadline <= 0:
            self._shed(klass, key, "queue full")
        waiter = _Waiter(asyncio.get_running_loop().create_future(), self._clock())
        queue.append(waiter)
        try:
            # the queued-outcome metric rides INSIDE the try: from the
            # append on, an exception anywhere here must unregister the
            # waiter (or pass a granted slot on) — an orphan waiter
            # would absorb the next _grant_next and shrink the budget
            _tm.GATE_REQUESTS.inc(
                klass="control" if klass == "control"
                else "sync" if klass == "sync"
                else "background" if klass == "background"
                else "interactive",
                outcome="queued")
            await asyncio.wait_for(
                asyncio.shield(waiter.future), timeout=deadline
            )
        except asyncio.CancelledError:
            # the REQUEST died while parked (client disconnect, task
            # teardown): the slot must not die with it
            if waiter.future.done() and not waiter.future.cancelled():
                # granted in the same tick we were cancelled — the
                # releasing request already reserved inflight for us;
                # hand the slot straight to the next waiter
                self.inflight[klass] -= 1
                self._grant_next(klass, budget)
            else:
                waiter.future.cancel()
                with contextlib.suppress(ValueError):
                    queue.remove(waiter)
            raise
        except asyncio.TimeoutError:
            if waiter.future.done():
                # the slot was granted in the same tick the timer fired:
                # it is ours — proceed admitted
                pass
            else:
                waiter.future.cancel()
                with contextlib.suppress(ValueError):
                    queue.remove(waiter)
                self._shed(
                    klass, key,
                    f"queue deadline {deadline:.2f}s exceeded",
                    queue_wait_s=self._clock() - waiter.enqueued_at,
                )
        except BaseException:
            # anything else (a raising metric registry, a broken loop):
            # same discipline as cancellation — never leave an orphan
            # waiter behind for _grant_next to hand a slot to
            if waiter.future.done() and not waiter.future.cancelled():
                self.inflight[klass] -= 1
                self._grant_next(klass, budget)
            else:
                waiter.future.cancel()
                with contextlib.suppress(ValueError):
                    queue.remove(waiter)
            raise
        return self._clock() - waiter.enqueued_at

    def _grant_next(self, klass: str, budget: Any) -> None:
        """Slot handoff on release: wake the oldest live waiter and
        reserve the slot for it (so a burst can never overshoot the
        budget between release and wakeup)."""
        queue = self._queues[klass]
        while queue and self.inflight[klass] < budget.max_inflight:
            waiter = queue.popleft()
            if waiter.future.done():
                continue  # timed out / cancelled while queued
            self.inflight[klass] += 1
            waiter.future.set_result(None)
            break

    def _shed(self, klass: str, key: str, reason: str,
              queue_wait_s: float = 0.0) -> None:
        self.shed[klass] += 1
        self._note_shed()
        _tm.GATE_REQUESTS.inc(
            klass="control" if klass == "control"
            else "sync" if klass == "sync"
            else "background" if klass == "background"
            else "interactive",
            outcome="shed")
        SERVE_EVENTS.emit(
            "shed",
            klass=klass,
            key=key,
            reason=reason,
            queue_wait_s=round(queue_wait_s, 4),
        )
        raise Shed(klass, self.policy.retry_after_s, reason)

    # --- introspection --------------------------------------------------

    def snapshot(self) -> dict[str, Any]:
        """Gate state for health / ``GET /mesh`` / ``sdx serve-status``."""
        pol = self.policy
        classes = {}
        for klass in CLASSES:
            budget = pol.budgets.get(klass)
            classes[klass] = {
                "inflight": self.inflight[klass],
                "queued": len(self._queues[klass]),
                "admitted_total": self.admitted[klass],
                "shed_total": self.shed[klass],
                "max_inflight": budget.max_inflight if budget else None,
                "sheddable": budget.sheddable if budget else True,
            }
        return {
            "enabled": _policy.enabled(),
            "mode": self._refresh_mode() if _policy.enabled() else NORMAL,
            "classes": classes,
        }
