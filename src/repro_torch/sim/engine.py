"""Discrete-event engines (the SST stand-in) behind one ``Engine`` API.

The paper evaluates with cycle-accurate PsPIN simulation + SST for
multi-node scenarios (section III-D).  We reproduce the multi-node layer as
a classic event-driven simulator: a time-ordered heap of callbacks plus
resource primitives (FIFO serial resources and pools) that the network and
PsPIN models are built from.  All times are in nanoseconds (float).

Three engine cores share that heap contract (see README "Engines"):

* :class:`DiscreteEngine` (alias ``Simulator``) — the frozen reference:
  one ``(time, seq, callback)`` pop per event, exactly the semantics every
  anchor in ``tests/data/policy_anchors.json`` was recorded against.  It
  is the default everywhere.
* :class:`BatchedEngine` — same event timeline, faster core: events may
  carry pre-bound argument tuples (``call``) so the hot per-packet paths
  in :mod:`repro_torch.sim.network` / :mod:`repro_torch.sim.pspin` schedule plain
  module-level step functions instead of allocating closure chains, and
  the run loop drains all contemporaneous heap entries for one timestamp
  in a single batch (still in ``(time, seq)`` order, so determinism and
  tie-breaking match the discrete core bit-for-bit).
* :class:`HybridEngine` — a :class:`BatchedEngine` that additionally
  advertises ``fluid = True``: closed-loop steady-state phases may be
  fast-forwarded analytically by the workload layer (calibrated against
  a simulated prefix, cross-checked within tolerance on the anchors).

``make_engine`` turns a spec (None | name | class | instance) into an
engine; ``Scenario.run(engine=...)`` / ``Env(engine=...)`` accept the
same specs so callers never reach into simulator internals.
"""

from __future__ import annotations

import collections
import heapq
import itertools
from typing import Callable


class EventBudgetExceeded(RuntimeError):
    """``Engine.run`` blew through ``max_events`` — almost always a
    livelock (an event that keeps rescheduling itself).  Subclasses
    RuntimeError so pre-existing ``except RuntimeError`` handlers keep
    working; carries enough state (events, sim time, heap depth, and a
    counter snapshot when a :class:`~repro_torch.trace.CounterRegistry` is
    attached to the engine) that a truncated sweep is diagnosable from
    the exception alone instead of looking like a converged run."""

    def __init__(self, events: int, now: float, pending: int,
                 counters: dict | None = None):
        self.events = events
        self.now = now
        self.pending = pending
        self.counters = counters
        msg = (f"event budget exceeded (livelock?): {events} events processed, "
               f"sim.now={now:.0f}ns, {pending} events still pending")
        if counters:
            parts = ", ".join(f"{k}={v}" for k, v in sorted(counters.items()))
            msg += f" [counters: {parts}]"
        super().__init__(msg)


class Engine:
    """Shared scheduling surface of every simulator core.

    Heap entries are ``(time, seq, fn)`` or ``(time, seq, fn, args)``;
    ``seq`` is unique, so comparisons never reach ``fn`` and equal-time
    events always dispatch in scheduling order on every engine.
    """

    #: engine spec name (``make_engine`` key)
    name = "discrete"
    #: True when the network/PsPIN fast paths (argument-tuple events,
    #: no closure chains) should be used
    batched = False
    #: True when the workload layer may fluid-fast-forward steady state
    fluid = False

    def __init__(self):
        self.now: float = 0.0
        self._heap: list[tuple] = []
        self._seq = itertools.count()
        self.events_processed = 0
        #: optional :class:`repro_torch.trace.Tracer`; every instrumentation
        #: hook in the sim guards on ``tracer is None`` so the default
        #: costs one attribute load per hook
        self.tracer = None
        #: optional :class:`repro_torch.trace.CounterRegistry`, snapshotted
        #: into :class:`EventBudgetExceeded` for post-mortems
        self.counters = None

    def _budget_error(self) -> EventBudgetExceeded:
        snap = None
        if self.counters is not None:
            try:
                snap = self.counters.snapshot()
            except Exception:  # diagnostics must not mask the livelock
                snap = None
        return EventBudgetExceeded(self.events_processed, self.now,
                                   len(self._heap), snap)

    def at(self, time: float, fn: Callable[[], None]) -> None:
        if time < self.now - 1e-9:
            raise ValueError(f"scheduling into the past: {time} < {self.now}")
        heapq.heappush(self._heap, (time, next(self._seq), fn))

    def after(self, delay: float, fn: Callable[[], None]) -> None:
        self.at(self.now + delay, fn)

    def call(self, time: float, fn: Callable, args: tuple = ()) -> None:
        """Schedule ``fn(*args)`` at ``time`` (closure-free fast lane on
        batched engines; plain engines wrap it)."""
        self.at(time, lambda: fn(*args))

    def pending(self) -> int:
        """Events still scheduled (lets a periodic sampler — e.g. the
        telemetry tick — stop once it would be the only event left,
        instead of keeping the run alive forever)."""
        return len(self._heap)

    def advance_to(self, time: float) -> None:
        """Jump the clock forward without running events (fluid mode's
        fast-forward; refuses to travel into the past)."""
        if time < self.now - 1e-9:
            raise ValueError(f"advancing into the past: {time} < {self.now}")
        self.now = max(self.now, time)

    def run(self, until: float | None = None, max_events: int = 50_000_000) -> None:
        raise NotImplementedError


class DiscreteEngine(Engine):
    """The reference core: one callback per heap pop, anchor-exact.

    This loop is deliberately frozen — every latency in
    ``tests/data/policy_anchors.json`` and every ``BENCH_*.json`` claim
    was recorded against it, and ``tools/check_anchors.py`` re-checks
    them at 1e-9 relative tolerance."""

    name = "discrete"

    def run(self, until: float | None = None, max_events: int = 50_000_000) -> None:
        while self._heap:
            t, _, fn = self._heap[0]
            if until is not None and t > until:
                break
            heapq.heappop(self._heap)
            self.now = t
            fn()
            self.events_processed += 1
            if self.events_processed > max_events:
                raise self._budget_error()


#: Backwards-compatible name — the simulator everyone constructed before
#: the Engine API existed *is* the discrete engine.
Simulator = DiscreteEngine


class BatchedEngine(Engine):
    """Timeline-exact fast core: typed argument-tuple events + per-tick
    batch draining.

    Two differences from :class:`DiscreteEngine`, neither visible in the
    simulated timeline:

    * ``call(t, fn, args)`` pushes ``(t, seq, fn, args)`` directly — the
      network/PsPIN fast paths use it with module-level step functions,
      eliminating the 4–6 closure allocations the discrete path pays per
      packet.
    * ``run`` drains every heap entry sharing the front timestamp as one
      batch (events scheduled *at* the current tick join the same batch),
      hoisting the clock store and loop bookkeeping out of the per-event
      path.  Entries still execute strictly in ``(time, seq)`` order, so
      same-timestamp tie-breaking is identical to the discrete core.
    """

    name = "batched"
    batched = True

    def at(self, time: float, fn: Callable[[], None]) -> None:
        if time < self.now - 1e-9:
            raise ValueError(f"scheduling into the past: {time} < {self.now}")
        heapq.heappush(self._heap, (time, next(self._seq), fn, ()))

    def call(self, time: float, fn: Callable, args: tuple = ()) -> None:
        heapq.heappush(self._heap, (time, next(self._seq), fn, args))

    def run(self, until: float | None = None, max_events: int = 50_000_000) -> None:
        heap = self._heap
        pop = heapq.heappop
        n = self.events_processed
        try:
            while heap:
                t = heap[0][0]
                if until is not None and t > until:
                    break
                self.now = t
                # Drain the contemporaneous batch in (time, seq) order.
                # Callbacks may push new events at exactly t; the loop
                # condition picks them up within the same batch, exactly
                # where the discrete core would run them.
                while heap and heap[0][0] == t:
                    _, _, fn, args = pop(heap)
                    fn(*args)
                    n += 1
                    if n > max_events:
                        self.events_processed = n
                        raise self._budget_error()
        finally:
            self.events_processed = n


class HybridEngine(BatchedEngine):
    """Batched core + permission for calibrated fluid fast-forward.

    The engine itself stays event-exact; ``fluid = True`` merely tells
    the workload layer (``repro_torch.sim.workload``) that, for closed-loop
    steady-state phases, it may simulate a calibration prefix and
    extrapolate the remaining completions analytically.  Results are
    approximate (cross-checked within tolerance against the discrete
    engine on the anchor scenarios), so hybrid is never the default and
    never used for anchor artifacts.
    """

    name = "hybrid"
    fluid = True
    #: closed-loop requests per client simulated before extrapolating
    calibration_requests = 3


ENGINES: dict[str, type[Engine]] = {
    "discrete": DiscreteEngine,
    "batched": BatchedEngine,
    "hybrid": HybridEngine,
}


def make_engine(spec: "str | Engine | type[Engine] | None" = None) -> Engine:
    """Resolve an engine spec: None (discrete default), a name from
    :data:`ENGINES`, an :class:`Engine` subclass, or a ready instance."""
    if spec is None:
        return DiscreteEngine()
    if isinstance(spec, Engine):
        return spec
    if isinstance(spec, type) and issubclass(spec, Engine):
        return spec()
    try:
        cls = ENGINES[spec]
    except (KeyError, TypeError):
        raise ValueError(
            f"unknown engine {spec!r} (expected one of {sorted(ENGINES)}, "
            "an Engine subclass, or an Engine instance)"
        ) from None
    return cls()


class SerialResource:
    """A resource that serves one request at a time, FIFO (a link port,
    a DMA engine, a memcpy engine).  ``acquire`` returns the service
    interval [start, end) and schedules ``on_done`` at its end.

    Contention accounting (for the multi-client workload engine): total
    time acquirers spent queued behind earlier work, and the queue depth —
    number of accepted-but-not-yet-started services at ``sim.now``.

    Tracing: ``acquire``/``book`` take an optional ``trace`` context —
    a ``(rid, pid, cat)`` tuple callers build only for sampled requests
    (see :mod:`repro_torch.trace`).  When present, the queue-wait interval
    ``[now, start)`` and service interval ``[start, end)`` are recorded
    as spans; the times are exactly the ones this method computes anyway,
    so tracing never perturbs the timeline."""

    def __init__(self, sim: Engine, name: str | None = None):
        self.sim = sim
        self.name = name
        self.free_at: float = 0.0
        self.busy_ns: float = 0.0
        self.acquires = 0
        self.total_wait_ns: float = 0.0
        self.peak_queued = 0
        self._pending_starts: collections.deque[float] = collections.deque()

    def _trace_span(self, trace: tuple, now: float, start: float, end: float) -> None:
        tr = self.sim.tracer
        if tr is None:
            return
        rid, pid, cat = trace
        res = self.name or "serial"
        if start > now:
            tr.record(res + " wait", cat, now, start, rid=rid, pid=pid,
                      resource=res + " (queue)", args={"queue": True})
        tr.record(res, cat, start, end, rid=rid, pid=pid, resource=res)

    def acquire(
        self, duration: float, on_done: Callable[[float, float], None] | None = None,
        trace: tuple | None = None,
    ) -> tuple[float, float]:
        start = max(self.sim.now, self.free_at)
        end = start + duration
        self.free_at = end
        self.busy_ns += duration
        self.acquires += 1
        wait = start - self.sim.now
        if wait > 0:
            self.total_wait_ns += wait
            self._pending_starts.append(start)
            self.peak_queued = max(self.peak_queued, self.queued())
        if trace is not None:
            self._trace_span(trace, self.sim.now, start, end)
        if on_done is not None:
            self.sim.at(end, lambda: on_done(start, end))
        return start, end

    def book(self, duration: float, trace: tuple | None = None) -> tuple[float, float]:
        """:meth:`acquire` without the completion event — identical FIFO
        interval and contention accounting; the caller schedules whatever
        should happen at ``end`` itself (batched fast paths)."""
        start = max(self.sim.now, self.free_at)
        end = start + duration
        self.free_at = end
        self.busy_ns += duration
        self.acquires += 1
        wait = start - self.sim.now
        if wait > 0:
            self.total_wait_ns += wait
            self._pending_starts.append(start)
            self.peak_queued = max(self.peak_queued, self.queued())
        if trace is not None:
            self._trace_span(trace, self.sim.now, start, end)
        return start, end

    def queued(self) -> int:
        """Services accepted but not yet started at the current time."""
        now = self.sim.now
        pend = self._pending_starts
        while pend and pend[0] <= now + 1e-12:
            pend.popleft()
        return len(pend)

    def utilization(self) -> float:
        return self.busy_ns / self.sim.now if self.sim.now > 0 else 0.0


class Pool:
    """A counted resource pool with FIFO waiting (the HPU pool).

    Waiters are ``(fn, args, t_enq, trace)`` records — ``args`` is None
    for the closure form (:meth:`acquire`) and a pre-bound tuple for the
    batched engines' closure-free lane (:meth:`acquire_call`); both hand
    over at the same simulated times.  ``trace`` follows the
    :class:`SerialResource` contract: a ``(rid, pid, cat)`` context for
    sampled requests, recorded as a queue-wait span at handover.
    """

    def __init__(self, sim: Engine, capacity: int, name: str | None = None):
        self.sim = sim
        self.capacity = capacity
        self.name = name
        self.in_use = 0
        self._waiters: list[tuple] = []
        self.peak = 0
        self.peak_queued = 0
        self.total_wait_ns: float = 0.0

    def queued(self) -> int:
        """Acquirers waiting for a unit right now (telemetry gauge)."""
        return len(self._waiters)

    def acquire(self, fn: Callable[[], None], trace: tuple | None = None) -> None:
        """Invoke ``fn`` as soon as a unit is available (caller must
        eventually call :meth:`release`)."""
        if self.in_use < self.capacity:
            self.in_use += 1
            if self.in_use > self.peak:
                self.peak = self.in_use
            fn()
        else:
            self._waiters.append((fn, None, self.sim.now, trace))
            self.peak_queued = max(self.peak_queued, len(self._waiters))

    def acquire_call(self, fn: Callable, args: tuple, trace: tuple | None = None) -> None:
        """:meth:`acquire` for pre-bound ``fn(*args)`` records (batched
        fast paths; same admission and wait accounting)."""
        if self.in_use < self.capacity:
            self.in_use += 1
            if self.in_use > self.peak:
                self.peak = self.in_use
            fn(*args)
        else:
            self._waiters.append((fn, args, self.sim.now, trace))
            self.peak_queued = max(self.peak_queued, len(self._waiters))

    def _handover(self, waiter: tuple) -> None:
        fn, args, t_enq, trace = waiter
        wait = self.sim.now - t_enq
        self.total_wait_ns += wait
        if trace is not None and wait > 0:
            tr = self.sim.tracer
            if tr is not None:
                rid, pid, cat = trace
                res = self.name or "pool"
                tr.record(res + " wait", cat, t_enq, self.sim.now, rid=rid,
                          pid=pid, resource=res + " (queue)", args={"queue": True})
        if args is not None:
            self.sim.call(self.sim.now, fn, args)
        else:
            self.sim.after(0.0, fn)

    def release(self) -> None:
        if self._waiters and self.in_use <= self.capacity:
            # hand over without changing count
            self._handover(self._waiters.pop(0))
        else:
            # no waiters, or the pool was shrunk below its occupancy:
            # the freed unit leaves service instead of being handed over
            self.in_use -= 1

    def resize(self, capacity: int) -> None:
        """Live-resize the pool (the control plane's HPU actuator).

        Growing admits queued waiters immediately; shrinking lets
        in-flight services finish and retires units as they release.
        """
        if capacity < 1:
            raise ValueError(f"pool capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        while self._waiters and self.in_use < self.capacity:
            waiter = self._waiters.pop(0)
            self.in_use += 1
            if self.in_use > self.peak:
                self.peak = self.in_use
            self._handover(waiter)
