"""Sampled, zero-cost-when-off request tracing for the timed plane.

The simulator already *knows* every interval the trace needs — a
:class:`~repro_torch.sim.engine.SerialResource` returns ``(start, end)`` the
moment a service is accepted, the PsPIN model threads ``t0`` /
``t_compute_done`` through its handler steps, and the network computes
arrival times analytically.  The tracer therefore never schedules
events: instrumentation *records* intervals the model computed anyway,
so enabling it cannot perturb the simulated timeline (the anchor suite
asserts bit-exactness, see ``tests/test_trace.py``).

Cost model:

* **off** (``sim.tracer is None``, the default) — every hook is a single
  attribute load + ``is None`` branch; no tuple, no span, no call.
* **sampled out** — head-based sampling by request id
  (``rid % sample_every == 0``); unsampled requests take one modulo and
  allocate nothing.
* **sampled in** — one :class:`Span` per interval, appended to a bounded
  buffer (``max_spans``); past the bound spans are counted in
  ``dropped`` instead of growing memory.

Span attributes follow the issue contract
``{request, policy, stage, node, resource}``: ``rid`` / ``pid`` name the
request and policy instance (``register_policy`` maps pids to the
human-readable policy names the registry/telemetry use), ``name`` is the
stage, ``resource`` the track the span occupies (e.g. ``n3.egress``),
and ``cat`` the attribution bucket (see :mod:`repro_torch.trace.attr`).
"""

from __future__ import annotations

#: attribution buckets every span category must fall into (or "request"
#: for root spans, which attribution skips)
BUCKETS = ("wire", "hpu_queue", "hpu_exec", "pcie", "host_cpu", "client")


class Span:
    """One closed interval on one resource track (micro-struct; traces
    hold millions of these, hence ``__slots__`` and no dataclass)."""

    __slots__ = ("name", "cat", "t0", "t1", "rid", "pid", "node", "resource", "args")

    def __init__(self, name, cat, t0, t1, rid=None, pid=None, node=None,
                 resource=None, args=None):
        self.name = name
        self.cat = cat
        self.t0 = t0
        self.t1 = t1
        self.rid = rid
        self.pid = pid
        self.node = node
        self.resource = resource
        self.args = args

    @property
    def dur(self) -> float:
        return self.t1 - self.t0

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Span({self.name!r}, {self.cat!r}, [{self.t0:.0f}, {self.t1:.0f}) "
                f"rid={self.rid} res={self.resource})")


class Tracer:
    """Head-based sampling tracer with a bounded span buffer.

    Install with ``env.sim.tracer = Tracer(sample_every=64)`` (or pass
    ``tracer=`` to :meth:`repro_torch.sim.workload.Scenario.run`).  Sampling is
    decided once per request from its id, so every span of a sampled
    request is kept and unsampled requests leave no trace at all.
    """

    def __init__(self, sample_every: int = 64, max_spans: int = 1_000_000):
        if sample_every < 1:
            raise ValueError(f"sample_every must be >= 1, got {sample_every}")
        self.sample_every = int(sample_every)
        self.max_spans = int(max_spans)
        self.spans: list[Span] = []
        self.dropped = 0
        self._policies: dict[int, str] = {}

    def sampled(self, rid) -> bool:
        """Head-based sampling decision for one request id."""
        if rid is None:
            return False
        return self.sample_every == 1 or rid % self.sample_every == 0

    def record(self, name, cat, t0, t1, rid=None, pid=None, node=None,
               resource=None, args=None):
        """Record one complete interval; returns the span (or None when
        the buffer bound was hit — counted in ``dropped``)."""
        if len(self.spans) >= self.max_spans:
            self.dropped += 1
            return None
        sp = Span(name, cat, t0, t1, rid=rid, pid=pid, node=node,
                  resource=resource, args=args)
        self.spans.append(sp)
        return sp

    def register_policy(self, pid: int, name: str) -> None:
        """Map a protocol instance id to its policy name (spans carry
        pids; exporters and attribution resolve them through this)."""
        self._policies[pid] = name

    def policy_name(self, pid) -> str:
        return self._policies.get(pid, f"pid{pid}" if pid is not None else "?")

    def clear(self) -> None:
        self.spans.clear()
        self.dropped = 0

    def __len__(self) -> int:
        return len(self.spans)
