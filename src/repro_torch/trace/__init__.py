"""``repro_torch.trace`` — sampled request tracing, unified counters, exporters.

The observability layer for the timed plane (ISSUE 10):

* :class:`Tracer` / :class:`Span` — head-sampled, zero-cost-when-off
  span recording (install via ``env.sim.tracer`` or
  ``Scenario.run(tracer=...)``)
* :class:`CounterRegistry` / :func:`registry_for` — one snapshot-diffable
  namespace over the sim's scattered counters
* :func:`to_chrome_trace` / :func:`write_chrome_trace` — Perfetto /
  ``chrome://tracing`` export
* :mod:`repro_torch.trace.attr` — per-request / per-policy latency attribution
  into wire / hpu_queue / hpu_exec / pcie / host_cpu / client buckets
"""

from .tracer import BUCKETS, Span, Tracer
from .counters import CounterRegistry, registry_for
from .perfetto import to_chrome_trace, write_chrome_trace
from . import attr

__all__ = [
    "BUCKETS", "Span", "Tracer",
    "CounterRegistry", "registry_for",
    "to_chrome_trace", "write_chrome_trace",
    "attr",
]
