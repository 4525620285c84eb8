"""SLO-driven control plane over the simulation (see ISSUE/ROADMAP PR 5).

Four pieces close the loop the sweeps left open:

  * :mod:`repro_torch.control.telemetry` — windowed event-time ring
    (:class:`Telemetry`) the workload engine fills and the controller
    and benchmarks both read;
  * :mod:`repro_torch.control.governor` — token-bucket admission + pacing
    (:class:`TokenBucket`, :class:`RepairPacer`) shared by
    ``Workload`` admission and ``StorageCluster.repair_node``;
  * :mod:`repro_torch.control.autoscaler` — the :class:`SLO`-driven
    :class:`Autoscaler` that resizes ``PsPINConfig.num_hpus`` (and the
    replica/EC fan-out) between epochs;
  * :mod:`repro_torch.control.sweep` — the PolicySpec x HPU x failure sweep
    driver behind ``BENCH_control.json`` and ``run.py --autoscale``.
"""

from repro_torch.control.autoscaler import SLO, AutoscaleResult, Autoscaler, Epoch  # noqa: F401
from repro_torch.control.governor import RepairPacer, TokenBucket  # noqa: F401
from repro_torch.control.telemetry import Telemetry, TelemetryWindow  # noqa: F401
