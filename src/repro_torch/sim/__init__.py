"""SST-analog discrete-event simulation of the paper's evaluation.

engine.py    event queue + resource primitives (with contention stats)
network.py   400 Gbit/s / MTU 2048 / 20 ns links, host-path constants
pspin.py     PsPIN timing model (Fig. 7, Tables I/II)
protocols.py per-request protocol factories + single-shot runners
             for Figs. 6/9/10/15
workload.py  multi-client workload engine (arrival processes, latency
             percentiles, goodput, queue depths)
"""

from repro_torch.sim.engine import Pool, SerialResource, Simulator
from repro_torch.sim.network import NetConfig, Network
from repro_torch.sim.protocols import (
    Env,
    PROTOCOL_NAMES,
    Protocol,
    Result,
    make_protocol,
)
from repro_torch.sim.pspin import (
    HANDLER_NS,
    PsPINConfig,
    PsPINUnit,
    handler_budget_ns,
    hpus_for_line_rate,
)
from repro_torch.sim.workload import Metrics, Scenario, Workload, run_scenario
