#!/usr/bin/env python3
"""What the checkpoint plane's host spans cost: a save and a degraded
restore with spans off against on.

    python3 tools/host_span_cost.py [--device cuda|cpu] [--repeats 5] [--out FILE]

The state is one yi-9b layer's attention as training holds it (wq, wk, wv,
wo in fp32 with AdamW's fp32 m and v: 12 leaves, 0.453 GB), made on
``--device`` from a fixed seed.  Each turn builds a 10-node cluster there,
saves the state under RS-6-3 with 1 MiB cells (``CheckpointManager.save``,
blocking), fails the three nodes that hold the first stripe's first data
cells and restores it degraded; a restore that differs from the state fails
the run.  One turn warms up (on a card: builds the GF(2^8) kernels), then
turns alternate off, on, off, on, ... ``--repeats`` times each; "on" is
``repro_torch.trace.host.enable()``, without a profiler.  Then the cost of
one span site alone: the median over five rounds of ``SITES`` empty
``with span(...)`` blocks, off and on.  Prints one JSON object: the median
save and restore seconds of each mode, every turn's readings, the spans an
"on" turn records, the nanoseconds a site takes off and on, and the card's
name and power limit (or "cpu").
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.checkpoint import CheckpointManager, CheckpointPolicy, StorageCluster  # noqa: E402
from repro_torch.trace import host  # noqa: E402

D, HEADS, KV_HEADS = 4096, 32, 4
SHAPES = {"wq": (D, D), "wk": (D, D * KV_HEADS // HEADS), "wv": (D, D * KV_HEADS // HEADS),
          "wo": (D, D)}
K, M, CELL = 6, 3, 1 << 20
NODES, NODE_BYTES = 10, 96 << 20
SITES = 100_000


def state(device) -> dict:
    gen = torch.Generator(device=device).manual_seed(2027)

    def normal(shape):
        return torch.randn(shape, generator=gen, device=device)

    return {"params": {n: normal(s) for n, s in SHAPES.items()},
            "opt": {"mu": {n: normal(s) for n, s in SHAPES.items()},
                    "nu": {n: normal(s).square_() for n, s in SHAPES.items()}}}


def turn(tree: dict, device, step: int) -> dict:
    cluster = StorageCluster(num_nodes=NODES, node_capacity=NODE_BYTES, device=device)
    manager = CheckpointManager(cluster, CheckpointPolicy(k=K, m=M, stripe_bytes=K * CELL))
    t0 = time.perf_counter()
    manager.save(step, tree, blocking=True)
    save_s = time.perf_counter() - t0
    first = cluster.meta.lookup(manager._manifests[step]["leaves"][0]["stripes"][0]["oid"])
    for coord in first.data_coords[:M]:
        cluster.fail_node(coord.node)
    t0 = time.perf_counter()
    got = manager.restore(step)
    restore_s = time.perf_counter() - t0
    for group, leaves in (("params", tree["params"]), ("opt/mu", tree["opt"]["mu"]),
                          ("opt/nu", tree["opt"]["nu"])):
        for name, x in leaves.items():
            if not torch.equal(got[f"{group}/{name}"], x.cpu()):
                raise SystemExit(f"restore of {group}/{name} differs from the state")
    return {"save_s": save_s, "restore_s": restore_s}


def site_ns(on: bool) -> float:
    """Median nanoseconds of one ``with span(...)`` block with a count."""
    rounds = []
    for _ in range(5):
        host.TRACER.clear()
        host.enable(on)
        try:
            t0 = time.perf_counter_ns()
            for i in range(SITES):
                with host.span("site", bytes=i):
                    pass
            rounds.append((time.perf_counter_ns() - t0) / SITES)
        finally:
            host.enable(False)
    host.TRACER.clear()
    return statistics.median(rounds)


def card() -> str:
    if not torch.cuda.is_available():
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=20).stdout.strip()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda" if torch.cuda.is_available() else "cpu")
    parser.add_argument("--repeats", type=int, default=5)
    parser.add_argument("--out", type=Path)
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    tree = state(device)
    nbytes = sum(x.numel() * x.element_size() for part in (tree["params"], tree["opt"]["mu"],
                                                          tree["opt"]["nu"])
                 for x in part.values())
    turn(tree, device, 0)
    turns = {"off": [], "on": []}
    spans = []
    for i in range(args.repeats):
        for mode in ("off", "on"):
            host.TRACER.clear()
            host.enable(mode == "on")
            try:
                turns[mode].append(turn(tree, device, 1 + 2 * i + (mode == "on")))
            finally:
                host.enable(False)
            if mode == "on":
                spans.append(len(host.TRACER) + host.TRACER.dropped)
    out = {"device": args.device, "card": card(), "state_bytes": nbytes, "turns": turns,
           "spans_a_turn": spans, "site_ns": {"off": site_ns(False), "on": site_ns(True)},
           "median": {mode: {key: statistics.median(t[key] for t in rows)
                             for key in ("save_s", "restore_s")}
                      for mode, rows in turns.items()}}
    text = json.dumps(out)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
