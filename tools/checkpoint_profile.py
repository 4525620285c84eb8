#!/usr/bin/env python3
"""Where the checkpoint path's time goes on one card: a torch.profiler trace.

    python3 tools/checkpoint_profile.py [--out-dir chiprun_out]

Builds the kernels, makes ``chip_smoke.py``'s phase-5 state (one yi-9b
attention layer's training state, 0.38 GB), saves it under RS-6-3-1024k
into a 10-node cluster on the card and restores it after 3 nodes holding
data cells fail, each step once under ``torch.profiler`` (CPU and CUDA
activities).  For each step it prints the wall time, the device time of
each kernel and copy by name (the profiler's device self time), and the
device's busy share: the union of its kernel, copy and memset intervals
over the wall time (the rest is its idle share).  Writes each step's
Chrome trace to ``OUT_DIR/checkpoint_<step>_trace.json.gz``.  Prints the
card's name and power limit and, last, one JSON object with every number.
Fails if a step's trace holds no device activity.  The save writes on the
manager's background thread: the device's activity is traced whatever
thread launched it, the host ops of that thread may be missing.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402


def device_intervals(prof) -> list[tuple[float, float]]:
    """(start, end) in microseconds of every device event in the trace."""
    import torch

    return [(e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def union_us(intervals: list[tuple[float, float]]) -> float:
    busy, end = 0.0, float("-inf")
    for lo, hi in sorted(intervals):
        if hi <= end:
            continue
        busy += hi - max(lo, end)
        end = hi
    return busy


def profiled(name: str, fn, out_dir: Path, prefix: str = "checkpoint", top_n: int = 8,
             group=None) -> dict:
    """``fn()`` once under the profiler: wall time, device busy and idle
    shares, the ``top_n`` device events by time and, given ``group`` (event
    name -> group name), the device time of every event by group."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    intervals = device_intervals(prof)
    busy_s = union_us(intervals) / 1e6
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:top_n]
    prof.export_chrome_trace(str(out_dir / f"{prefix}_{name}_trace.json.gz"))
    res = {"wall_s": wall_s, "device_busy_s": busy_s, "busy_share": busy_s / wall_s,
           "idle_share": 1 - busy_s / wall_s, "device_events": len(intervals),
           "device_ms_by_name": {k: v / 1e3 for k, v in top}}
    if group is not None:
        groups: dict[str, float] = {}
        for k, v in by_name.items():
            groups[group(k)] = groups.get(group(k), 0.0) + v / 1e3
        res["device_ms_by_group"] = groups
    print(f"  {name}: {wall_s:.3f} s wall, device busy {busy_s * 1e3:.3f} ms "
          f"({res['busy_share']:.5f} of the wall; idle {res['idle_share']:.5f}), "
          f"{len(intervals)} device events", flush=True)
    for k, v in top:
        print(f"    {v / 1e3:10.3f} ms  {k[:100]}", flush=True)
    return res


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out-dir", default=str(ROOT / "chiprun_out"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("checkpoint_profile: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.checkpoint import CheckpointManager, CheckpointPolicy, StorageCluster
    from repro_torch.kernels import _build

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda")
    card = chip_smoke.card_line()
    print(f"card: {card}", flush=True)
    _build.build()
    state = chip_smoke.yi_layer_state(dev)
    K, M = chip_smoke.K, chip_smoke.M
    cluster = StorageCluster(num_nodes=chip_smoke.CLUSTER_NODES,
                             node_capacity=chip_smoke.CKPT_NODE_CAPACITY, device=dev)
    mgr = CheckpointManager(cluster, CheckpointPolicy(
        k=K, m=M, stripe_bytes=chip_smoke.CKPT_STRIPE_BYTES, encode="client"))
    res = {"save": profiled("save", lambda: mgr.save(chip_smoke.CKPT_STEP, state, blocking=True),
                            out_dir)}
    manifest = mgr._manifests[chip_smoke.CKPT_STEP]
    first = cluster.meta.lookup(manifest["leaves"][0]["stripes"][0]["oid"])
    for i in range(M):
        cluster.fail_node(first.data_coords[i].node)
    restored = {}
    res["restore"] = profiled("restore", lambda: restored.update(mgr.restore()), out_dir)
    chip_smoke.check(len(restored) == len(manifest["leaves"]), "restore lost a leaf")
    chip_smoke.check(all(r["device_events"] for r in res.values()),
                     "a step's trace holds no device activity")
    print(card)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
