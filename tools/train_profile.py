#!/usr/bin/env python3
"""Where a yi-9b training step's time goes on one card: a torch.profiler trace.

    python3 tools/train_profile.py [--out-dir build/profiles] [--no-remat]

Builds the kernels and makes ``chip_smoke.py``'s phase-7a model (yi-9b at its
published widths, its depth cut to 8 of 48 layers, seeded fp32 master
weights and AdamW moments: 30.5 GB), then traces one B=1, S=4096 train step
(``launch.steps.make_train_step``: ``loss_fn``'s gradients by autograd, remat
on unless ``--no-remat``, AdamW in place) after two untraced ones, under
``torch.profiler`` (CPU and CUDA activities).  Prints the wall time, the
device's busy and idle shares, the device time of the kernels that take the
most, and the device time in groups:

* ``attention``: every kernel launched inside blockwise attention's forward
  or backward (its fp32 products and elementwise passes);
* ``loss``: inside the chunked cross-entropy, forward and backward;
* ``adamw``: inside ``adamw_update``;
* elsewhere, by the kernel's name: ``products`` (cuBLAS/CUTLASS), ``casts``
  (copy kernels: the fp32 master weights cast to bf16 at each use, and
  back), ``other`` (norms, rotations, activations, adds).

A kernel is put in a range's group by the CPU op that launched it, through
``torch.profiler.record_function`` ranges this tool wraps around those
functions (the backward of each runs inside its autograd node).  Writes the
Chrome trace to ``OUT_DIR/train_step_trace.json.gz``.  Prints the card's name
and power limit and, last, one JSON object with every number.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke  # noqa: E402
from checkpoint_profile import device_intervals, union_us  # noqa: E402

RANGES = ("attention", "loss", "adamw")
WARM_STEPS = 2


def by_name(name: str) -> str:
    low = name.lower()
    if any(k in low for k in ("gemm", "gemv", "nvjet", "cutlass", "xmma", "splitkreduce")):
        return "products"
    if "copy" in low:
        return "casts"
    return "other"


def ranged(label: str, fn):
    """``fn`` inside a ``record_function(label)`` range."""
    from torch.profiler import record_function

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with record_function(label):
            return fn(*args, **kwargs)

    return wrapper


def instrument() -> None:
    """Wrap blockwise attention's forward and backward, the chunked
    cross-entropy and the AdamW update in their ranges."""
    from repro_torch.launch import steps
    from repro_torch.models import attention, model

    fn = attention._BlockwiseAttention
    fn.forward = staticmethod(ranged("attention", fn.forward))
    fn.backward = staticmethod(ranged("attention", fn.backward))
    model.chunked_cross_entropy = ranged("loss", model.chunked_cross_entropy)
    steps.adamw_update = ranged("adamw", steps.adamw_update)


def group_of(event) -> str | None:
    """The range among ``RANGES`` that encloses a CPU event, if any."""
    while event is not None:
        if event.name in RANGES:
            return event.name
        event = event.cpu_parent
    return None


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out-dir", default=str(ROOT / "build" / "profiles"))
    parser.add_argument("--no-remat", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("train_profile: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.models import init_params
    from repro_torch.optim.adamw import init_opt_state

    torch.backends.cuda.matmul.allow_tf32 = False
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda")
    card = chip_smoke.card_line()
    print(f"card: {card}", flush=True)
    _build.build()
    instrument()
    cfg, _, _ = chip_smoke.training_configs()
    cfg = dataclasses.replace(cfg, remat=not args.no_remat)
    params = init_params(cfg, seed=chip_smoke.MODEL_SEED, device=dev)
    opt = init_opt_state(params)
    batch = chip_smoke.train_batch(cfg, dev, np.random.default_rng(chip_smoke.MODEL_SEED + 1),
                                   chip_smoke.TRAIN_BATCH, chip_smoke.TRAIN_SEQ)
    step = chip_smoke.train_step_of(cfg)
    for _ in range(WARM_STEPS):
        params, opt, metrics = step(params, opt, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, batch)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    intervals = device_intervals(prof)
    busy_s = union_us(intervals) / 1e6
    groups: dict[str, float] = {}
    names: dict[str, float] = {}
    linked_us = 0.0
    for event in prof.events():
        for kernel in getattr(event, "kernels", []):
            label = group_of(event) or by_name(kernel.name)
            groups[label] = groups.get(label, 0.0) + kernel.duration / 1e3
            linked_us += kernel.duration
    for event in prof.events():
        if event.device_type == torch.autograd.DeviceType.CUDA:
            names[event.name] = names.get(event.name, 0.0) + (
                event.time_range.end - event.time_range.start) / 1e3
    if not linked_us:
        # no kernel linked to its CPU op in this profiler: by name alone
        for name, ms in names.items():
            groups[by_name(name)] = groups.get(by_name(name), 0.0) + ms
    prof.export_chrome_trace(str(out_dir / "train_step_trace.json.gz"))
    top = sorted(names.items(), key=lambda kv: -kv[1])[:15]
    res = {"model": cfg.name, "layers": cfg.n_layers, "remat": cfg.remat,
           "batch": [chip_smoke.TRAIN_BATCH, chip_smoke.TRAIN_SEQ], "loss": loss,
           "wall_s": wall_s, "device_busy_s": busy_s, "busy_share": busy_s / wall_s,
           "idle_share": 1 - busy_s / wall_s, "device_events": len(intervals),
           "device_ms_by_group": groups, "grouped_by_range": bool(linked_us),
           "device_ms_by_name": dict(top)}
    print(f"  train step ({cfg.n_layers} layers, remat {cfg.remat}): {wall_s:.3f} s wall, device "
          f"busy {busy_s * 1e3:.3f} ms ({res['busy_share']:.5f}; idle {res['idle_share']:.5f}), "
          f"{len(intervals)} device events", flush=True)
    print(f"  device ms by group: {groups}", flush=True)
    for name, ms in top:
        print(f"    {ms:10.3f} ms  {name[:100]}", flush=True)
    chip_smoke.check(bool(intervals), "the step's trace holds no device activity")
    print(card)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
