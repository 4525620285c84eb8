#!/usr/bin/env python3
"""The port's sharded train and prefill steps on NCCL, one rank a card.

    python3 tools/sharding_on_cards.py [--out-dir chiprun_out/sharding] [--parts abcde]

Needs four cards and uses four.  Every rank makes the same seeded params
and batches (``chip_smoke``'s seeds and makers), places them on a
(data, model) ``DeviceMesh`` as DTensors by the rules, and runs
``launch.steps``' sharded steps.  Parts:

(a) yi-9b whole (48 layers, published widths, remat on), FSDP training on
    (4, 1) at B=4 and on (2, 2) at B=2, S=4096: the median step ms over
    ``TIMED`` steps after a warm one, tokens/s, model FLOPs over step time
    against 989 TFLOP/s a card, and each card's peak memory.  141 GB of
    training state: more than one card holds.
(b) yi-9b cut to 8 layers, B=4, S=4096: the sharded step on (4, 1) and on
    (2, 2) against the one-card step on rank 0's card from the same params,
    moments and batch: the loss, the grad norm and every leaf of params and
    both moments (relative RMS error; ``LIMITS``).
(c) deepseek-v2-lite at published widths cut to 4 of 27 layers (1 dense, 3
    MoE), B=2, S=4096, on (2, 2), its MoE layers through ``moe_ep_apply``,
    against the same cut on one card, both at a capacity factor that drops
    no token (``MOE_CAPACITY``), so per-rank routing and per-row routing
    keep the same tokens; the one-card step routes each token as the
    mesh's step did (``pinned_routing``, as ``chip_smoke.py`` phase 6 pins
    its comparison prefill).
(d) the context-parallel prefill of yi-9b whole at B=1, S=32768 on (1, 4):
    each rank's quarter of the rows through the flash kernel at its offset
    against the gathered K/V; the last position's logits against the
    one-card prefill within ``chip_smoke.WHOLE_MODEL``, and both ms, with
    the kernel's launches and those with a q_offset.
(e) ``elastic.shrink`` from 4 ranks to 2 after a step of (b)'s cut on
    (2, 2), then one step on the survivors, against a 2-rank step from the
    same state distributed afresh: bit for bit, under deterministic
    algorithms.
(f) the sharded decode of yi-9b whole on (4, 1) and (2, 2): timed at
    decode_32k's cache length (S=32768) and half its batch (B=64: 206 GB
    of bf16 KV cache, 51.5 GB a card), each card's cache shard drawn from
    a seeded normal, ``cur_len`` from ``DECODE_FROM`` near the end: the
    median ms a step over ``DECODE_TIMED`` steps after a warm one,
    tokens/s and each card's peak memory; then the witness
    (``chip_smoke.WITNESS_*``: B=8, S=4096, the last step at ``cur_len =
    Smax``) against the one-card decode on rank 0's card from the same
    params, cache and tokens, as shipped (bf16) and with every product and
    the cache in fp32 (``chip_smoke.fp32_compute``).  Each mesh's tokens
    come from generators of its own (``chip_smoke.token_rng``: one for the
    timed steps, one for the witness), drawn once for both witnesses.  Each
    witness decodes twice on the mesh from the same inputs (bit for bit?),
    and rank 0 runs the one-card controls (``chip_smoke.witness_controls``:
    the batch split as the data ranks split it; on (2, 2) also the scores
    as two halves of the head vector), which read how far bf16 reordering
    alone moves the logits.  Checks, each in the exit code: every step's
    logits within ``chip_smoke.WHOLE_MODEL`` (bf16) and
    ``chip_smoke.FP32_MODEL`` (fp32); in bf16, every step at most
    ``CONTROL_FACTOR`` times the largest control's relative RMS at that
    step; both runs of a witness bit for bit equal.  Beside them, the
    dry-run of the same two 4-card cells (``launch.dryrun.run_cell`` in a
    process of its own): its roofline terms and peak bytes a card.

Prints the card's name and power limit and, last, one JSON object (also
written to ``OUT_DIR/sharding.json``), whose ``failed`` names each check
that failed (``f 2x2 whole_model``, ...); exits 1 if any did.
``--cpu-rehearsal`` runs the same parts on 4 gloo ranks on the CPU at smoke
widths (no numbers to keep: a check of the script before a 4-card call).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import datetime
import json
import os
import statistics
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.models.layers import tree_map  # noqa: E402

WORLD = 4
SEQ = 4096
TIMED = 3
CUT = 8                       # (b) and (e): yi-9b's layers
DSV2_CUT = 4                  # (c): 1 dense + 3 MoE layers
MOE_CAPACITY = 8.0            # (c): drops nothing on either path
PREFILL_SEQ = 32768           # (d)
DECODE_BATCH, DECODE_SEQ = 64, 32768        # (f), timed
DECODE_FROM, DECODE_TIMED = 32758, 8        # (f): the first cur_len, steps after a warm one
#: (f): the mesh's bf16 witness at every step at most this many times the
#: largest relative RMS of the one-card controls at that step
CONTROL_FACTOR = 2.0
START_STEP = 20               # the optimizer's step before a compared step (lr > 0)
#: (b), (c): the sharded step against one card's, both in bf16 (the CPU
#: tests' bf16 limits, tests/test_torch_sharded_step.py): the loss relative
#: error, m (the gradient) and the params relative RMS error a leaf, v (its
#: square) twice that; a leaf that starts at zero is held through m and v
LIMITS = {"loss": 1e-3, "m": 5e-2, "v": 1e-1, "params": 5e-2}
#: "cuda" on the cards; ``--cpu-rehearsal`` sets "cpu" (gloo, smoke widths)
DEVICE_TYPE = "cuda"


def sync() -> None:
    import torch

    if DEVICE_TYPE == "cuda":
        torch.cuda.synchronize()


def empty_cache() -> None:
    import torch

    if DEVICE_TYPE == "cuda":
        torch.cuda.empty_cache()


def log(rank: int, *args) -> None:
    if rank == 0:
        print(*args, flush=True)


def yi(layers: int):
    from repro_torch.configs import ARCHS

    cfg = ARCHS["yi-9b"].model if DEVICE_TYPE == "cuda" else ARCHS["yi-9b"].smoke
    return dataclasses.replace(cfg, n_layers=layers, remat=True)


def dsv2():
    from repro_torch.configs import ARCHS

    arch = ARCHS["deepseek-v2-lite-16b"]
    cfg = arch.model if DEVICE_TYPE == "cuda" else arch.smoke
    return dataclasses.replace(cfg, n_layers=DSV2_CUT if DEVICE_TYPE == "cuda" else 3,
                               capacity_factor=MOE_CAPACITY)


def sharded_params(cfg, mesh, dev, seed=cs.MODEL_SEED, keep_whole=False):
    """Seeded params made whole on this card and placed on ``mesh``, each
    shard in storage of its own; the whole tree is kept only when asked."""
    import torch

    from repro_torch.models import init_params
    from repro_torch.parallel import sharding as sh

    whole = init_params(cfg, seed=seed, device=dev)
    placed = own_shards(sh.distribute_tree(whole, mesh))
    if not keep_whole:
        del whole
        empty_cache()
        return placed, None
    return placed, whole


def own_shards(tree):
    """DTensors whose local shards own their storage (``distribute_tensor``
    may hand back views of the whole tensor it was given)."""
    from torch.distributed.tensor import DTensor

    return tree_map(lambda t: DTensor.from_local(
        t.to_local().clone(), t.device_mesh, t.placements, run_check=False), tree)


def timed_steps(step, params, opt, batch, n: int) -> tuple[list[float], tuple]:
    import torch
    import torch.distributed as dist

    times = []
    for _ in range(n):
        dist.barrier()
        sync()
        start = time.perf_counter()
        params, opt, metrics = step(params, opt, batch)
        sync()
        times.append((time.perf_counter() - start) * 1e3)
    return times, (params, opt, metrics)


def part_a(rank: int, dev) -> dict:
    """yi-9b whole, FSDP training on (4, 1) at B=4 and (2, 2) at B=2."""
    import torch

    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import steps

    cfg = yi(48)
    out = {}
    for key, shape, b in (("4x1", (4, 1), 4), ("2x2", (2, 2), 2)):
        mesh = mesh_mod.make_debug_mesh(*shape, device_type=DEVICE_TYPE)
        arch, cell = cs.arch_shape(cfg, "train", b, SEQ)
        params = sharded_params(cfg, mesh, dev)[0]
        opt = cs.opt_at(params, START_STEP)
        batch = cs.train_batch(cfg, dev, np.random.default_rng(cs.MODEL_SEED + 1), b, SEQ)
        if DEVICE_TYPE == "cuda":
            torch.cuda.reset_peak_memory_stats()
        times, (params, opt, metrics) = timed_steps(
            steps.make_train_step(arch, cell, mesh), params, opt, batch, 1 + TIMED)
        ms = statistics.median(times[1:])
        flops = cs.model_flops(cfg, b * SEQ, SEQ)
        model = flops["bf16"] + flops["attention_fp32"]
        peak = torch.tensor([torch.cuda.max_memory_allocated() if DEVICE_TYPE == "cuda" else 0],
                            device=dev)
        gathered = [torch.zeros_like(peak) for _ in range(WORLD)]
        torch.distributed.all_gather(gathered, peak)
        out[key] = {"batch": [b, SEQ], "step_ms": times, "median_step_ms": ms,
                    "tokens_per_s": b * SEQ / ms * 1e3, "model_flops": model,
                    "share_of_bf16_peak": model / (ms * 1e-3) / (WORLD * cs.PEAK_FLOPS["bfloat16"]),
                    "loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
                    "peak_memory_per_card": [int(x) for x in gathered]}
        log(rank, f"  (a) yi-9b 48 layers on {key}, B={b} S={SEQ}: step {ms:.1f} ms "
                  f"{[round(t, 1) for t in times]}, {out[key]['tokens_per_s']:.1f} tokens/s, "
                  f"{out[key]['share_of_bf16_peak']:.4f} of 4 x 989 TFLOP/s, peak memory a card "
                  f"{out[key]['peak_memory_per_card']}, loss {out[key]['loss']}")
        del params, opt, batch, metrics
        empty_cache()
    return out


def leaf_errors(rank: int, got_tree, want_host: dict, dev) -> dict:
    """Each leaf's relative RMS error of a sharded tree against whole host
    tensors (rank 0 compares; every rank takes part in the gathers)."""
    from repro_torch.parallel import sharding as sh

    out = {}
    for path, got in sh.leaves_with_path(got_tree):
        whole = got.full_tensor()
        if rank == 0:
            want = want_host[path].to(dev)
            out[path] = float((whole.double() - want.double()).norm()
                              / want.double().norm().clamp_min(1e-30))
        del whole
    return out


def one_card_step(rank: int, cfg, dev, b: int, routes: dict | None = None) -> dict | None:
    """Rank 0's one-card step from the seeded start (its MoE layers routed
    as ``routes`` says, when given): its loss, grad norm, and params and
    moments after it on the host (by path)."""
    import torch.distributed as dist

    from repro_torch.launch import steps
    from repro_torch.models import init_params
    from repro_torch.parallel import sharding as sh

    res = None
    if rank == 0:
        arch, cell = cs.arch_shape(cfg, "train", b, SEQ)
        params = init_params(cfg, seed=cs.MODEL_SEED, device=dev)
        zero = {path for path, t in sh.leaves_with_path(params) if not bool(t.any())}
        batch = cs.train_batch(cfg, dev, np.random.default_rng(cs.MODEL_SEED + 1), b, SEQ)
        start = time.perf_counter()
        with pinned_routing(routes) if routes else contextlib.nullcontext():
            params, opt, metrics = steps.make_train_step(arch, cell)(
                params, cs.opt_at(params, START_STEP), batch)
        sync()
        host = {kind: {path: t.cpu() for path, t in sh.leaves_with_path(tree)}
                for kind, tree in (("params", params), ("m", opt["m"]), ("v", opt["v"]))}
        res = {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
               "ms": (time.perf_counter() - start) * 1e3, "host": host, "zero_init": zero}
        del params, opt, metrics, batch
        empty_cache()
    dist.barrier()
    return res


def sharded_step(rank: int, cfg, dev, b: int, shape: tuple) -> tuple[dict, tuple]:
    """The sharded step on a mesh of ``shape`` from the seeded start: its
    row (ms, loss, grad norm) and its (params, moments) DTensors."""
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import steps

    mesh = mesh_mod.make_debug_mesh(*shape, device_type=DEVICE_TYPE)
    arch, cell = cs.arch_shape(cfg, "train", b, SEQ)
    params = sharded_params(cfg, mesh, dev)[0]
    batch = cs.train_batch(cfg, dev, np.random.default_rng(cs.MODEL_SEED + 1), b, SEQ)
    start = time.perf_counter()
    params, opt, metrics = steps.make_train_step(arch, cell, mesh)(
        params, cs.opt_at(params, START_STEP), batch)
    sync()
    row = {"ms": (time.perf_counter() - start) * 1e3, "loss": float(metrics["loss"]),
           "grad_norm": float(metrics["grad_norm"]),
           "moe_ep": "moe_ep" in (steps.model_constraints(arch, cell, mesh)[2] or {})}
    return row, (params, opt)


def against_one_card(rank: int, row: dict, state: tuple, one, dev) -> dict:
    """A sharded step's row completed with its errors against rank 0's
    one-card step (every rank takes part in the gathers)."""
    params, opt = state
    errors = {kind: leaf_errors(rank, tree, one["host"][kind] if one else {}, dev)
              for kind, tree in (("params", params), ("m", opt["m"]), ("v", opt["v"]))}
    if rank == 0:
        row["loss_rel_err"] = abs(row["loss"] - one["loss"]) / abs(one["loss"])
        row["grad_norm_rel_err"] = abs(row["grad_norm"] - one["grad_norm"]) / one["grad_norm"]
        row["worst"] = {}
        for kind, errs in errors.items():
            if kind == "params":
                errs = {p: e for p, e in errs.items() if p not in one["zero_init"]}
            path = max(errs, key=errs.get)
            row["worst"][kind] = [path, errs[path]]
        row["ok"] = (row["loss_rel_err"] <= LIMITS["loss"]
                     and all(e <= LIMITS[k] for k, (_, e) in row["worst"].items()))
    return row


@contextlib.contextmanager
def recorded_routing(routes: dict):
    """Record each MoE layer's routing on the mesh: in the first
    ``moe_ep_apply`` call of a layer, every rank takes the top k experts of
    its tokens as that call does, and the ranks' blocks are joined into the
    whole batch's (B, S, k) choices, ``routes[i]`` for the i-th MoE layer."""
    import torch
    import torch.distributed as dist

    from repro_torch.models import moe
    from repro_torch.parallel import spmd

    saved, order = moe.moe_ep_apply, {}

    def recording(p, x, n_experts, top_k, capacity_factor, mesh, data_axes, model_axis):
        out = saved(p, x, n_experts, top_k, capacity_factor, mesh, data_axes, model_axis)
        key = p["router"]["w"].data_ptr()
        if key not in order:
            order[key] = len(order)
            with torch.no_grad():
                rw = spmd.gather(p["router"]["w"], 0, spmd.mesh_axis(mesh, "data", True))
                bl, sl, d = x.shape
                probs = torch.softmax(x.reshape(-1, d).float() @ rw.float(), dim=-1)
                mine = torch.topk(probs, top_k, dim=-1, sorted=True).indices
                blocks = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
                dist.all_gather(blocks, mine.contiguous())
                grid = mesh.mesh
                whole = torch.empty((grid.shape[0] * bl, grid.shape[1] * sl, top_k),
                                    dtype=mine.dtype, device=mine.device)
                for r, block in enumerate(blocks):
                    di, mi = (int(i) for i in (grid == r).nonzero()[0])
                    whole[di * bl:(di + 1) * bl, mi * sl:(mi + 1) * sl] = block.reshape(
                        bl, sl, top_k)
                routes[order[key]] = whole
        return out

    moe.moe_ep_apply = recording
    try:
        yield routes
    finally:
        moe.moe_ep_apply = saved


@contextlib.contextmanager
def pinned_routing(routes: dict):
    """The one-card MoE layers routed as ``routes`` says (the i-th MoE layer
    by the order of first calls, its recompute under remat as its forward):
    ``chip_smoke.moe_plain`` with those choices, every choice kept (the
    capacity factor drops none), weighted by the layer's own
    probabilities."""
    import torch

    from repro_torch.models import moe

    saved, order = moe.moe_apply, {}

    def pinned(p, x, n_experts, top_k, capacity_factor=1.25, dense_fallback=False):
        if dense_fallback:
            return saved(p, x, n_experts, top_k, capacity_factor, dense_fallback)
        key = order.setdefault(p["router"]["w"].data_ptr(), len(order))
        top_i = routes[key].reshape(-1, top_k)
        keep = torch.ones_like(top_i, dtype=torch.bool)
        return cs.moe_plain(p, x, n_experts, top_k, capacity_factor, (top_i, keep))[0]

    moe.moe_apply = pinned
    try:
        yield
    finally:
        moe.moe_apply = saved


def part_b(rank: int, dev) -> dict:
    cfg = yi(CUT)
    one = one_card_step(rank, cfg, dev, 4)
    res = {"one_card": None if one is None else {k: one[k] for k in ("loss", "grad_norm", "ms")}}
    for key, shape in (("4x1", (4, 1)), ("2x2", (2, 2))):
        row, state = sharded_step(rank, cfg, dev, 4, shape)
        res[key] = against_one_card(rank, row, state, one, dev)
        log(rank, f"    {cfg.name} ({cfg.n_layers} layers) on {key}, B=4: {res[key]}")
        del state
        empty_cache()
    return res


def part_c(rank: int, dev) -> dict:
    """The sharded step first, its routing recorded; then the one-card step
    routed as the mesh routed (near-ties of a router would otherwise part
    the two on tokens whose choice is a coin toss in bf16)."""
    cfg = dsv2()
    routes: dict = {}
    with recorded_routing(routes):
        row, state = sharded_step(rank, cfg, dev, 2, (2, 2))
    one = one_card_step(rank, cfg, dev, 2, routes)
    res = {"one_card": None if one is None else {k: one[k] for k in ("loss", "grad_norm", "ms")},
           "pinned_layers": len(routes)}
    res["2x2"] = against_one_card(rank, row, state, one, dev)
    log(rank, f"    {cfg.name} ({cfg.n_layers} layers) on 2x2, B=2, routing pinned: {res['2x2']}")
    del state
    empty_cache()
    return res


def part_d(rank: int, dev) -> dict:
    """yi-9b whole, prefill at S=32768 on (1, 4) against one card's."""
    import torch
    import torch.distributed as dist

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import steps

    cfg = yi(48)
    mesh = mesh_mod.make_debug_mesh(1, 4, device_type=DEVICE_TYPE)
    arch, cell = cs.arch_shape(cfg, "prefill", 1, PREFILL_SEQ)
    params, whole = sharded_params(cfg, mesh, dev, keep_whole=rank == 0)
    batch = {"tokens": cs.train_batch(cfg, dev, np.random.default_rng(cs.MODEL_SEED + 3), 1,
                                      PREFILL_SEQ)["tokens"]}
    res = {}
    if rank == 0:
        one = steps.make_prefill_step(arch, cell)
        want = one(whole, batch)
        sync()
        start = time.perf_counter()
        want = one(whole, batch)
        sync()
        res["one_card_ms"] = (time.perf_counter() - start) * 1e3
        del whole
        empty_cache()
    dist.barrier()
    step = steps.make_prefill_step(arch, cell, mesh)
    launches, offsets = fa.flash_attention_fwd.launches, fa.flash_attention_fwd.offset_launches
    got = step(params, batch)
    sync()
    counts = torch.tensor([fa.flash_attention_fwd.launches - launches,
                           fa.flash_attention_fwd.offset_launches - offsets], device=dev)
    gathered = [torch.zeros_like(counts) for _ in range(WORLD)]
    dist.all_gather(gathered, counts)
    times = []
    for _ in range(2):
        dist.barrier()
        sync()
        start = time.perf_counter()
        step(params, batch)
        sync()
        times.append((time.perf_counter() - start) * 1e3)
    res.update({"mesh": [1, 4], "batch": [1, PREFILL_SEQ], "mesh_ms": times,
                "launches_per_rank": [int(c[0]) for c in gathered],
                "offset_launches_per_rank": [int(c[1]) for c in gathered]})
    if rank == 0:
        res["closeness"] = dict(zip(("max_abs_err", "tolerance_share", "rel_rms_err"),
                                    cs.closeness(got, want, cs.WHOLE_MODEL)))
        res["tolerance"] = cs.WHOLE_MODEL
        res["ok"] = (res["closeness"]["tolerance_share"] <= 1.0
                     and res["closeness"]["rel_rms_err"] <= cs.WHOLE_MODEL["rel_rms"]
                     and all(c == cfg.n_layers for c in res["launches_per_rank"]))
    log(rank, f"  (d) yi-9b 48 layers prefill S={PREFILL_SEQ} on (1, 4): {res}")
    del params, got
    empty_cache()
    return res


def part_e(rank: int, dev) -> dict:
    """A step on (2, 2), shrink to ranks 0 and 1, a step; against a 2-rank
    step from the same state distributed afresh."""
    import torch

    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import steps
    from repro_torch.models.layers import tree_leaves
    from repro_torch.parallel import sharding as sh
    from repro_torch.runtime import elastic

    cfg = yi(CUT)
    b = 2
    arch, cell = cs.arch_shape(cfg, "train", b, SEQ)
    mesh = mesh_mod.make_debug_mesh(2, 2, device_type=DEVICE_TYPE)
    batch = cs.train_batch(cfg, dev, np.random.default_rng(cs.MODEL_SEED + 2), b, SEQ)
    params = sharded_params(cfg, mesh, dev)[0]
    with cs.deterministic():
        params, opt, _ = steps.make_train_step(arch, cell, mesh)(
            params, cs.opt_at(params, START_STEP), batch)
    state = {"params": params, "m": opt["m"], "v": opt["v"]}
    count = opt["step"]
    whole = tree_map(lambda t: t.full_tensor().cpu(), state)   # on every rank
    del params, opt
    sync()
    start = time.perf_counter()
    moved, small = elastic.shrink(state, mesh, {2, 3})
    sync()
    res = {"shrink_ms": (time.perf_counter() - start) * 1e3}
    del state
    empty_cache()
    if moved is not None:
        kept = all(torch.equal(a.full_tensor().cpu(), w) for a, w in
                   zip(tree_leaves(moved), tree_leaves(whole)))
        fresh = own_shards({key: sh.distribute_tree(tree_map(lambda t: t.to(dev), whole[key]),
                                                    small) for key in whole})
        del whole
        empty_cache()
        step = steps.make_train_step(arch, cell, small)
        with cs.deterministic():
            after = step(moved["params"], {"m": moved["m"], "v": moved["v"], "step": count},
                         batch)
            again = step(fresh["params"], {"m": fresh["m"], "v": fresh["v"], "step": count},
                         batch)
        equal = float(after[2]["loss"]) == float(again[2]["loss"]) and all(
            torch.equal(x.to_local(), y.to_local()) for x, y in
            zip(tree_leaves((after[0], after[1]["m"], after[1]["v"])),
                tree_leaves((again[0], again[1]["m"], again[1]["v"]))))
        res.update({"survivors": dict(zip(small.mesh_dim_names, small.shape)), "kept": kept,
                    "next_step_equal": equal, "loss": float(after[2]["loss"])})
        del after, again, moved, fresh
    else:
        res["evicted"] = True
        del whole
    empty_cache()
    log(rank, f"  (e) shrink 4 -> 2 after a step of yi-9b {CUT} layers: {res}")
    return res


def seeded_local_cache(cfg, b: int, s: int, mesh, dev, seed: int):
    """The decode cache of (b, s) rows placed by ``cache_specs``: each rank
    draws only its own shards, from a normal seeded by ``seed`` and its rank
    (no whole cache is made; 51.5 GB a card at B=64, S=32768)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.models import init_cache
    from repro_torch.parallel import sharding as sh

    struct = init_cache(cfg, b, s, device="meta")
    specs = sh.cache_specs(struct, mesh, s, b)
    sizes = sh.mesh_shape(mesh)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed * 1000 + dist.get_rank())

    def one(leaf, spec):
        local = list(leaf.shape)
        for d, entry in enumerate(spec):
            if entry is not None:
                local[d] //= sizes[entry]
        shard = torch.empty(local, dtype=leaf.dtype, device=dev)
        for i in range(shard.shape[0]):        # a layer at a time: no fp32 copy of it all
            shard[i].copy_(torch.randn(shard[i].shape, generator=gen, device=dev))
        return DTensor.from_local(shard, mesh, sh.placements(spec, mesh), run_check=False,
                                  shape=leaf.shape, stride=leaf.stride())

    return sh.spec_map(one, struct, specs)


def decode_roofline(cells: list) -> dict:
    """The dry-run of each (mesh shape, B, S) decode cell of yi-9b, in a
    process of its own (a fake world is process-global)."""
    import subprocess

    script = (
        "import json, sys\n"
        "from repro_torch.configs.base import ShapeConfig\n"
        "from repro_torch.launch.dryrun import run_cell\n"
        "out = {}\n"
        "for mesh, b, s in json.loads(sys.argv[1]):\n"
        "    shape = ShapeConfig(f'decode_b{b}_s{s}', 'decode', s, b)\n"
        "    row = run_cell('yi-9b', shape, mesh_shape=tuple(mesh), save=False, verbose=False)\n"
        "    out['x'.join(map(str, mesh))] = {'roofline': row['roofline'],\n"
        "        'memory_analysis': row['memory_analysis'], 'trace_s': row['trace_s']}\n"
        "print(json.dumps(out))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-W", "ignore", "-c", script, json.dumps(cells)],
                          env=env, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        return {"error": proc.stderr[-2000:]}
    return json.loads(proc.stdout.strip().splitlines()[-1])


def gathered_whole(rank: int, params):
    """Rank 0's whole params from the mesh (every rank takes part)."""
    whole = tree_map(lambda t: t.full_tensor(), params)
    return whole if rank == 0 else None


def decode_witness(rank: int, cfg, mesh, shape, params, one_params, dev, tokens: np.ndarray,
                   tol: dict) -> dict | None:
    """(f)'s witness on the mesh of ``shape``: the sharded decode twice from
    the witness's cache and ``tokens``, each run against the one-card decode
    on rank 0's card from the same params, cache and tokens (within ``tol``),
    and the one-card controls against that decode (rank 0's row; the
    dtypes are ``init_cache``'s and ``dense_apply``'s defaults)."""
    import torch

    from repro_torch.launch import steps
    from repro_torch.parallel import sharding as sh

    arch, cell = cs.arch_shape(cfg, "decode", cs.WITNESS_BATCH, cs.WITNESS_SEQ)
    step = steps.make_serve_step(arch, cell, mesh)
    on_dev = torch.from_numpy(tokens).to(dev)
    runs = []
    for _ in range(2):
        whole = cs.witness_cache(cfg, dev)
        dtype = str(whole["scan"]["k"].dtype)
        cache = own_shards(sh.distribute_tree(
            whole, mesh, sh.cache_specs(whole, mesh, cs.WITNESS_SEQ, cs.WITNESS_BATCH)))
        del whole
        runs.append(cs.decode_steps(step, params, cache, on_dev, cs.WITNESS_LENS))
        del cache
    res = None
    if rank == 0:
        want = cs.witness_decode(one_params, cfg, dev, tokens)
        controls = cs.witness_controls(one_params, cfg, dev, tokens, shape)
        res = {"batch": [cs.WITNESS_BATCH, cs.WITNESS_SEQ], "lens": list(cs.WITNESS_LENS),
               "dtype": dtype, "tokens": tokens.tolist(), "tolerance": tol,
               **cs.distances(runs[0], want, tol),
               "rel_rms_err_again": cs.distances(runs[1], want, tol)["rel_rms_err"],
               "repeat_bitwise": all(torch.equal(a, b) for a, b in zip(*runs)),
               "finite": all(bool(torch.isfinite(g).all()) for g in runs[0]),
               "controls": {name: cs.distances(got, want, tol) for name, got in controls.items()},
               # the mesh against each control: 0 where the control is its arithmetic
               "mesh_vs_controls": {name: cs.distances(runs[0], got, tol)["rel_rms_err"]
                                    for name, got in controls.items()}}
        res["control_floor"] = [max(c["rel_rms_err"][i] for c in res["controls"].values())
                                for i in range(len(cs.WITNESS_LENS))]
        res["within_controls"] = all(e <= CONTROL_FACTOR * f for e, f in
                                     zip(res["rel_rms_err"], res["control_floor"]))
        res["within_tolerance"] = (res["tolerance_share"] <= 1.0
                                   and max(res["rel_rms_err"]) <= tol["rel_rms"])
        del want, controls
    del runs
    empty_cache()
    return res


def part_f(rank: int, dev) -> dict:
    """yi-9b whole, the sharded decode on (4, 1) and (2, 2): timed at B=64,
    S=32768; the witness at B=8, S=4096 against one card."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import steps

    cfg = yi(48)
    out = {}
    for key, shape in cs.WITNESS_MESHES.items():
        mesh = mesh_mod.make_debug_mesh(*shape, device_type=DEVICE_TYPE)
        params = sharded_params(cfg, mesh, dev)[0]
        # timed, at decode_32k's cache length
        arch, cell = cs.arch_shape(cfg, "decode", DECODE_BATCH, DECODE_SEQ)
        cache = seeded_local_cache(cfg, DECODE_BATCH, DECODE_SEQ, mesh, dev, 1)
        tokens = torch.from_numpy(cs.token_rng("timed", shape).integers(
            0, cfg.vocab, (DECODE_BATCH, 1 + DECODE_TIMED))).to(dev)
        step = steps.make_serve_step(arch, cell, mesh)
        if DEVICE_TYPE == "cuda":
            torch.cuda.reset_peak_memory_stats()
        times = []
        for i in range(1 + DECODE_TIMED):
            dist.barrier()
            sync()
            start = time.perf_counter()
            logits, cache = step(params, cache, {"tokens": tokens[:, i:i + 1],
                                                 "cur_len": DECODE_FROM + i})
            sync()
            times.append((time.perf_counter() - start) * 1e3)
        ms = statistics.median(times[1:])
        peak = torch.tensor([torch.cuda.max_memory_allocated() if DEVICE_TYPE == "cuda" else 0],
                            device=dev)
        gathered = [torch.zeros_like(peak) for _ in range(WORLD)]
        dist.all_gather(gathered, peak)
        row = {"batch": [DECODE_BATCH, DECODE_SEQ], "step_ms": times, "median_step_ms": ms,
               "tokens_per_s": DECODE_BATCH / ms * 1e3,
               "peak_memory_per_card": [int(x) for x in gathered],
               "logits_shape": list(logits.shape),
               "finite": bool(torch.isfinite(logits).all())}
        del cache, logits
        empty_cache()
        # the witnesses: the same params, cache seed and tokens, as shipped
        # (bf16) and with every product and the cache in fp32
        one_params = gathered_whole(rank, params)
        witness = cs.witness_tokens(cfg, shape)
        row["witness"] = decode_witness(rank, cfg, mesh, shape, params, one_params, dev,
                                        witness, cs.WHOLE_MODEL)
        with cs.fp32_compute():
            row["witness_fp32"] = decode_witness(rank, cfg, mesh, shape, params, one_params,
                                                 dev, witness, cs.FP32_MODEL)
        if rank == 0:
            bf16, fp32 = row["witness"], row["witness_fp32"]
            row["checks"] = {"finite": row["finite"] and bf16["finite"] and fp32["finite"],
                             "whole_model": bf16["within_tolerance"],
                             "within_controls": bf16["within_controls"],
                             "fp32_model": fp32["within_tolerance"],
                             "repeat_bitwise": bf16["repeat_bitwise"] and fp32["repeat_bitwise"]}
            row["ok"] = all(row["checks"].values())
        del one_params, params
        empty_cache()
        dist.barrier()
        out[key] = row
        log(rank, f"  (f) yi-9b 48 layers decode on {key}, B={DECODE_BATCH} S={DECODE_SEQ}: "
                  f"step {ms:.1f} ms {[round(t, 1) for t in times]}, "
                  f"{row['tokens_per_s']:.1f} tokens/s, peak memory a card "
                  f"{row['peak_memory_per_card']}; checks {row.get('checks')}")
        for name in ("witness", "witness_fp32") if rank == 0 else ():
            w = row[name]
            log(rank, f"    {name} ({w['dtype']}): relative RMS {w['rel_rms_err']}, again "
                      f"{w['rel_rms_err_again']}, bit for bit {w['repeat_bitwise']}, "
                      f"{w['tolerance_share']:.4g} of the row allowance; controls "
                      f"{ {k: c['rel_rms_err'] for k, c in w['controls'].items()} }; "
                      f"the mesh against them {w['mesh_vs_controls']}")
    return out


def run(rank: int, port: int, parts: str, out_dir: str, device_type: str) -> None:
    import torch
    import torch.distributed as dist

    global DEVICE_TYPE, SEQ, PREFILL_SEQ, DECODE_BATCH, DECODE_SEQ, DECODE_FROM
    DEVICE_TYPE = device_type
    # (f) reads whether cuBLAS's workspace is fixed before CUDA starts here
    env = {"cublas_workspace_config": os.environ.get("CUBLAS_WORKSPACE_CONFIG"),
           "cuda_initialized": torch.cuda.is_initialized()}
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cuda.matmul.allow_tf32 = False
    if device_type == "cuda":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=WORLD, rank=rank,
                                timeout=datetime.timedelta(seconds=300), device_id=dev)
        from repro_torch.kernels import _build

        if rank == 0:
            _build.build()
        dist.barrier()
        _build.build()
    else:
        dev = torch.device("cpu")
        torch.set_num_threads(1)
        SEQ, PREFILL_SEQ = 64, 128
        DECODE_BATCH, DECODE_SEQ, DECODE_FROM = 8, 64, 60
        cs.WITNESS_SEQ, cs.WITNESS_LENS = 32, (29, 30, 31, 32)
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=WORLD, rank=rank)
    out = {"world": WORLD, "card": cs.card_line() if rank == 0 and device_type == "cuda"
           else None, "env": {**env, "set_before_cuda": not env["cuda_initialized"]}}
    fns = {"a": part_a, "b": part_b, "c": part_c, "d": part_d, "e": part_e, "f": part_f}
    try:
        for part in parts:
            t0 = time.perf_counter()
            log(rank, f"part ({part})")
            out[part] = fns[part](rank, dev)
            out[part]["seconds"] = time.perf_counter() - t0
    finally:
        if rank == 0:
            Path(out_dir).mkdir(parents=True, exist_ok=True)
            Path(out_dir, "sharding.json").write_text(json.dumps(out, default=str))
        dist.destroy_process_group()


def main() -> int:
    import torch
    import torch.multiprocessing as mp

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out-dir", default="chiprun_out/sharding")
    parser.add_argument("--parts", default="abcdef")
    parser.add_argument("--cpu-rehearsal", action="store_true")
    args = parser.parse_args()
    device_type = "cpu" if args.cpu_rehearsal else "cuda"
    if device_type == "cuda" and torch.cuda.device_count() < WORLD:
        print(f"needs {WORLD} cards, found {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    card = cs.card_line() if device_type == "cuda" else "cpu rehearsal"
    print(f"card: {card}", flush=True)
    mp.spawn(run, args=(cs.free_port(), args.parts, args.out_dir, device_type), nprocs=WORLD)
    out = json.loads(Path(args.out_dir, "sharding.json").read_text())
    failed = [part for part in args.parts if part in "bc"
              and not all(row.get("ok", True) for row in out[part].values()
                          if isinstance(row, dict))]
    if "f" in args.parts:
        failed += [f"f {key} {check}" for key in cs.WITNESS_MESHES
                   for check, ok in out["f"][key]["checks"].items() if not ok]
    if "d" in args.parts and not out["d"].get("ok"):
        failed.append("d")
    if "e" in args.parts and not out["e"].get("next_step_equal"):
        failed.append("e")
    if "f" in args.parts:
        b, s = (DECODE_BATCH, DECODE_SEQ) if device_type == "cuda" else (8, 64)
        out["f"]["dryrun"] = decode_roofline([[[4, 1], b, s], [[2, 2], b, s]])
        print(f"  (f) dry-run of the same cells: {out['f']['dryrun']}", flush=True)
        if "error" in out["f"]["dryrun"]:
            failed.append("f dry-run")
        Path(args.out_dir, "sharding.json").write_text(json.dumps(out, default=str))
    print(card)
    print(json.dumps({**out, "failed": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
