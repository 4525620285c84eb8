"""Runs the port's sharded steps, elastic reshard and sharded pipeline in
one process group, each rank against the port's one-device step.

    python tests/_torch_sharded_worker.py OUT_DIR [--world 4] [--phases steps,prefill,...]

Every rank makes the same seeded params and batch, runs the one-device
step itself, places the same params on a mesh as DTensors and runs the
sharded step, then writes, for each leaf it holds the counted copy of
(``StepContext.owns``), the squared error of its shard and the shard's
squared norm, to ``OUT_DIR/rank<i>.json``; the test adds the ranks up.

Phases: ``steps`` (the train step of yi, deepseek-v2 with expert
parallelism, zamba2, xlstm and whisper smoke configs on meshes (2, 2) and
(4, 1), every product in fp32 and as shipped in bf16), ``prefill`` (the
prefill step on (1, 4): a context-parallel split of the sequence),
``elastic`` (the reference test's tree reshard, shrink and grow),
``pipeline`` (``DataPipeline`` with ``shardings``), ``decode`` (the serve
step of every cache layout on meshes (2, 2), (4, 1) and (1, 4), every
product in fp32, and one case as shipped for the reference), in a world of
1 ``decode_one`` (the serve step on a (1, 1) mesh, as shipped, for a
bitwise check), and, in a world of 8, ``moe_ep`` (``moe_ep_apply`` on a
(2, 4) mesh).
"""

import argparse
import contextlib
import dataclasses
import datetime
import json
import socket
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.utils._python_dispatch import TorchDispatchMode

#: the train-step families: (arch, batch, seq)
FAMILIES = {"yi-9b": (4, 64), "deepseek-v2-lite-16b": (4, 64), "zamba2-2.7b": (4, 64),
            "xlstm-125m": (4, 64), "whisper-base": (4, 64)}
MESHES = {"2x2": (2, 2), "4x1": (4, 1)}
MODES = ("fp32", "bf16")
#: the optimizer's step count before the compared step (lr > 0 there)
START_STEP = 20


def smoke_cfg(name: str):
    from repro_torch.configs import ARCHS

    cfg = dataclasses.replace(ARCHS[name].smoke, remat=True)
    if cfg.moe_experts:
        # a capacity that drops nothing: per-rank and per-row routing agree
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    return cfg


def make_batch(cfg, b: int, s: int, seed: int = 23) -> dict:
    rng = np.random.default_rng(seed)
    out = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)),
           "labels": torch.from_numpy(rng.integers(0, cfg.vocab, (b, s)).astype(np.int32))}
    if cfg.family == "encdec":
        out["frames"] = torch.from_numpy(
            rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    return out


@contextlib.contextmanager
def products_in(dtype):
    """The port's ``dense_apply``, ``embed_apply`` and the loss's logits
    computing in ``dtype`` (their defaults switched, and restored after)."""
    from repro_torch.models import layers

    fns = {layers.dense_apply: (dtype,), layers.embed_apply: (dtype,),
           layers.chunked_cross_entropy: (128, dtype, None)}
    saved = {fn: fn.__defaults__ for fn in fns}
    for fn, value in fns.items():
        fn.__defaults__ = value
    try:
        yield
    finally:
        for fn, defaults in saved.items():
            fn.__defaults__ = defaults


def _arch(cfg):
    from repro_torch.configs.base import ArchConfig

    return ArchConfig(model=cfg, smoke=cfg)


def _shape(kind: str, b: int, s: int):
    from repro_torch.configs.base import ShapeConfig

    return ShapeConfig("test", kind, s, b)


def _clone(tree):
    from repro_torch.models.layers import tree_map

    return tree_map(lambda t: t.clone(), tree)


def _opt(params):
    from repro_torch.optim.adamw import init_opt_state

    opt = init_opt_state(params)
    opt["step"] = torch.tensor(START_STEP, dtype=torch.int32)
    return opt


def leaf_errors(got_tree, want_tree, specs, ctx) -> dict:
    """{path: [squared error, squared norm]} of this rank's counted shards:
    ``got_tree``'s DTensors against ``want_tree``'s whole tensors cut the
    same way."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.parallel import sharding as sh

    out = {}
    wants = dict(sh.leaves_with_path(want_tree))
    spec_of = dict(sh.leaves_with_path(specs))
    for path, got in sh.leaves_with_path(got_tree):
        spec = spec_of[path]
        if not ctx.owns(spec):
            continue
        want = distribute_tensor(wants[path], got.device_mesh, got.placements,
                                 src_data_rank=None).to_local()
        g, w = got.to_local().double(), want.double()
        out[path] = [float((g - w).square().sum()), float(w.square().sum())]
    return out


def phase_steps(rank: int) -> dict:
    from repro_torch.kernels import adamw as kadamw
    from repro_torch.launch import mesh as mesh_mod

    meshes = {key: mesh_mod.make_debug_mesh(*shape, device_type="cpu")
              for key, shape in MESHES.items()}
    out = {}
    # whether every tensor the sharded step hands AdamW is contiguous, as
    # its kernel on the card requires (here the plain loop runs)
    contiguous: list[bool] = []
    adamw_step = kadamw.adamw_step

    def recorded(params, grads, ms, vs, *rest):
        contiguous.append(all(t.is_contiguous() for ts in (params, grads, ms, vs) for t in ts))
        return adamw_step(params, grads, ms, vs, *rest)

    kadamw.adamw_step = recorded
    try:
        _steps_cases(rank, meshes, out, contiguous)
    finally:
        kadamw.adamw_step = adamw_step
    return out


def _steps_cases(rank: int, meshes: dict, out: dict, contiguous: list) -> None:
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.parallel import sharding as sh

    for name, (b, s) in FAMILIES.items():
        cfg = smoke_cfg(name)
        arch, shape = _arch(cfg), _shape("train", b, s)
        params0 = M.init_params(cfg, 0, device="cpu")
        batch = make_batch(cfg, b, s)
        for mode in MODES:
            with products_in(getattr(torch, "float32" if mode == "fp32" else "bfloat16")):
                want_p, want_o = _clone(params0), _opt(params0)
                want_p, want_o, want_m = steps.make_train_step(arch, shape)(want_p, want_o, batch)
                for key, mesh in meshes.items():
                    params = sh.distribute_tree(_clone(params0), mesh)
                    opt = _opt(params0)
                    opt = {"m": sh.distribute_tree(opt["m"], mesh),
                           "v": sh.distribute_tree(opt["v"], mesh), "step": opt["step"]}
                    step = steps.make_train_step(arch, shape, mesh)
                    contiguous.clear()
                    got_p, got_o, got_m = step(params, opt, batch)
                    ctx = steps.model_constraints(arch, shape, mesh)[0].ctx
                    specs = sh.param_specs(got_p, mesh)
                    placed = all(
                        t.placements == sh.placements(spec, mesh)
                        for tree in (got_p, got_o["m"], got_o["v"])
                        for (_, t), (_, spec) in zip(sh.leaves_with_path(tree),
                                                     sh.leaves_with_path(specs)))
                    out[f"{name}/{key}/{mode}"] = {
                        "zero_init": [path for path, t in sh.leaves_with_path(params0)
                                      if not bool(t.any())],
                        "loss": [float(got_m["loss"]), float(want_m["loss"])],
                        "grad_norm": [float(got_m["grad_norm"]), float(want_m["grad_norm"])],
                        "step": [int(got_o["step"]), int(want_o["step"])],
                        "placed": placed,
                        "adamw_contiguous": contiguous == [True],
                        "moe_ep": "moe_ep" in (steps.model_constraints(arch, shape, mesh)[2]
                                               or {}),
                        "params": leaf_errors(got_p, want_p, specs, ctx),
                        "m": leaf_errors(got_o["m"], want_o["m"], specs, ctx),
                        "v": leaf_errors(got_o["v"], want_o["v"], specs, ctx),
                    }


def phase_prefill(rank: int) -> dict:
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.parallel import sharding as sh

    mesh = mesh_mod.make_debug_mesh(1, 4, device_type="cpu")
    out = {}
    for name, (b, s) in FAMILIES.items():
        cfg = smoke_cfg(name)
        arch, shape = _arch(cfg), _shape("prefill", 2, s)
        params = M.init_params(cfg, 1, device="cpu")
        batch = {k: v[:2] for k, v in make_batch(cfg, 2, s, seed=5).items() if k != "labels"}
        want = steps.make_prefill_step(arch, shape)(params, batch)
        got = steps.make_prefill_step(arch, shape, mesh)(sh.distribute_tree(params, mesh), batch)
        out[name] = {"err": float((got - want).norm()), "norm": float(want.norm()),
                     "shape": list(got.shape)}
    return out


def phase_elastic(rank: int, world: int) -> dict:
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.parallel import sharding as sh
    from repro_torch.runtime import elastic

    ranks = list(range(world))
    whole = torch.arange(64.0).reshape(8, 8)
    line = elastic.build_mesh(ranks, model_parallel=1)           # (4, 1): the "r" axis
    tree = {"w": distribute_tensor(whole, line, (Shard(0), Replicate()), src_data_rank=None)}
    small = elastic.build_mesh(ranks[:4], model_parallel=2)
    out = {"small_shape": dict(zip(small.mesh_dim_names, small.shape))}
    tree2 = elastic.reshard_state(tree, small)
    out["reshard_equal"] = bool(torch.equal(tree2["w"].full_tensor(), whole))
    out["reshard_placed"] = tree2["w"].placements == sh.placements(
        sh.param_specs(tree2, small)["w"], small)
    shrunk, survivors = elastic.shrink(tree2, small, {2, 3})
    if rank in (0, 1):
        out["shrink_shape"] = dict(zip(survivors.mesh_dim_names, survivors.shape))
        out["shrink_equal"] = bool(torch.equal(shrunk["w"].full_tensor(), whole))
    else:
        out["shrink_evicted"] = shrunk is None
        shrunk = {"w": torch.empty((8, 8), device="meta")}
    grown, big = elastic.grow(shrunk, survivors, ranks[:4], 2)
    out["grow_equal"] = bool(torch.equal(grown["w"].full_tensor(), whole))
    return out


def phase_pipeline(rank: int) -> dict:
    from repro_torch.configs import ARCHS
    from repro_torch.data.pipeline import DataPipeline, PipelineConfig, SyntheticSource
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import steps
    from repro_torch.parallel import sharding as sh

    mesh = mesh_mod.make_debug_mesh(4, 1, device_type="cpu")
    shape = _shape("train", 8, 16)
    shardings = steps.batch_shardings(ARCHS["yi-9b"], shape, mesh)
    pipe = DataPipeline(SyntheticSource(100, seed=3), PipelineConfig(batch=8, seq=16),
                        device="cpu", shardings=shardings)
    try:
        batch = next(iter(pipe))
    finally:
        pipe.close()
    plain = DataPipeline(SyntheticSource(100, seed=3), PipelineConfig(batch=8, seq=16),
                         device="cpu")
    try:
        want = next(iter(plain))
    finally:
        plain.close()
    specs = sh.data_batch_specs({k: (8, 16) for k in batch}, mesh)
    return {"placed": all(batch[k].placements == sh.placements(specs[k], mesh) for k in batch),
            "equal": all(torch.equal(batch[k].full_tensor(), want[k]) for k in batch),
            "local_rows": [batch[k].to_local().shape[0] for k in sorted(batch)]}


#: the decode's families: GQA, MLA with MoE layers, Mamba2 with the shared
#: attention block, xLSTM, and whisper's self and cross caches
DECODE_FAMILIES = ("yi-9b", "deepseek-v2-lite-16b", "zamba2-2.7b", "xlstm-125m",
                   "whisper-base")
DECODE_MESHES = {"2x2": (2, 2), "4x1": (4, 1), "1x4": (1, 4)}
#: B, Smax: a cache dim the rules take for the batch must be the batch (zamba2's
#: 2 groups of 2 layers), and a head dim as long as Smax is never split
DECODE_BATCH, DECODE_MAX_LEN = 4, 12
#: four steps after a seeded prompt, the last at cur_len = Smax (the clamped write)
DECODE_CUR_LENS = (9, 10, 11, 12)
#: the case whose sharded logits the test holds against the reference's decode
DECODE_REFERENCE = ("yi-9b", "2x2")


def seeded_cache(cfg, dtype, seed: int):
    """A cache of (DECODE_BATCH, DECODE_MAX_LEN) rows that the one-device
    decode filled from seeded tokens up to the first of DECODE_CUR_LENS
    (whisper's cross K/V, which a prefill fills, drawn from a seeded normal,
    its encoder length Smax - 2)."""
    from repro_torch.models import decode_step, init_cache, init_params

    rng = np.random.default_rng(seed)
    cache = init_cache(cfg, DECODE_BATCH, DECODE_MAX_LEN, dtype=dtype, device="cpu")
    if cfg.family == "encdec":
        for key in ("k", "v"):
            cache["cross"][key] = torch.from_numpy(rng.standard_normal(
                tuple(cache["cross"][key].shape)).astype(np.float32)).to(dtype)
        cache["enc_len"] = torch.tensor(DECODE_MAX_LEN - 2, dtype=torch.int32)
    params = init_params(cfg, 3, device="cpu")
    tokens = rng.integers(0, cfg.vocab, (DECODE_BATCH, DECODE_CUR_LENS[0])).astype(np.int32)
    for t in range(DECODE_CUR_LENS[0]):
        _, cache = decode_step(params, cfg, cache, {"tokens": torch.from_numpy(tokens[:, t:t + 1]),
                                                    "cur_len": t})
    return cache


def decode_tokens(cfg, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab, (DECODE_BATCH, len(DECODE_CUR_LENS)))
                            .astype(np.int32))


def decode_steps(step, params, cache, tokens) -> list[torch.Tensor]:
    """``step`` at each of DECODE_CUR_LENS; the cache is written in place."""
    out = []
    for i, cur_len in enumerate(DECODE_CUR_LENS):
        logits, cache = step(params, cache, {"tokens": tokens[:, i:i + 1], "cur_len": cur_len})
        out.append(logits)
    return out


def _decode_case(name: str):
    """(cfg, arch, shape, params) of a family's decode at the smoke widths."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import init_params

    cfg = ARCHS[name].smoke
    return cfg, _arch(cfg), _shape("decode", DECODE_BATCH, DECODE_MAX_LEN), \
        init_params(cfg, 3, device="cpu")


def _placed_cache(cache, mesh):
    """A copy of ``cache`` placed on ``mesh`` by ``cache_specs``, and the specs."""
    from repro_torch.parallel import sharding as sh

    specs = sh.cache_specs(cache, mesh, DECODE_MAX_LEN, DECODE_BATCH)
    return sh.distribute_tree(_clone(cache), mesh, specs), specs


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    g, w = got.double(), want.double()
    norm = float(w.norm())
    return float((g - w).norm()) / norm if norm else float((g - w).norm())


class GatheredShapes(TorchDispatchMode):
    """The shapes of every all-gather's output while it is active."""

    def __init__(self):
        super().__init__()
        self.shapes: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "c10d" and "allgather" in func._schema.name:
            self.shapes.append(list(args[0].shape))
        return func(*args, **(kwargs or {}))


def phase_decode(rank: int, out_dir: str) -> dict:
    """Each family's serve step on each mesh against the one-device step,
    every product in fp32 (fp32 caches): the logits of every step and every
    cache leaf after the last, gathered whole, and the shapes of everything
    the sharded steps all-gathered.  Then the reference case as shipped: its
    params, first cache, tokens and sharded logits written for the test."""
    import pickle

    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import steps
    from repro_torch.models.convert import params_to_numpy
    from repro_torch.parallel import sharding as sh

    meshes = {key: mesh_mod.make_debug_mesh(*shape, device_type="cpu")
              for key, shape in DECODE_MESHES.items()}
    out = {}
    gathered = GatheredShapes()
    for name in DECODE_FAMILIES:
        cfg, arch, shape, params = _decode_case(name)
        tokens = decode_tokens(cfg, 4)
        with products_in(torch.float32):
            cache0 = seeded_cache(cfg, torch.float32, 5)
            want_cache = _clone(cache0)
            wants = decode_steps(steps.make_serve_step(arch, shape), params, want_cache, tokens)
            want_leaves = dict(sh.leaves_with_path(want_cache))
            for key, mesh in meshes.items():
                cache, specs = _placed_cache(cache0, mesh)
                step = steps.make_serve_step(arch, shape, mesh)
                with gathered:
                    gots = decode_steps(step, sh.distribute_tree(params, mesh), cache, tokens)
                out[f"{name}/{key}"] = {
                    "logits": [_rel(g, w) for g, w in zip(gots, wants)],
                    "shape": list(gots[0].shape),
                    "cache": {path: _rel(t.full_tensor() if t.dim() else t, want_leaves[path])
                              for path, t in sh.leaves_with_path(cache)},
                    "specs": {path: repr(spec) for path, spec in sh.leaves_with_path(specs)},
                    "placed": all(t.placements == sh.placements(spec, mesh)
                                  for (_, t), (_, spec) in zip(sh.leaves_with_path(cache),
                                                               sh.leaves_with_path(specs))
                                  if t.dim()),
                }
    out["gathered_shapes"] = gathered.shapes
    # the reference case, as shipped (bf16 products and caches)
    name, key = DECODE_REFERENCE
    cfg, arch, shape, params = _decode_case(name)
    tokens = decode_tokens(cfg, 6)
    cache0 = seeded_cache(cfg, torch.bfloat16, 7)
    cache, _ = _placed_cache(cache0, meshes[key])
    step = steps.make_serve_step(arch, shape, meshes[key])
    gots = decode_steps(step, sh.distribute_tree(params, meshes[key]), cache, tokens)
    if rank == 0:
        with open(Path(out_dir) / "decode_reference_case.pkl", "wb") as f:
            pickle.dump({"name": name, "params": params_to_numpy(params),
                         "cache": params_to_numpy(cache0), "tokens": tokens.numpy(),
                         "cur_lens": DECODE_CUR_LENS,
                         "logits": [g.float().numpy() for g in gots]}, f)
    return out


def phase_decode_one(rank: int) -> dict:
    """Each family's serve step on a (1, 1) mesh against the one-device
    step, as shipped: logits and caches bit for bit."""
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import steps
    from repro_torch.models.layers import tree_leaves
    from repro_torch.parallel import sharding as sh

    mesh = mesh_mod.make_debug_mesh(1, 1, device_type="cpu")
    out = {}
    for name in DECODE_FAMILIES:
        cfg, arch, shape, params = _decode_case(name)
        tokens = decode_tokens(cfg, 4)
        cache0 = seeded_cache(cfg, torch.bfloat16, 5)
        want_cache = _clone(cache0)
        wants = decode_steps(steps.make_serve_step(arch, shape), params, want_cache, tokens)
        cache, _ = _placed_cache(cache0, mesh)
        gots = decode_steps(steps.make_serve_step(arch, shape, mesh),
                            sh.distribute_tree(params, mesh), cache, tokens)
        out[name] = {
            "logits": all(torch.equal(g, w) for g, w in zip(gots, wants)),
            "cache": all(torch.equal(g.full_tensor() if hasattr(g, "full_tensor") else g, w)
                         for g, w in zip(tree_leaves(cache), tree_leaves(want_cache))),
        }
    return out


#: the reference test's MoE sizes (tests/test_multidevice.py): E, K, d, ff, B, S
MOE = (8, 2, 32, 64, 4, 16)


def phase_moe_ep(rank: int, out_dir: str) -> dict:
    """``moe_ep_apply`` on a (2, 4) mesh against the dense ``moe_apply``, on
    the reference's params and input (``OUT_DIR/reference.npz``): this
    rank's output block and the gradients of sum(out ** 2), written to
    ``OUT_DIR/moe_rank<i>.npz``."""
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import moe

    e, k, d, ff, b, s = MOE
    ref = np.load(Path(out_dir) / "reference.npz")
    mesh = mesh_mod.make_debug_mesh(2, 4, device_type="cpu")
    di, mi = mesh.get_local_rank("data"), mesh.get_local_rank("model")
    full = {"router": {"w": torch.from_numpy(ref["router"])},
            "w_gate": torch.from_numpy(ref["w_gate"]), "w_up": torch.from_numpy(ref["w_up"]),
            "w_down": torch.from_numpy(ref["w_down"])}
    x = torch.from_numpy(ref["x"])

    def block(t, dims):        # this rank's block: {dim: (axis index, axis size)}
        for dim, (i, n) in dims.items():
            t = t.chunk(n, dim)[i]
        return t.contiguous().requires_grad_()

    local = {"router": {"w": block(full["router"]["w"], {0: (di, 2)})},
             "w_gate": block(full["w_gate"], {0: (mi, 4), 1: (di, 2)}),
             "w_up": block(full["w_up"], {0: (mi, 4), 1: (di, 2)}),
             "w_down": block(full["w_down"], {0: (mi, 4), 2: (di, 2)})}
    xl = block(x, {0: (di, 2), 1: (mi, 4)})
    out = moe.moe_ep_apply(local, xl, e, k, 8.0, mesh, ("data",), "model")
    leaves = [local["router"]["w"], local["w_gate"], local["w_up"], local["w_down"], xl]
    grads = torch.autograd.grad((out.float() ** 2).sum(), leaves)
    dense_in = {"router": {"w": full["router"]["w"].clone().requires_grad_()},
                **{key: full[key].clone().requires_grad_() for key in ("w_gate", "w_up", "w_down")}}
    xd = x.clone().requires_grad_()
    dense = moe.moe_apply(dense_in, xd, e, k, dense_fallback=True)
    dense_leaves = [dense_in["router"]["w"], dense_in["w_gate"], dense_in["w_up"],
                    dense_in["w_down"], xd]
    dense_grads = torch.autograd.grad((dense.float() ** 2).sum(), dense_leaves)
    names = ("router", "w_gate", "w_up", "w_down", "x")
    np.savez(Path(out_dir) / f"moe_rank{rank}.npz", out=out.detach().float().numpy(),
             dense=dense.detach().float().numpy(),
             **{f"grad_{n}": g.float().numpy() for n, g in zip(names, grads)},
             **{f"dense_grad_{n}": g.float().numpy() for n, g in zip(names, dense_grads)},
             coords=np.array([di, mi]))
    return {"coords": [di, mi]}


def run(rank: int, world: int, port: int, out_dir: str, phases: list[str]) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=300))
    out = {}
    for phase in phases:
        if phase == "steps":
            out["steps"] = phase_steps(rank)
        elif phase == "prefill":
            out["prefill"] = phase_prefill(rank)
        elif phase == "elastic":
            out["elastic"] = phase_elastic(rank, world)
        elif phase == "pipeline":
            out["pipeline"] = phase_pipeline(rank)
        elif phase == "decode":
            out["decode"] = phase_decode(rank, out_dir)
        elif phase == "decode_one":
            out["decode_one"] = phase_decode_one(rank)
        elif phase == "moe_ep":
            out["moe_ep"] = phase_moe_ep(rank, out_dir)
        else:
            raise ValueError(phase)
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("out_dir")
    parser.add_argument("--world", type=int, default=4)
    parser.add_argument("--phases", default="steps,prefill,elastic,pipeline")
    args = parser.parse_args()
    mp.spawn(run, args=(args.world, free_port(), args.out_dir, args.phases.split(",")),
             nprocs=args.world)


if __name__ == "__main__":
    main()
