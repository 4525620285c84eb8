"""Multi-pod dry-run: trace every (arch x shape) cell's step on the production
mesh and record memory, collective and roofline artifacts (PyTorch port of
``repro.launch.dryrun``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes

Outputs one JSON per cell under experiments/dryrun_torch/ (or
``REPRO_TORCH_DRYRUN_DIR``).

The reference lowers and compiles each step with XLA on 512 host devices.
Here the mesh is a ``DeviceMesh`` over a fake process group of 256 or 512
ranks in this process (``torch.testing``'s ``FakeStore``, backend
``"fake"``: every collective completes at once and moves nothing), and
this process is rank 0.  The step's inputs are ``meta`` tensors of rank
0's local shard shapes, as :func:`repro_torch.launch.steps.step_shardings`
places them, wrapped as DTensors of the whole shapes; the step runs once
under :func:`repro_torch.launch.roofline.analyze_step`, which counts its
FLOPs, HBM bytes and collectives and tracks the storage alive.  A ``meta``
tensor has a shape and no numbers, so every model runs at its published
widths and depth at no memory cost, and an op that needs a value fails its
cell.  A fake world is process-global: run the dry-run in a process of its
own (the tests and ``chip_smoke.py`` start one).

``memory_analysis`` holds the argument bytes (the local shards' sum), the
output bytes, the peak bytes a card (the most storage alive at once, the
arguments included) and the temp bytes (peak less arguments).  XLA's
``cost_analysis`` and its lower and compile times have no counterpart;
``trace_s`` is the traced step's wall time.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import SHAPES, cells, get_arch
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import input_specs, make_step, step_shardings
from repro_torch.parallel import sharding as sh

OUT_DIR = os.environ.get(
    "REPRO_TORCH_DRYRUN_DIR",
    str(Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"),
)


def fake_world(size: int) -> None:
    """A fake process group of ``size`` ranks in this process, this process
    rank 0 (one made before with another size is replaced)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == size and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)


def device_mesh(sizes: tuple[int, ...], names: tuple[str, ...]):
    """A ``DeviceMesh`` of ``sizes`` over a fake world of their product."""
    from torch.distributed.device_mesh import init_device_mesh

    fake_world(int(torch.tensor(sizes).prod()))
    return init_device_mesh("cpu", sizes, mesh_dim_names=names)


def _local_shape(shape: tuple[int, ...], spec, mesh) -> tuple[int, ...]:
    sizes = sh.mesh_shape(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        for a in ((entry,) if isinstance(entry, str) else entry or ()):
            out[d] //= sizes[a]
    return tuple(out)


def placed_struct(struct, shardings, mesh):
    """Each ``meta`` leaf of ``struct`` as a DTensor of its whole shape whose
    local shard is rank 0's, placed by its sharding (0-d leaves stay plain)."""
    from torch.distributed.tensor import DTensor

    def one(leaf, sharding):
        if leaf.dim() == 0:
            return leaf
        local = torch.empty(_local_shape(tuple(leaf.shape), sharding.spec, mesh),
                            dtype=leaf.dtype, device="meta")
        return DTensor.from_local(local, mesh, sh.placements(sharding.spec, mesh),
                                  run_check=False, shape=leaf.shape, stride=leaf.stride())

    return sh.spec_map(one, struct, shardings)


def run_cell(arch_name, shape_name, multi_pod: bool = False, save: bool = True,
             verbose: bool = True, mesh_shape: tuple[int, ...] | None = None) -> dict:
    """One cell: ``arch_name`` an arch's name or an ``ArchConfig``,
    ``shape_name`` a name of ``SHAPES`` or a ``ShapeConfig``; ``mesh_shape``
    (data, model) or (pod, data, model) sizes in place of the production
    mesh's."""
    arch = arch_name if isinstance(arch_name, ArchConfig) else get_arch(arch_name)
    shape = shape_name if isinstance(shape_name, ShapeConfig) else SHAPES[shape_name]
    if isinstance(shape_name, str) and not arch.supports(shape_name):
        note = dict(arch.skip_notes).get(shape_name, "unsupported shape")
        return {"arch": arch.name, "shape": shape.name, "skipped": note}
    sizes = tuple(mesh_shape or make_production_mesh(multi_pod=multi_pod).axis_sizes)
    names = make_production_mesh(multi_pod=len(sizes) == 3).axis_names
    mesh_name = ("mesh" if mesh_shape else "pod") + "x".join(map(str, sizes))
    mesh = device_mesh(sizes, names)
    chips = mesh.size()
    t0 = time.time()
    step = make_step(arch, shape, mesh)
    in_sh, _ = step_shardings(arch, shape, mesh)
    specs = input_specs(arch, shape)
    if shape.kind == "train":
        structs = (specs["params"], specs["opt_state"], specs["batch"])
    elif shape.kind == "prefill":
        structs = (specs["params"], specs["batch"])
    else:
        structs = (specs["params"], specs["cache"], specs["batch"])
    args = tuple(placed_struct(s, shard, mesh) for s, shard in zip(structs, in_sh))
    t_build = time.time() - t0
    ana = rl.analyze_step(step, *args)
    t_trace = time.time() - t0 - t_build
    arg_bytes = rl.tensor_bytes(args)
    roof = rl.Roofline(
        flops_per_chip=ana.flops_per_chip,
        hbm_bytes=ana.hbm_bytes_per_chip,
        collective_bytes=ana.collective_bytes_per_chip,
        chips=chips,
        model_flops=rl.model_flops_for_cell(arch, shape),
        collectives=ana.collectives,
    )
    out = {
        "arch": arch.name,
        "shape": shape.name,
        "mesh": mesh_name,
        "chips": chips,
        "kind": shape.kind,
        "build_s": round(t_build, 1),
        "trace_s": round(t_trace, 1),
        "memory_analysis": {
            "bytes_per_device": ana.peak_bytes - arg_bytes,
            "argument_bytes": arg_bytes,
            "output_bytes": ana.output_bytes,
            "peak_bytes": ana.peak_bytes,
        },
        "max_loop_mult": ana.max_loop_mult,
        "collective_counts": ana.collective_counts,
        "top_hbm": ana.top_hbm,
        "top_coll": ana.top_coll,
        "roofline": roof.summary(),
    }
    if verbose:
        ma = out["memory_analysis"]
        print(
            f"[{mesh_name}] {arch.name} x {shape.name}: trace {t_trace:.0f}s | "
            f"args {ma['argument_bytes'] / 2**30:.2f} GiB temp "
            f"{ma['bytes_per_device'] / 2**30:.2f} GiB peak {ma['peak_bytes'] / 2**30:.2f} "
            f"GiB /dev | flops/chip {ana.flops_per_chip:.3e} useful "
            f"{roof.useful_flop_ratio:.2f} | coll "
            f"{ana.collective_bytes_per_chip / 2**30:.3f} GiB/dev | t(c/m/n) "
            f"{roof.t_compute * 1e3:.1f}/{roof.t_memory * 1e3:.1f}/"
            f"{roof.t_collective * 1e3:.1f} ms | bottleneck {roof.bottleneck} "
            f"roofline {roof.roofline_fraction * 100:.1f}%", flush=True)
    if save:
        os.makedirs(OUT_DIR, exist_ok=True)
        path = os.path.join(OUT_DIR, f"{arch.name}__{shape.name}__{mesh_name}.json")
        with open(path, "w") as f:
            json.dump(out, f, indent=2)
    return out


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    args = ap.parse_args(argv)

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    todo = cells() if args.all else [(args.arch, args.shape)]
    failures = []
    for multi_pod in meshes:
        for arch_name, shape_name in todo:
            try:
                run_cell(arch_name, shape_name, multi_pod)
            except Exception as e:  # noqa: BLE001 - report and continue
                failures.append((arch_name, shape_name, multi_pod, repr(e)))
                print(f"FAIL {arch_name} x {shape_name} multi_pod={multi_pod}: {e}")
                traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print("\nALL DRY-RUN CELLS PASSED")


if __name__ == "__main__":
    main()
