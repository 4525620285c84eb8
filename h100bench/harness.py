"""What every cell of the benchmark shares: the checkout's paths and cache
directories, the spec, the configuration, mix and metric files found by name,
the seeded inputs, the launch of a cell's ranks on several cards, the
forbidden-module check and the result line.

Nothing here imports the program at module level; ``port_path()`` puts the
checkout's ``src`` on ``sys.path`` when a cell first needs it.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
for _where in (HERE, HERE / "reference"):
    if str(_where) not in sys.path:
        sys.path.insert(0, str(_where))

# the cells reach the profiler's reduction and the yardstick as harness.tracing and harness.work
import tracing  # noqa: E402,F401
import work  # noqa: E402,F401

ROOT = HERE.parent
SPEC = ROOT / "BENCHMARK.json"
#: build and kernel caches at fixed paths inside the checkout
CACHE = ROOT / "build" / "h100bench"
#: modules the benchmark's process may not hold once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def set_environment() -> None:
    """Fixed cache directories inside the checkout, and no JAX pulled in by
    a library; called before torch is imported."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def port_path() -> None:
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def log(*args) -> None:
    print("h100bench:", *args, file=sys.stderr, flush=True)


# -- the spec and the files found by name ---------------------------------------


def load_spec(path: Path = SPEC) -> dict:
    return json.loads(path.read_text())


def cell_of(spec: dict, name: str) -> dict:
    for cell in spec["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in {SPEC.name}")


def config_of(spec: dict, name: str) -> dict:
    for entry in spec["configs"]:
        if entry["name"] == name:
            return json.loads((ROOT / entry["file"]).read_text())
    raise KeyError(f"no config {name!r}")


def mix_of(name: str) -> dict:
    """A traffic mix: ``mixes/<name>.json``, whose ``kind`` names the
    generator under ``traffic/``."""
    return json.loads((HERE / "mixes" / f"{name}.json").read_text())


def load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def kind_of(mix: dict):
    return load_file(HERE / "traffic" / f"{mix['kind']}.py", f"h100bench_traffic_{mix['kind']}")


def reader_of(metric: str):
    """The reader of a per-layer metric: ``metrics/<name>.py``'s ``read``."""
    return load_file(HERE / "metrics" / f"{metric}.py",
                     "h100bench_metric_" + metric.replace(".", "_")).read


def cell_metrics(spec: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a cell reports: its end-to-end ones, or with ``trace``
    its per-layer ones."""
    out = []
    for metric in spec["per_layer" if trace else "end_to_end"]:
        if cell in metric.get("workloads", [cell]):
            out.append(metric)
    return out


# -- seeded inputs ----------------------------------------------------------------


def leaf_seed(seed: int, index: int) -> int:
    """The seed of one input tensor: a 63-bit mix of the run's seed and the
    tensor's index, so that one tensor can be made again on its own."""
    x = (seed * 0x9E3779B97F4A7C15 + index * 0xBF58476D1CE4E5B9 + 1) % (1 << 64)
    x ^= x >> 31
    return x % (1 << 63)


def init_scale(path: str, shape: tuple) -> float | None:
    """The scale of a seeded weight, as the architectures' inits draw them:
    ``None`` for a norm's scale (ones), 0.02 for the embedding table,
    1/sqrt(fan-in) for every other matrix (``(d_in, d_out)``)."""
    last = path.rsplit("/", 1)[-1]
    if last == "scale":
        return None
    if last == "table":
        return 0.02
    return 1.0 / math.sqrt(shape[-2])


def seeded_leaf(seed: int, index: int, path: str, shape: tuple, device, dtype=None):
    """One weight tensor made on ``device`` from the seed, in fp32 (or
    ``dtype``): ones for a norm scale, else a seeded normal times
    :func:`init_scale`."""
    import torch

    scale = init_scale(path, shape)
    if scale is None:
        return torch.ones(shape, dtype=dtype or torch.float32, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(leaf_seed(seed, index))
    out = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    out.mul_(scale)
    return out if dtype is None else out.to(dtype)


def tree_paths(tree, prefix: str = "") -> list[tuple[str, object]]:
    """(path, leaf) of a nest of dicts and lists, dicts in sorted key order
    (the order of the port's ``tree_leaves``)."""
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out += tree_paths(tree[key], f"{prefix}{key}/")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, value in enumerate(tree):
            out += tree_paths(value, f"{prefix}{i}/")
        return out
    return [(prefix.rstrip("/"), tree)]


def build_tree(struct, fill):
    """``struct``'s nest with each leaf replaced by ``fill(index, path, leaf)``."""
    counter = iter(range(1 << 30))

    def walk(node, prefix):
        if isinstance(node, dict):
            return {key: walk(node[key], f"{prefix}{key}/") for key in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, f"{prefix}{i}/") for i, v in enumerate(node))
        return fill(next(counter), prefix.rstrip("/"), node)

    return walk(struct, "")


# -- a cell on several cards --------------------------------------------------------


def launch(target, payload: dict, chips: int) -> dict:
    """``target(rank, payload)`` on ``chips`` processes, one card each, in a
    NCCL (or, with ``device_type`` "cpu", gloo) world on a free local port;
    returns what rank 0 wrote to ``payload["out"]``."""
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    fd, out = tempfile.mkstemp(prefix="h100bench-", suffix=".json")
    os.close(fd)
    try:
        mp.spawn(target, args=({**payload, "port": port, "out": out},), nprocs=chips, join=True)
        text = Path(out).read_text()
        return json.loads(text) if text else {}
    finally:
        os.unlink(out)


def join_world(payload: dict, rank: int):
    """This process's card and its place in the world."""
    import datetime

    import torch
    import torch.distributed as dist

    init = f"tcp://127.0.0.1:{payload['port']}"
    if payload.get("device_type", "cuda") == "cuda":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", init_method=init, world_size=payload["chips"],
                                rank=rank, device_id=dev, timeout=datetime.timedelta(seconds=300))
    else:
        dev = torch.device("cpu")
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=init, world_size=payload["chips"], rank=rank)
    return dev


# -- checks and the result line ------------------------------------------------------


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is a forbidden one, compared whole."""
    return sorted({name for name in list(sys.modules) if name.split(".")[0] in FORBIDDEN})


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each compared number beside its limit; correct when every number is
    finite and at most its limit."""
    compared = {}
    ok = True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = value is not None and math.isfinite(value) and value <= limit
        ok = ok and good
        compared[name] = {"value": value, "limit": limit}
    return ok, compared


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                compared: dict, breakdown: dict | None = None) -> str:
    """The contract's object; the numbers compared, beside their limits, last."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["compared"] = compared
    return json.dumps(out)


def card_info(count: int) -> dict:
    """The result's ``device``: the card's name, or "cpu" where a test drives
    a cell without one."""
    import torch

    if not torch.cuda.is_available():
        return {"platform": "cpu", "kind": "cpu", "count": count}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count}


def power_line() -> str:
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=20).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi: {exc}"
