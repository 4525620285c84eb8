#!/usr/bin/env python3
"""The port's broadcasts and ring collectives on NCCL, one rank a card.

    python3 tools/collectives_on_cards.py [--out-dir chiprun_out/collectives]

Needs two cards or more and uses all of them.  First runs
``tests/_torch_collectives_worker.py`` twice with one rank a card, once on
gloo with CPU tensors and once on NCCL with CUDA tensors, and holds every
output of every rank on NCCL against gloo's bit for bit (the CPU tests
hold gloo's against the reference's ``shard_map`` bodies).  Then times,
on NCCL at ``SIZE_BYTES`` of fp32 a rank, ``ring_all_reduce`` against
``dist.all_reduce`` and ``ring_broadcast`` / ``pbt_broadcast`` against
``dist.broadcast`` (the library calls, timed here and used nowhere in the
port), after checking that each ring result equals the library's (integer
values, so every order of sums is exact): the median over ``RUNS``
CUDA-event-timed calls on rank 0, each between two barriers.  Prints the
card's name and power limit and, last, one JSON object.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from chip_smoke import card_line  # noqa: E402

SIZE_BYTES = 256 << 20
RUNS = 5
BROADCAST_CHUNKS = 64


def run_worker(out_dir: Path, world: int, backend: str) -> None:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, str(ROOT / "tests" / "_torch_collectives_worker.py"),
                    str(out_dir), "--world", str(world), "--backend", backend],
                   env=env, check=True, timeout=600)


def compare(gloo: Path, nccl: Path, world: int) -> dict[str, bool]:
    """Each output key: whether every rank's NCCL output equals gloo's bit for bit."""
    equal: dict[str, bool] = {}
    for rank in range(world):
        with np.load(gloo / f"rank{rank}.npz") as a, np.load(nccl / f"rank{rank}.npz") as b:
            if sorted(a.files) != sorted(b.files):
                raise AssertionError(f"rank {rank}: outputs {sorted(a.files)} != {sorted(b.files)}")
            for key in a.files:
                same = a[key].dtype == b[key].dtype and a[key].shape == b[key].shape and \
                    np.array_equal(a[key].view(np.uint8), b[key].view(np.uint8))
                equal[key] = equal.get(key, True) and bool(same)
    return equal


def time_collectives(rank: int, world: int, port: int, out_path: str) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.core.replication import pbt_broadcast, ring_broadcast
    from repro_torch.parallel.collectives import ring_all_reduce

    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=120), device_id=dev)
    n = SIZE_BYTES // 4
    n -= n % (world * BROADCAST_CHUNKS)
    gen = torch.Generator(device=dev)
    gen.manual_seed(rank)
    x = torch.randint(-64, 64, (n,), generator=gen, device=dev).float()

    def library_all_reduce():
        y = x.clone()
        dist.all_reduce(y)
        return y

    def library_broadcast():
        y = x.clone()
        dist.broadcast(y, 0)
        return y

    cases = {
        "ring_all_reduce": (lambda: ring_all_reduce(x), library_all_reduce),
        "ring_broadcast": (lambda: ring_broadcast(x, BROADCAST_CHUNKS), library_broadcast),
        "pbt_broadcast": (lambda: pbt_broadcast(x, BROADCAST_CHUNKS), library_broadcast),
    }

    def median_ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(RUNS):
            dist.barrier()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        dist.barrier()
        return statistics.median(times)

    res = {"bytes_per_rank": n * 4, "world": world, "broadcast_chunks": BROADCAST_CHUNKS}
    for name, (ring, library) in cases.items():
        same = torch.equal(ring(), library())
        flag = torch.tensor([int(same)], device=dev)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN)
        if not bool(flag.item()):
            raise AssertionError(f"{name} differs from the library call on some rank")
        res[name] = {"ms": median_ms(ring), "library_ms": median_ms(library)}
        res[name]["gb_per_s"] = n * 4 / res[name]["ms"] / 1e6
    if rank == 0:
        Path(out_path).write_text(json.dumps(res))
    dist.barrier()
    dist.destroy_process_group()


def main() -> int:
    import torch
    import torch.multiprocessing as mp

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out-dir", default=str(ROOT / "chiprun_out" / "collectives"))
    args = parser.parse_args()
    world = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if world < 2:
        print(f"collectives_on_cards: needs two CUDA devices or more, found {world}",
              file=sys.stderr)
        return 1
    out_dir = Path(args.out_dir)
    card = card_line()
    print(f"card: {card} (x{world})", flush=True)
    run_worker(out_dir / "gloo", world, "gloo")
    run_worker(out_dir / "nccl", world, "nccl")
    equal = compare(out_dir / "gloo", out_dir / "nccl", world)
    print(f"  {world} ranks, NCCL against gloo bit for bit: {equal}", flush=True)
    if not all(equal.values()):
        raise AssertionError(f"NCCL outputs differ from gloo's: {equal}")
    timing = out_dir / "timing.json"
    mp.spawn(time_collectives, args=(world, free_port(), str(timing)), nprocs=world, join=True)
    times = json.loads(timing.read_text())
    for name in ("ring_all_reduce", "ring_broadcast", "pbt_broadcast"):
        t = times[name]
        print(f"  {name} of {times['bytes_per_rank']} B a rank: {t['ms']:.3f} ms "
              f"({t['gb_per_s']:.1f} GB/s of payload), library {t['library_ms']:.3f} ms",
              flush=True)
    print(card)
    print(json.dumps({"world": world, "equal_to_gloo": equal, "timing": times}))
    return 0


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


if __name__ == "__main__":
    sys.exit(main())
