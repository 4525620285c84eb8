"""Runs the port's broadcasts and ring collectives in one process group.

    python tests/_torch_collectives_worker.py OUT_DIR [--world 8] [--backend gloo]

``--backend gloo`` keeps the tensors on the CPU; ``--backend nccl`` puts
rank i's on card i (it needs ``--world`` cards).  Each rank writes its
outputs, on the host, to ``OUT_DIR/rank<i>.npz``.  The inputs are those of
``tests/test_multidevice.py``: rank i holds shard i of each array sharded
over ranks, and all of each replicated array.
"""

import argparse
import datetime
import socket
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

#: ranks of the subgroup, as far as the world reaches
SUBGROUP = (1, 3, 6, 7)


def inputs():
    rng = np.random.default_rng(0)
    bcast = rng.standard_normal((8, 4, 32)).astype(np.float32)
    rng = np.random.default_rng(0)
    ring = rng.standard_normal((16, 4)).astype(np.float32)
    sharded = rng.standard_normal((64, 3)).astype(np.float32)
    return bcast, ring, sharded


def subgroup(world: int) -> list[int]:
    return [r for r in SUBGROUP if r < world]


def run(rank: int, world: int, backend: str, port: int, out_dir: str) -> None:
    from repro_torch.core.packets import ReplStrategy
    from repro_torch.core.replication import pbt_broadcast, replicate, ring_broadcast
    from repro_torch.parallel.collectives import (make_ring_collective, ring_all_gather,
                                                  ring_all_reduce, ring_reduce_scatter)

    dev = torch.device("cpu")
    extra = {}
    if backend == "nccl":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
        extra["device_id"] = dev          # every rank builds the communicator at once
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=120), **extra)
    bcast, ring, sharded = (torch.from_numpy(a).to(dev) for a in inputs())
    ring_rows, sharded_rows = ring.shape[0] // world, sharded.shape[0] // world
    out = {}
    mine = bcast[rank:rank + 1]
    for fn in (ring_broadcast, pbt_broadcast):
        for nc in (1, 4, 16):
            out[f"{fn.__name__}_{nc}"] = fn(mine, nc)
    out["replicate"] = replicate(mine, strategy=ReplStrategy.PBT, num_chunks=4)
    out["ring_all_gather"] = make_ring_collective(ring_all_gather)(
        ring[ring_rows * rank:ring_rows * (rank + 1)])
    out["ring_reduce_scatter"] = make_ring_collective(ring_reduce_scatter)(ring)
    out["ring_all_reduce"] = make_ring_collective(ring_all_reduce)(ring)
    out["ring_all_reduce_sharded"] = ring_all_reduce(
        sharded[sharded_rows * rank:sharded_rows * (rank + 1)])
    # a subgroup whose ranks are not the world's: peers map to global ranks
    members = subgroup(world)
    group = dist.new_group(members)
    if rank in members:
        small = torch.arange(12, dtype=torch.float32, device=dev).reshape(4, 3) * (rank + 1)
        out["group_pbt_broadcast"] = pbt_broadcast(small, 2, group)
        out["group_ring_all_reduce"] = ring_all_reduce(small, group)
    np.savez(Path(out_dir) / f"rank{rank}.npz", **{k: v.cpu().numpy() for k, v in out.items()})
    dist.barrier()
    dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("out_dir")
    parser.add_argument("--world", type=int, default=8)
    parser.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    args = parser.parse_args()
    torch.set_num_threads(1)
    Path(args.out_dir).mkdir(parents=True, exist_ok=True)
    mp.spawn(run, args=(args.world, args.backend, free_port(), args.out_dir),
             nprocs=args.world, join=True)


if __name__ == "__main__":
    main()
