"""Data replication policy: ring / pipelined-binary-tree broadcast.

Paper section V: replication on ``k`` storage nodes is a broadcast along a
client-chosen virtual topology (ring or pipelined binary tree, "PBT"),
source-routed via replica coordinates in the write-request header, and —
this is the contribution — *pipelined at packet granularity* by the NIC
handlers: each node forwards every packet to its children as it arrives,
so the broadcast costs (depth + n_packets - 1) packet times instead of
depth * message time.

:class:`BroadcastPlan` is the host-side planner shared with the functional
DFS node and the simulator.  :func:`ring_broadcast`, :func:`pbt_broadcast`
and :func:`replicate` run the schedules on ``torch.distributed``
point-to-point: every rank of a process group calls them with its local
shard, and rank 0's chunks flow down the ring or the binary tree in
``num_chunks + depth - 1`` rounds, each round's sends and receives posted
together (``batch_isend_irecv``), so no rank blocks on a neighbour that is
itself sending.  There is no default device: the tensors' device and the
group's backend decide where the broadcast runs (gloo on CPU tensors,
NCCL on CUDA tensors, one card per rank).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from repro_torch.core.packets import ReplStrategy
from repro_torch.parallel.collectives import p2p_round

# ---------------------------------------------------------------------------
# Host-side schedule planner (shared by handlers.py and sim/).
# ---------------------------------------------------------------------------


def children_of(rank: int, k: int, strategy: ReplStrategy) -> list[int]:
    """Children of virtual rank ``rank`` in a broadcast over ranks [0, k)."""
    if strategy == ReplStrategy.RING:
        return [rank + 1] if rank + 1 < k else []
    if strategy == ReplStrategy.PBT:
        return [c for c in (2 * rank + 1, 2 * rank + 2) if c < k]
    raise ValueError(f"unknown strategy {strategy}")


def depth_of(rank: int, strategy: ReplStrategy) -> int:
    if strategy == ReplStrategy.RING:
        return rank
    return int(math.floor(math.log2(rank + 1))) if rank > 0 else 0


def tree_depth(k: int, strategy: ReplStrategy) -> int:
    return max(depth_of(r, strategy) for r in range(k))


@dataclasses.dataclass(frozen=True)
class BroadcastPlan:
    """Broadcast schedule over ``k`` replicas with ``num_chunks`` chunks."""

    strategy: ReplStrategy
    k: int
    num_chunks: int

    @property
    def arity(self) -> int:
        return 1 if self.strategy == ReplStrategy.RING else 2

    @property
    def depth(self) -> int:
        return tree_depth(self.k, self.strategy)

    @property
    def num_rounds(self) -> int:
        """Rounds until the deepest node holds the last chunk."""
        return self.num_chunks + self.depth - 1 if self.k > 1 else 0

    def children(self, rank: int) -> list[int]:
        return children_of(rank, self.k, self.strategy)

    def logg_p_latency(
        self,
        chunk_bytes: int,
        bandwidth_Bps: float,
        overhead_s: float,
        hop_latency_s: float,
    ) -> float:
        """LogGP-style pipelined broadcast latency estimate (paper refs
        [33], [34]).  Per round a node serializes ``arity`` copies of one
        chunk; the pipeline drains after ``num_rounds`` rounds.
        """
        if self.k <= 1:
            return 0.0
        per_round = self.arity * chunk_bytes / bandwidth_Bps + overhead_s
        return self.num_rounds * per_round + self.depth * hop_latency_s


def optimal_chunk_count(
    size_bytes: int,
    k: int,
    strategy: ReplStrategy,
    bandwidth_Bps: float,
    overhead_s: float,
    max_chunks: int = 4096,
) -> int:
    """Minimize LogGP latency over the chunk count (closed form + clamp).

    d(latency)/dC = 0 at C* = sqrt(depth * S/B / overhead) for arity a:
    latency(C) = (C + d - 1)(a*S/(C*B) + o).
    """
    depth = tree_depth(k, strategy)
    if depth == 0 or size_bytes == 0:
        return 1
    a = 1 if strategy == ReplStrategy.RING else 2
    ser = a * size_bytes / bandwidth_Bps
    c_star = math.sqrt(max(depth - 1, 1) * ser / max(overhead_s, 1e-12))
    return max(1, min(max_chunks, int(round(c_star)), size_bytes))


# ---------------------------------------------------------------------------
# Device data plane: chunk-pipelined broadcasts on torch.distributed.
# ---------------------------------------------------------------------------


def _parent(rank: int, strategy: ReplStrategy) -> int:
    return rank - 1 if strategy == ReplStrategy.RING else (rank - 1) // 2


def _pipelined_broadcast(
    x: torch.Tensor,
    num_chunks: int,
    strategy: ReplStrategy,
    group: dist.ProcessGroup | None = None,
) -> torch.Tensor:
    """Shared body: pipelined broadcast from rank 0 of ``group``.

    ``x`` is the (identically-shaped) local tensor on every rank; only rank
    0's content is broadcast.  Its elements must divide into
    ``num_chunks``.  Runs ``num_chunks + depth - 1`` rounds: a rank at depth
    d receives chunk ``r - d + 1`` from its parent in round r and forwards
    it to each of its children in round r + 1 (PBT sends every chunk twice,
    its arity-2 bandwidth cost).
    """
    n = dist.get_world_size(group)
    idx = dist.get_rank(group)
    c = num_chunks
    flat = x.detach().reshape(c, -1)
    buf = flat.clone() if idx == 0 else torch.zeros_like(flat)
    depth_me = depth_of(idx, strategy)
    children = children_of(idx, n, strategy)
    for r in range(BroadcastPlan(strategy, n, c).num_rounds):
        send_idx = r - depth_me          # the chunk received last round
        recv_idx = r - depth_me + 1
        sends = ([(buf[send_idx], child) for child in children]
                 if 0 <= send_idx < c else [])
        recvs = ([(buf[recv_idx], _parent(idx, strategy))]
                 if idx != 0 and 0 <= recv_idx < c else [])
        p2p_round(sends, recvs, group)
    return buf.reshape(x.shape)


def ring_broadcast(
    x: torch.Tensor, num_chunks: int, group: dist.ProcessGroup | None = None
) -> torch.Tensor:
    """Chunk-pipelined ring broadcast from rank 0 (sPIN-Ring analogue)."""
    return _pipelined_broadcast(x, num_chunks, ReplStrategy.RING, group)


def pbt_broadcast(
    x: torch.Tensor, num_chunks: int, group: dist.ProcessGroup | None = None
) -> torch.Tensor:
    """Chunk-pipelined binary-tree broadcast from rank 0 (sPIN-PBT)."""
    return _pipelined_broadcast(x, num_chunks, ReplStrategy.PBT, group)


def replicate(
    x: torch.Tensor,
    group: dist.ProcessGroup | None = None,
    strategy: ReplStrategy = ReplStrategy.RING,
    num_chunks: int = 8,
) -> torch.Tensor:
    """Public entry: every rank of ``group`` passes its shard ``x`` and gets
    rank 0's back (k-way replication of a state shard across peers)."""
    return _pipelined_broadcast(x, num_chunks, strategy, group)
