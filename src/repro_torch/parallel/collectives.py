"""Chunk-pipelined collectives: the paper's per-packet ring, as training
-plane primitives.

The paper's central mechanism — forward each *packet* along a ring/tree
instead of store-and-forwarding whole messages — is exactly the bandwidth-
optimal formulation of the classic collectives.  This module provides
ring implementations on ``torch.distributed`` point-to-point:

  * ring_all_gather      (k-1 rounds of one shard-chunk each)
  * ring_reduce_scatter  (k-1 rounds, add-as-you-forward)
  * ring_all_reduce      (reduce-scatter + all-gather, 2(k-1) rounds)

Every rank of a process group calls them with its local tensor.  Each
round's send and receive are posted together (:func:`p2p_round`, over
``batch_isend_irecv``): blocking sends around a ring would deadlock.  There
is no default device: the tensors' device and the group's backend decide
where a collective runs (gloo on CPU tensors, NCCL on CUDA tensors, one
card per rank).  Sums are taken in the reference's order, so float results
equal its ``shard_map`` bodies bit for bit.
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist


def _global_rank(peer: int, group: dist.ProcessGroup | None) -> int:
    return peer if group is None else dist.get_global_rank(group, peer)


def p2p_round(
    sends: list[tuple[torch.Tensor, int]],
    recvs: list[tuple[torch.Tensor, int]],
    group: dist.ProcessGroup | None = None,
) -> None:
    """One round of point-to-point transfers: send each (tensor, peer) and
    receive into each (tensor, peer), peers as ranks of ``group``, all
    posted at once; returns when every transfer is done."""
    ops = [dist.P2POp(dist.isend, t.contiguous(), _global_rank(peer, group), group)
           for t, peer in sends]
    ops += [dist.P2POp(dist.irecv, t, _global_rank(peer, group), group) for t, peer in recvs]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


def ring_all_gather(x: torch.Tensor, group: dist.ProcessGroup | None = None) -> torch.Tensor:
    """All-gather via k-1 pipelined ring hops (bandwidth-optimal: each rank
    sends each of its bytes exactly k-1 times over one link).

    x: local shard (s0, ...) -> (n * s0, ...) identical everywhere, ordered
    by source rank.
    """
    n = dist.get_world_size(group)
    idx = dist.get_rank(group)
    out = x.new_zeros((n,) + x.shape)
    out[idx] = x
    for r in range(n - 1):
        # after r hops we hold the shard of rank (idx - r) mod n; pass it on
        # and take the shard of rank (idx - r - 1) mod n
        p2p_round([(out[(idx - r) % n], (idx + 1) % n)],
                  [(out[(idx - r - 1) % n], (idx - 1) % n)], group)
    return out.reshape((n * x.shape[0],) + x.shape[1:])


def ring_reduce_scatter(
    x: torch.Tensor, group: dist.ProcessGroup | None = None
) -> torch.Tensor:
    """Reduce-scatter (sum) via the add-as-you-forward ring.

    x: full local array (n*s0, ...) -> this rank's reduced shard (s0, ...).
    The partial for shard s starts at rank s+1 (its local contribution) and
    travels the ring adding each rank's contribution; after n-1 hops it
    lands, complete, on rank s.
    """
    n = dist.get_world_size(group)
    idx = dist.get_rank(group)
    s0 = x.shape[0] // n
    shards = x.reshape((n, s0) + x.shape[1:])
    acc = shards[(idx + n - 1) % n].clone()
    for r in range(n - 1):
        recv = torch.empty_like(acc)
        p2p_round([(acc, (idx + 1) % n)], [(recv, (idx - 1) % n)], group)
        # after hop r+1 we hold the partial of shard (idx + n - 2 - r): add
        # our local contribution and keep forwarding
        acc = recv + shards[(idx + n - 2 - r) % n]
    return acc


def ring_all_reduce(x: torch.Tensor, group: dist.ProcessGroup | None = None) -> torch.Tensor:
    """Sum all-reduce = reduce-scatter + all-gather (2(k-1) chunk rounds).

    Requires x.shape[0] % group size == 0.
    """
    return ring_all_gather(ring_reduce_scatter(x, group), group)


def make_ring_collective(fn, group: dist.ProcessGroup | None = None):
    """One of the ring collectives with its process group bound."""
    return functools.partial(fn, group=group)
