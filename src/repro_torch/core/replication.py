"""Replication schedule planner (paper section V; see ``repro.core.replication``).

Only the host-side topology helpers are ported so far: the functional
DFS node (:mod:`repro_torch.core.handlers`) forwards each packet to
``children_of`` its virtual rank.  The device broadcasts (pipelined ring
and PBT over a mesh) come with the collectives in a later slice.
"""

from __future__ import annotations

import math

from repro_torch.core.packets import ReplStrategy


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
