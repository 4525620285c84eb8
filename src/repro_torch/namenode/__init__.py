"""Metadata plane: namespace, placement policies, detected re-replication.

The NameNode subsystem (ROADMAP item 1): a directory tree + per-file
extent map (:class:`Namespace`), pluggable block placement
(:class:`PlacementPolicy` and friends — also consulted by
``StorageCluster`` instead of its old private round-robin cursor),
datanode liveness consumed from ``repro_torch.membership``'s lease-gated
views, and a :class:`BlockReplicator` that brings under-replicated
blocks back to target through the ``RepairPacer`` token bucket.  The
:class:`NameNode` facade ties them together.

The *cost* of the metadata RPCs lives in the timed plane:
``PolicySpec(op="lookup" | "open" | "commit")`` compiles to a NIC
handler stage (``HANDLER_NS["ns_*"]``) or a host-CPU RPC detour — see
``repro_torch.policy`` and ``benchmarks/namespace.py``.
"""

from .namespace import Block, DirNode, FileNode, Namespace
from .namenode import NameNode
from .placement import (
    FailureDomainPlacement,
    LoadBalancedPlacement,
    PlacementPolicy,
    RoundRobinPlacement,
)
from .replicator import BlockReplicator

__all__ = [
    "Block",
    "BlockReplicator",
    "DirNode",
    "FailureDomainPlacement",
    "FileNode",
    "LoadBalancedPlacement",
    "NameNode",
    "Namespace",
    "PlacementPolicy",
    "RoundRobinPlacement",
]
