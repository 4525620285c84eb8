"""Background re-replication of under-replicated blocks.

A detected view change (``repro_torch.membership``) removes datanodes; every
block with a replica on a removed node drops below its file's target
replication and lands in this queue.  :meth:`BlockReplicator.run`
drains it: pick a new home via the placement policy (never a node that
already holds a replica, never a dead node), pace the copy through the
existing :class:`repro_torch.control.RepairPacer` token bucket (foreground
traffic keeps its SLO — same machinery as PR 5's paced rebuild), copy
the bytes via the injected ``copier``, and repoint the block's extent
map entry with a fresh generation stamp.

The replicator is plane-agnostic: ``copier(block, dead_node, new_node)``
is whatever moves the dead node's replica onto the new one (reading
from a survivor) — the NameNode facade injects
``StorageCluster.re_replicate``; tests can inject a recorder.
"""

from __future__ import annotations

from collections import deque

from .namespace import Block, FileNode, Namespace
from .placement import PlacementPolicy

__all__ = ["BlockReplicator"]


class BlockReplicator:
    """Queue + drain loop for blocks below target replication."""

    def __init__(self, namespace: Namespace, placement: PlacementPolicy,
                 copier=None, pacer=None):
        self.namespace = namespace
        self.placement = placement
        self.copier = copier
        self.pacer = pacer
        self.dead: set[int] = set()
        self._queue: deque[tuple[FileNode, Block]] = deque()
        self._queued: set[int] = set()      # block ids in the queue
        # ledger
        self.replicated_blocks = 0
        self.replicated_bytes = 0
        self.unrecoverable = 0              # no live replica left to copy from

    def pending(self) -> int:
        return len(self._queue)

    def mark_dead(self, nodes) -> int:
        """A view change removed ``nodes``: scan the extent maps and
        queue every block that lost a replica.  Returns the number of
        newly queued blocks."""
        self.dead.update(nodes)
        added = 0
        for f, b in self.namespace.blocks():
            if b.block_id in self._queued:
                continue
            if any(v in self.dead for v in b.placements):
                self._queue.append((f, b))
                self._queued.add(b.block_id)
                added += 1
        return added

    def run(self, exclude=()) -> dict:
        """Drain the queue: re-replicate every queued block whose
        placement set intersects the dead set.  ``exclude`` adds extra
        no-placement nodes (e.g. suspects not yet declared dead).
        Returns a stats dict (blocks/bytes copied, paced wait)."""
        stats = {"blocks": 0, "bytes": 0, "paced_wait_s": 0.0,
                 "unrecoverable": 0}
        extra = set(exclude)
        while self._queue:
            f, b = self._queue.popleft()
            self._queued.discard(b.block_id)
            for dead_node in [v for v in b.placements if v in self.dead]:
                survivors = [v for v in b.placements if v not in self.dead]
                if not survivors:
                    stats["unrecoverable"] += 1
                    self.unrecoverable += 1
                    break
                avoid = self.dead | extra | set(b.placements)
                target = self.placement.place(1, exclude=avoid)[0]
                if self.pacer is not None:
                    stats["paced_wait_s"] += self.pacer.throttle(int(b.size))
                if self.copier is not None:
                    # the copier's allocator accounts the target's load
                    # (StorageCluster._extent feeds placement.record);
                    # bookkeeping-only runs account it here instead
                    self.copier(b, dead_node, target)
                else:
                    self.placement.record(target, b.size)
                self.namespace.repoint(b, dead_node, target)
                stats["blocks"] += 1
                stats["bytes"] += b.size
                self.replicated_blocks += 1
                self.replicated_bytes += b.size
        return stats
