"""The NameNode facade: namespace + placement + detected liveness + repair.

One object ties the metadata plane together the way HDFS's NameNode
does, out of parts this repo already has:

  - :class:`~repro_torch.namenode.Namespace` owns paths and extent maps;
  - a :class:`~repro_torch.namenode.PlacementPolicy` (shared with the
    cluster's ``MetadataService``) decides where new blocks land;
  - datanode liveness comes from ``repro_torch.membership`` — datanodes
    heartbeat (:meth:`heartbeat`), :meth:`tick` polls the lease-gated
    :class:`~repro_torch.membership.ViewManager`, and a *detected* view
    change (never an omniscient ``crash()``) marks the removed node's
    blocks under-replicated;
  - the :class:`~repro_torch.namenode.BlockReplicator` re-replicates them
    through the existing :class:`repro_torch.control.RepairPacer` token
    bucket, copying bytes via ``StorageCluster.re_replicate``.

The facade also keeps per-op RPC counters (``lookups`` / ``opens`` /
``commits``) — the functional twin of the timed-plane metadata
policies (``PolicySpec(op="lookup" | "open" | "commit")``), which cost
those same RPCs in nanoseconds on a NIC handler or a host CPU.
"""

from __future__ import annotations

from repro_torch.membership.detector import MembershipConfig
from repro_torch.membership.view import View, ViewManager

from .namespace import Block, FileNode, Namespace
from .placement import PlacementPolicy
from .replicator import BlockReplicator

__all__ = ["NameNode"]


class NameNode:
    """Metadata server for one cluster of datanodes.

    ``cluster`` is a :class:`repro_torch.checkpoint.StorageCluster` (or None
    for bookkeeping-only runs — e.g. placement-policy property tests);
    when present the NameNode shares the cluster's placement policy,
    routes block writes through it, and injects
    ``cluster.re_replicate`` as the replicator's copier.  ``datanodes``
    defaults to the cluster's node ids; ``cfg`` configures the failure
    detector (heartbeat interval, phi-thresholds, lease span)."""

    def __init__(self, cluster=None, placement: PlacementPolicy | None = None,
                 datanodes=None, cfg: MembershipConfig | None = None,
                 pacer=None, now: float = 0.0):
        if cluster is None and placement is None:
            raise ValueError("need a cluster or an explicit placement policy")
        self.cluster = cluster
        self.placement = placement or cluster.meta.placement
        if cluster is not None and placement is not None:
            # one ledger: the cluster's allocator must feed the same
            # policy the NameNode places with
            cluster.meta.placement = placement
        if datanodes is None:
            if cluster is None:
                raise ValueError("need datanodes when running clusterless")
            datanodes = range(cluster.num_nodes)
        self.namespace = Namespace()
        self.views = ViewManager(datanodes, cfg or MembershipConfig(),
                                 now=now)
        self.views.on_change.append(self._on_view_change)
        copier = self._copy_block if cluster is not None else None
        self.replicator = BlockReplicator(self.namespace, self.placement,
                                          copier=copier, pacer=pacer)
        self._layouts: dict[int, object] = {}   # object_id -> ObjectLayout
        # RPC ledger (the timed plane costs these same three ops)
        self.lookups = 0
        self.opens = 0
        self.commits = 0

    # -- metadata RPCs -------------------------------------------------------

    def lookup(self, path: str):
        self.lookups += 1
        return self.namespace.lookup(path)

    def listdir(self, path: str) -> list[str]:
        self.lookups += 1
        return self.namespace.listdir(path)

    def mkdir(self, path: str):
        self.opens += 1
        return self.namespace.mkdir(path)

    def create(self, path: str, replication: int = 3) -> FileNode:
        self.opens += 1
        return self.namespace.create(path, replication)

    def add_block(self, path: str, data: bytes) -> Block:
        """Append ``data`` as one replicated block of ``path``: place it
        via the policy, write the replicas through the cluster's policy
        engine, commit the extent-map entry (one open + one commit on
        the RPC ledger — the lookup already happened at ``create``)."""
        from repro_torch.core.packets import Resiliency

        f = self.namespace.lookup(path)
        if not isinstance(f, FileNode):
            raise IsADirectoryError(path)
        if self.cluster is None:
            raise RuntimeError("clusterless NameNode cannot store bytes")
        layout = self.cluster.write_object(
            data, resiliency=Resiliency.REPLICATION, k=f.replication
        )
        self.commits += 1
        blk = self.namespace.commit_block(
            f, layout.size, [c.node for c in layout.data_coords],
            object_id=layout.object_id,
        )
        self._layouts[layout.object_id] = layout
        return blk

    def read_block(self, block: Block) -> bytes:
        self.lookups += 1
        return self.cluster.read_object(self._layouts[block.object_id])

    # -- liveness (detected, never omniscient) -------------------------------

    def heartbeat(self, node: int, now: float) -> View:
        """One datanode heartbeat; a crashed node simply stops calling."""
        return self.views.record_heartbeat(node, now)

    def tick(self, now: float) -> View | None:
        """Advance detection; a newly activated view (if any) has
        already had its removals queued for re-replication."""
        return self.views.poll(now)

    def _on_view_change(self, view: View) -> None:
        dead = self.views.removed - self.replicator.dead
        if self.cluster is not None:
            # steer future placements away from *detected*-dead nodes
            # without touching the injector's omniscient ``failed`` set
            self.cluster.meta.suspected |= dead
        self.replicator.mark_dead(dead)

    def under_replicated(self) -> int:
        return self.replicator.pending()

    def re_replicate(self) -> dict:
        """Drain the under-replicated queue (paced by the injected
        :class:`~repro_torch.control.RepairPacer`, if any)."""
        return self.replicator.run()

    def _copy_block(self, block: Block, src: int, dst: int) -> None:
        self.cluster.re_replicate(self._layouts[block.object_id], src, dst)

    # -- introspection -------------------------------------------------------

    def rpc_counts(self) -> dict:
        return {"lookups": self.lookups, "opens": self.opens,
                "commits": self.commits}
