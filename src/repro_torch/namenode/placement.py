"""Block/shard placement policies for the metadata plane.

`MetadataService` used to carry a private round-robin cursor with a
latent bias: the cursor advanced by the number of *candidates scanned*
rather than to the last node actually chosen, so whenever a node was
down every placement restarted its scan from a skewed offset and the
node *after* a failed one soaked up its traffic.  These classes replace
that cursor with a pluggable interface the NameNode (and any other
allocator) shares:

  RoundRobinPlacement    bias-fixed baseline — each live node takes the
                         lead slot in turn, failed nodes are skipped
                         without skewing their successors.
  FailureDomainPlacement rack-aware: no two shards of one stripe land
                         in the same failure domain whenever enough
                         live domains exist, else the overflow spreads
                         evenly (cap grows one shard per domain at a
                         time).
  LoadBalancedPlacement  greedy least-loaded on per-node byte counters
                         (fed by ``record``); keeps the spread across
                         live nodes bounded by the largest single
                         extent.

``place`` never returns an excluded node and raises ``RuntimeError``
when fewer live nodes than requested shards exist — the same contract
(and exception) callers of the old ``_place`` relied on.
"""

from __future__ import annotations

from collections.abc import Iterable

__all__ = [
    "PlacementPolicy",
    "RoundRobinPlacement",
    "FailureDomainPlacement",
    "LoadBalancedPlacement",
]


class PlacementPolicy:
    """Choose ``n`` distinct storage nodes for one stripe/block.

    Subclasses implement :meth:`place`; :meth:`record` feeds per-node
    byte counters (used by the load-balanced policy, free for the rest
    to ignore — every policy tracks them so policies can be swapped
    mid-run without losing the ledger)."""

    def __init__(self, num_nodes: int):
        if num_nodes <= 0:
            raise ValueError(f"num_nodes must be positive, got {num_nodes}")
        self.num_nodes = num_nodes
        #: cumulative bytes placed per node (``record``)
        self.loads = [0] * num_nodes

    def place(self, n: int, exclude: Iterable[int] = ()) -> list[int]:
        raise NotImplementedError

    def record(self, node: int, nbytes: int) -> None:
        """Account ``nbytes`` landing on ``node`` (extent allocated)."""
        self.loads[node] += nbytes

    def _live(self, n: int, exclude: Iterable[int]) -> tuple[list[int], set[int]]:
        """Common guard: the live node list (ascending) or RuntimeError."""
        dead = set(exclude)
        live = [v for v in range(self.num_nodes) if v not in dead]
        if len(live) < n:
            raise RuntimeError(
                f"cannot place {n} shards: only {len(live)} live nodes"
            )
        return live, dead


class RoundRobinPlacement(PlacementPolicy):
    """Ring placement with the cursor bias fixed.

    The cursor advances to just past the *first node chosen* (not by
    the number of candidates scanned), so every live node takes the
    lead slot exactly once per cycle regardless of which nodes are
    excluded — under one failed node of N the survivors each receive
    1/(N-1) of placements instead of the old skew onto the failed
    node's successor."""

    def __init__(self, num_nodes: int):
        super().__init__(num_nodes)
        self._cursor = 0

    def place(self, n: int, exclude: Iterable[int] = ()) -> list[int]:
        _, dead = self._live(n, exclude)
        ring = (
            (self._cursor + i) % self.num_nodes for i in range(self.num_nodes)
        )
        chosen = [v for v in ring if v not in dead][:n]
        self._cursor = (chosen[0] + 1) % self.num_nodes
        return chosen


class FailureDomainPlacement(PlacementPolicy):
    """Rack/failure-domain-aware placement.

    ``domain_of`` maps node id → domain id (e.g. rack number).  Shards
    of one stripe go to distinct domains whenever at least ``n`` live
    domains exist; with fewer domains the per-domain cap rises one
    shard at a time, so the stripe loses at most ``ceil(n/domains)``
    shards to any single domain failure.  Domains rotate through the
    lead slot (and nodes rotate within their domain) so load spreads
    across placements."""

    def __init__(self, num_nodes: int, domain_of: Iterable[int]):
        super().__init__(num_nodes)
        self.domain_of = list(domain_of)
        if len(self.domain_of) != num_nodes:
            raise ValueError(
                f"domain_of covers {len(self.domain_of)} nodes, "
                f"expected {num_nodes}"
            )
        self._domains = sorted(set(self.domain_of))
        self._start = 0          # rotating lead domain
        self._node_rr = dict.fromkeys(self._domains, 0)  # per-domain cursor

    def domains_live(self, exclude: Iterable[int] = ()) -> int:
        dead = set(exclude)
        return len({
            self.domain_of[v] for v in range(self.num_nodes) if v not in dead
        })

    def place(self, n: int, exclude: Iterable[int] = ()) -> list[int]:
        _, dead = self._live(n, exclude)
        # live nodes grouped by domain, each domain's list rotated by its
        # cursor so repeated placements cycle through the domain's nodes
        by_dom: dict[int, list[int]] = {}
        for v in range(self.num_nodes):
            if v not in dead:
                by_dom.setdefault(self.domain_of[v], []).append(v)
        for dom, nodes in by_dom.items():
            r = self._node_rr[dom] % len(nodes)
            by_dom[dom] = nodes[r:] + nodes[:r]
        doms = [d for d in self._domains if d in by_dom]
        lead = self._start % len(doms)
        order = doms[lead:] + doms[:lead]
        chosen: list[int] = []
        taken = dict.fromkeys(order, 0)
        cap = 1
        while len(chosen) < n:
            for dom in order:
                if len(chosen) >= n:
                    break
                nodes = by_dom[dom]
                if taken[dom] < cap and taken[dom] < len(nodes):
                    chosen.append(nodes[taken[dom]])
                    taken[dom] += 1
            cap += 1  # all domains saturated at the old cap: let it grow
        self._start += 1
        for dom, t in taken.items():
            if t:
                self._node_rr[dom] += 1
        return chosen


class LoadBalancedPlacement(PlacementPolicy):
    """Greedy least-loaded placement on the per-node byte ledger.

    Each stripe takes the ``n`` live nodes with the smallest cumulative
    placed bytes (ties broken by node id, so runs are deterministic).
    Starting from equal loads, the max-min spread across live nodes
    never exceeds the largest single extent — the classic greedy
    balanced-loading bound."""

    def place(self, n: int, exclude: Iterable[int] = ()) -> list[int]:
        live, _ = self._live(n, exclude)
        return sorted(live, key=lambda v: (self.loads[v], v))[:n]
