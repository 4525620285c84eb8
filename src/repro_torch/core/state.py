"""On-NIC state management: request table, memory budget, Little's law.

Paper section III-B2: each in-flight write needs a 77-byte descriptor
(request status + header-packet info needed by payload handlers, e.g.
replica coordinates).  PsPIN exposes 4 x 1 MiB L1 + 4 MiB L2 = 8 MiB; 2 MiB
are reserved for DFS-wide state (e.g. the 64 KiB GF LUT, accumulator pools),
leaving 6 MiB for descriptors => ~82 K concurrent writes.  Requests that
cannot get a descriptor are denied (client retries later).

``littles_law_memory`` reproduces the worst-case analysis of Fig. 4.
"""

from __future__ import annotations

import dataclasses

WRITE_DESCRIPTOR_BYTES = 77
L1_BYTES_PER_CLUSTER = 1 << 20
NUM_CLUSTERS = 4
L2_BYTES = 4 << 20
DFS_WIDE_STATE_BYTES = 2 << 20


def descriptor_memory_budget() -> int:
    """NIC bytes available for request descriptors (6 MiB in the paper)."""
    return L1_BYTES_PER_CLUSTER * NUM_CLUSTERS + L2_BYTES - DFS_WIDE_STATE_BYTES


def max_concurrent_writes(budget: int | None = None) -> int:
    b = descriptor_memory_budget() if budget is None else budget
    return b // WRITE_DESCRIPTOR_BYTES


@dataclasses.dataclass
class RequestEntry:
    greq_id: int
    accept: bool
    wrh_blob: bytes = b""  # header-packet info needed by payload handlers


class RequestTable:
    """Bounded req_table (Listing 1) with deny-on-full semantics."""

    def __init__(self, capacity: int | None = None):
        self.capacity = (
            max_concurrent_writes() if capacity is None else int(capacity)
        )
        self._entries: dict[int, RequestEntry] = {}
        self.denied = 0
        self.high_watermark = 0

    def __len__(self) -> int:
        return len(self._entries)

    def insert(self, entry: RequestEntry) -> bool:
        """Returns False (deny; client must retry) when the table is full."""
        if len(self._entries) >= self.capacity:
            self.denied += 1
            return False
        self._entries[entry.greq_id] = entry
        self.high_watermark = max(self.high_watermark, len(self._entries))
        return True

    def get(self, greq_id: int) -> RequestEntry | None:
        return self._entries.get(greq_id)

    def remove(self, greq_id: int) -> RequestEntry | None:
        return self._entries.pop(greq_id, None)

    def cleanup_stale(self, alive: set[int]) -> list[int]:
        """Cleanup-handler semantics (paper section VII, client failure):
        drop entries whose request is no longer alive; returns dropped ids."""
        stale = [g for g in self._entries if g not in alive]
        for g in stale:
            del self._entries[g]
        return stale

    def memory_bytes(self) -> int:
        return len(self._entries) * WRITE_DESCRIPTOR_BYTES


def littles_law_concurrent_writes(
    write_size: int,
    service_time_s: float,
    bandwidth_bps: float = 400e9,
) -> float:
    """Average number of in-service writes: N = lambda * W (Little's law).

    lambda = arrival rate at full line rate = bandwidth / (8 * write_size);
    W = ``service_time_s`` = time a write stays "in service" (network
    transfer + handler time; handlers assumed not to bottleneck, as in the
    paper's Fig. 4 analysis).
    """
    arrival_rate = bandwidth_bps / (8.0 * write_size)
    return arrival_rate * service_time_s


def littles_law_memory(
    write_size: int,
    num_writes: float,
) -> float:
    """Worst-case NIC memory (bytes) to serve ``num_writes`` concurrently."""
    return num_writes * WRITE_DESCRIPTOR_BYTES
