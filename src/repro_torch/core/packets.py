"""Wire format for DFS client requests (paper section III-A, Fig. 3).

A write request is a stream of MTU-sized packets.  Only the first packet
carries the DFS-specific headers:

  [RDMA header][DFS header][WRH (write) | RRH (read)][payload...]

subsequent packets carry [RDMA header][payload].  Request headers always fit
in one packet (realistic for RoCE MTUs of 1.5-9 KiB; we default to the
paper's 2048 B simulation MTU).

In the TPU framework the "packet" is a chunk of a tensor byte-stream, but
the framing is identical — the checkpoint data plane and the simulator share
this module.
"""

from __future__ import annotations

import dataclasses
import enum
import struct

import numpy as np

from repro_torch.core.auth import Capability

DEFAULT_MTU = 2048
RDMA_HEADER_SIZE = 28  # BTH(12) + RETH(16), RoCEv2-style


class OpType(enum.IntEnum):
    WRITE = 1
    READ = 2
    WRITE_ACK = 3
    READ_RESP = 4
    NACK = 5
    INTERMEDIATE_PARITY = 6  # TriEC data-node -> parity-node packets


class Resiliency(enum.IntEnum):
    NONE = 0
    REPLICATION = 1
    ERASURE_CODING = 2


class ReplStrategy(enum.IntEnum):
    RING = 0
    PBT = 1  # pipelined binary tree


@dataclasses.dataclass(frozen=True)
class DFSHeader:
    """Generic DFS header: request identity + authentication."""

    op: OpType
    greq_id: int          # globally unique request id
    client_id: int
    capability: Capability

    _STRUCT = struct.Struct("<BxxxQI")

    def pack(self) -> bytes:
        return (
            self._STRUCT.pack(int(self.op), self.greq_id, self.client_id)
            + self.capability.pack()
        )

    @classmethod
    def unpack(cls, raw: bytes) -> "DFSHeader":
        op, greq, client = cls._STRUCT.unpack(raw[: cls._STRUCT.size])
        cap = Capability.unpack(raw[cls._STRUCT.size :])
        return cls(OpType(op), greq, client, cap)

    @classmethod
    def packed_size(cls) -> int:
        return cls._STRUCT.size + Capability.PACKED_SIZE


@dataclasses.dataclass(frozen=True)
class ReplicaCoord:
    """Network address + storage address of one replica/parity target."""

    node: int
    addr: int

    _STRUCT = struct.Struct("<IQ")

    def pack(self) -> bytes:
        return self._STRUCT.pack(self.node, self.addr)

    @classmethod
    def unpack(cls, raw: bytes) -> "ReplicaCoord":
        return cls(*cls._STRUCT.unpack(raw[: cls._STRUCT.size]))

    SIZE = 12


@dataclasses.dataclass(frozen=True)
class WriteRequestHeader:
    """WRH: destination extent + resiliency policy parameters.

    For REPLICATION: ``strategy``, ``virtual_rank`` (this node's position in
    the broadcast tree) and the full replica coordinate list (client-driven,
    source-routed — paper section V-A).
    For ERASURE_CODING: RS(k, m), this node's ``role`` (ec_index < k: data
    node storing chunk ec_index; >= k: parity node), and parity coordinates.
    """

    addr: int
    size: int
    resiliency: Resiliency = Resiliency.NONE
    strategy: ReplStrategy = ReplStrategy.RING
    virtual_rank: int = 0
    replicas: tuple[ReplicaCoord, ...] = ()
    ec_k: int = 0
    ec_m: int = 0
    ec_index: int = 0
    seq: int = 0  # aggregation sequence base (TriEC)

    _STRUCT = struct.Struct("<QQBBHBBHI")

    def pack(self) -> bytes:
        head = self._STRUCT.pack(
            self.addr,
            self.size,
            int(self.resiliency),
            int(self.strategy),
            self.virtual_rank,
            self.ec_k,
            self.ec_m,
            self.ec_index,
            self.seq,
        )
        body = struct.pack("<H", len(self.replicas)) + b"".join(
            r.pack() for r in self.replicas
        )
        return head + body

    @classmethod
    def unpack(cls, raw: bytes) -> "WriteRequestHeader":
        vals = cls._STRUCT.unpack(raw[: cls._STRUCT.size])
        off = cls._STRUCT.size
        (nrep,) = struct.unpack("<H", raw[off : off + 2])
        off += 2
        reps = []
        for _ in range(nrep):
            reps.append(ReplicaCoord.unpack(raw[off : off + ReplicaCoord.SIZE]))
            off += ReplicaCoord.SIZE
        return cls(
            addr=vals[0],
            size=vals[1],
            resiliency=Resiliency(vals[2]),
            strategy=ReplStrategy(vals[3]),
            virtual_rank=vals[4],
            ec_k=vals[5],
            ec_m=vals[6],
            ec_index=vals[7],
            seq=vals[8],
            replicas=tuple(reps),
        )

    def packed_size(self) -> int:
        return self._STRUCT.size + 2 + ReplicaCoord.SIZE * len(self.replicas)


@dataclasses.dataclass(frozen=True)
class ReadRequestHeader:
    addr: int
    size: int

    _STRUCT = struct.Struct("<QQ")

    def pack(self) -> bytes:
        return self._STRUCT.pack(self.addr, self.size)

    @classmethod
    def unpack(cls, raw: bytes) -> "ReadRequestHeader":
        return cls(*cls._STRUCT.unpack(raw[: cls._STRUCT.size]))

    def packed_size(self) -> int:
        return self._STRUCT.size


@dataclasses.dataclass
class Packet:
    """One network packet. ``is_header``/``is_completion`` drive HH/CH
    scheduling (sPIN: header delivered first, completion last)."""

    greq_id: int
    pkt_index: int
    is_header: bool
    is_completion: bool
    dfs: DFSHeader | None
    wrh: WriteRequestHeader | None
    rrh: ReadRequestHeader | None
    payload: np.ndarray          # uint8
    payload_offset: int          # byte offset of this payload within the write
    wire_size: int               # bytes on the wire incl. headers
    ctrl: OpType | None = None   # set for control packets (ACK/NACK)

    @property
    def payload_size(self) -> int:
        return int(self.payload.size)


def packetize_write(
    dfs: DFSHeader,
    wrh: WriteRequestHeader,
    data: np.ndarray,
    mtu: int = DEFAULT_MTU,
) -> list[Packet]:
    """Frame a write request into packets (first packet carries headers)."""
    data = np.asarray(data, dtype=np.uint8).ravel()
    head_overhead = RDMA_HEADER_SIZE + DFSHeader.packed_size() + wrh.packed_size()
    if head_overhead >= mtu:
        raise ValueError(f"headers ({head_overhead} B) do not fit in MTU {mtu}")
    first_cap = mtu - head_overhead
    rest_cap = mtu - RDMA_HEADER_SIZE
    pkts: list[Packet] = []
    off = 0
    idx = 0
    while True:
        cap = first_cap if idx == 0 else rest_cap
        chunk = data[off : off + cap]
        is_last = off + chunk.size >= data.size
        pkts.append(
            Packet(
                greq_id=dfs.greq_id,
                pkt_index=idx,
                is_header=(idx == 0),
                is_completion=is_last,
                dfs=dfs if idx == 0 else None,
                wrh=wrh if idx == 0 else None,
                rrh=None,
                payload=np.ascontiguousarray(chunk),
                payload_offset=off,
                wire_size=(head_overhead if idx == 0 else RDMA_HEADER_SIZE)
                + int(chunk.size),
            )
        )
        off += int(chunk.size)
        idx += 1
        if is_last:
            break
    return pkts


def num_packets(size: int, wrh_size: int, mtu: int = DEFAULT_MTU) -> int:
    """Packet count for a write of ``size`` payload bytes (analysis helper)."""
    head_overhead = RDMA_HEADER_SIZE + DFSHeader.packed_size() + wrh_size
    first_cap = mtu - head_overhead
    if size <= first_cap:
        return 1
    rest = size - first_cap
    return 1 + -(-rest // (mtu - RDMA_HEADER_SIZE))
