"""The paper's NIC-offloadable DFS policies (see ``repro.core``).

  * protocol        -> :mod:`repro_torch.core.auth`        (capability validation)
  * data movement   -> :mod:`repro_torch.core.replication` (ring/PBT pipelined bcast)
  * data processing -> :mod:`repro_torch.core.erasure`     (streaming RS(k, m))

:mod:`repro_torch.core.handlers` composes them into the sPIN HH/PH/CH
execution model; :mod:`repro_torch.core.packets` defines the wire format;
:mod:`repro_torch.core.state` the bounded on-NIC state.  Timing/evaluation
lives in :mod:`repro_torch.sim`; the production consumer is
:mod:`repro_torch.checkpoint`.  The broadcasts run on ``torch.distributed``
point-to-point, the erasure code on the CUDA kernels of
:mod:`repro_torch.kernels`.
"""

from repro_torch.core.auth import Capability, CapabilityAuthority, Rights, sponge_mac
from repro_torch.core.erasure import (
    RSCode,
    split_stripe,
    join_stripe,
    stream_encode,
    stream_encode_packets,
)
from repro_torch.core.handlers import DFSClient, DFSNode, Router, StorageTarget
from repro_torch.core.packets import (
    DEFAULT_MTU,
    DFSHeader,
    OpType,
    Packet,
    ReadRequestHeader,
    ReplicaCoord,
    ReplStrategy,
    Resiliency,
    WriteRequestHeader,
    packetize_write,
)
from repro_torch.core.replication import (
    BroadcastPlan,
    children_of,
    optimal_chunk_count,
    pbt_broadcast,
    replicate,
    ring_broadcast,
)
from repro_torch.core.state import RequestTable, littles_law_concurrent_writes

__all__ = [
    "Capability",
    "CapabilityAuthority",
    "Rights",
    "sponge_mac",
    "RSCode",
    "split_stripe",
    "join_stripe",
    "stream_encode",
    "stream_encode_packets",
    "DFSClient",
    "DFSNode",
    "Router",
    "StorageTarget",
    "DEFAULT_MTU",
    "DFSHeader",
    "OpType",
    "Packet",
    "ReadRequestHeader",
    "ReplicaCoord",
    "ReplStrategy",
    "Resiliency",
    "WriteRequestHeader",
    "packetize_write",
    "BroadcastPlan",
    "children_of",
    "optimal_chunk_count",
    "pbt_broadcast",
    "replicate",
    "ring_broadcast",
    "RequestTable",
    "littles_law_concurrent_writes",
]
