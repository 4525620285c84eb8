"""Training-plane parallelism: the chunk-pipelined ring collectives on
``torch.distributed`` point-to-point (:mod:`repro_torch.parallel.collectives`),
the sharding rules (:mod:`repro_torch.parallel.sharding`, the reference's
specs on an ``AbstractMesh`` or a ``DeviceMesh``, and their DTensor
placements), and the sharded step's explicit collectives
(:mod:`repro_torch.parallel.spmd`, imported by the models; not from here,
since ``core.replication`` imports this package before the models exist).

The reference's ``parallel/compat.py`` is a JAX-version shim with no
counterpart here.
"""

from repro_torch.parallel.collectives import (
    make_ring_collective,
    ring_all_gather,
    ring_all_reduce,
    ring_reduce_scatter,
)
from repro_torch.parallel.sharding import (
    AbstractMesh,
    MeshAxes,
    NamedSharding,
    PartitionSpec,
    batch_dim_spec,
    cache_specs,
    data_batch_specs,
    distribute_tree,
    moe_buffer_spec,
    param_shardings,
    param_specs,
    placements,
    residual_spec,
)

__all__ = [
    "AbstractMesh",
    "MeshAxes",
    "NamedSharding",
    "PartitionSpec",
    "batch_dim_spec",
    "cache_specs",
    "data_batch_specs",
    "distribute_tree",
    "make_ring_collective",
    "moe_buffer_spec",
    "param_shardings",
    "param_specs",
    "placements",
    "residual_spec",
    "ring_all_gather",
    "ring_all_reduce",
    "ring_reduce_scatter",
]
