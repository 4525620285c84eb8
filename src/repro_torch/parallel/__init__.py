"""Training-plane parallelism: the chunk-pipelined ring collectives on
``torch.distributed`` point-to-point (:mod:`repro_torch.parallel.collectives`).

The reference's ``parallel/compat.py`` is a JAX-version shim with no
counterpart here; its sharding rules (``parallel/sharding.py``) come with
the runtime.
"""

from repro_torch.parallel.collectives import (
    make_ring_collective,
    ring_all_gather,
    ring_all_reduce,
    ring_reduce_scatter,
)

__all__ = [
    "make_ring_collective",
    "ring_all_gather",
    "ring_all_reduce",
    "ring_reduce_scatter",
]
