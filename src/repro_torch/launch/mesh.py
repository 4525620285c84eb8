"""Mesh construction (PyTorch port of ``repro.launch.mesh``).

Defined as functions, never module-level constants, so importing this
module touches no process group.

``make_production_mesh`` gives the production shapes as an
:class:`~repro_torch.parallel.sharding.AbstractMesh` (axis names and
sizes): no 256- or 512-rank group exists to build, and the sharding rules
need only the shape.  ``make_debug_mesh`` builds a real
``DeviceMesh`` over the ranks of an initialised process group.
"""

from __future__ import annotations

from repro_torch.parallel.sharding import AbstractMesh


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """16x16 = 256 chips single-pod, or (2, 16, 16) = 512 chips 2-pod.

    Axes: ``data`` = DP/FSDP, ``model`` = TP/SP/EP; ``pod`` composes with
    ``data`` (gradient reduction crosses pods, FSDP gathers stay inside).
    """
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def make_debug_mesh(data: int = 2, model: int = 2, device_type: str = "cuda"):
    """A (data, model) ``DeviceMesh`` over the ``data * model`` ranks of the
    initialised default process group (``device_type`` "cpu" with gloo,
    "cuda" with one card a rank)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (data, model), mesh_dim_names=("data", "model"))
