"""Elastic scaling: re-mesh and re-shard live training state (PyTorch port of
``repro.runtime.elastic``).

On membership change (host loss or grow), the runtime builds a new mesh
from the surviving ranks and moves every state tensor onto it.  Because
the sharding rules are pure functions of (tree path, shape, mesh), the new
placement is recomputed, not stored.  A DTensor cannot be redistributed
from one mesh to another, so each leaf is gathered whole on the old mesh
(``full_tensor``) and every rank of the new mesh keeps its shard of it:
one leaf at a time, so a rank holds at most one whole leaf beside its
shards.  If ranks died *with* data (no graceful drain), the state is first
restored from the last policy-protected checkpoint
(``checkpoint.manager``).

``torch.distributed.new_group`` is collective over the whole world, so
every rank of the world calls :func:`build_mesh`, :func:`reshard_state`,
:func:`shrink` and :func:`grow`, the ranks being evicted included: they
take part in building the survivors' groups and in the gathers on the old
mesh, and get ``None`` for the state.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from repro_torch.models.layers import tree_leaves
from repro_torch.parallel import sharding as sh


def build_mesh(ranks: list[int], model_parallel: int, device_type: str | None = None):
    """Largest (data, model) ``DeviceMesh`` over ``ranks`` (drops the
    remainder).  Collective: every rank of the world calls it."""
    from torch.distributed.device_mesh import DeviceMesh

    n = len(ranks)
    model = model_parallel
    while model > 1 and (n < model or n % model):
        model //= 2
    data = n // model
    grid = torch.tensor(list(ranks[: data * model]), dtype=torch.int64).reshape(data, model)
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, grid, mesh_dim_names=("data", "model"))


def _members(mesh) -> set[int]:
    return set(mesh.mesh.flatten().tolist())


def reshard_state(state: Any, new_mesh, specs: Any | None = None, old_mesh=None) -> Any:
    """Move a tree of DTensors (params or moments; a leaf that is not a
    DTensor is kept as it is) onto ``new_mesh`` under the standard rules:
    each leaf gathered whole on ``old_mesh`` (default: the leaves' own),
    then every rank of ``new_mesh`` keeps its shard.  A rank of
    ``new_mesh`` outside ``old_mesh`` passes the tree's shapes (``meta``
    tensors, ``launch.steps.params_struct``) and receives each whole leaf
    from ``old_mesh``'s first rank.  Returns the new tree on ``new_mesh``'s
    ranks and ``None`` elsewhere."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    me = dist.get_rank()
    if old_mesh is None:
        old_mesh = next(t.device_mesh for t in tree_leaves(state) if isinstance(t, DTensor))
    old, new = _members(old_mesh), _members(new_mesh)
    newcomers = sorted(new - old)
    # a group is made by every rank of the world, members or not
    feed = dist.new_group(sorted(old | new)) if newcomers else None
    src = min(old)
    specs = sh.param_specs(state, new_mesh) if specs is None else specs

    def move(leaf, spec):
        if me in old and not isinstance(leaf, DTensor):
            return leaf
        whole = leaf.full_tensor() if me in old else None
        if newcomers and me in old | new:
            if whole is None:
                whole = torch.empty(leaf.shape, dtype=leaf.dtype, device=new_mesh.device_type)
            dist.broadcast(whole, src=src, group=feed)
        if me not in new:
            return None
        return distribute_tensor(whole, new_mesh, sh.placements(spec, new_mesh),
                                 src_data_rank=None)

    moved = sh.spec_map(move, state, specs)
    return moved if me in new else None


def shrink(state: Any, mesh, lost_ranks: set[int]) -> tuple[Any, Any]:
    """Evict ``lost_ranks`` and reshard the state onto the survivors.
    Collective over the world; the evicted ranks get ``None``."""
    survivors = [r for r in mesh.mesh.flatten().tolist() if r not in lost_ranks]
    model_par = sh.mesh_shape(mesh).get("model", 1)
    new_mesh = build_mesh(survivors, model_par, mesh.device_type)
    return reshard_state(state, new_mesh, old_mesh=mesh), new_mesh


def grow(state: Any, mesh, ranks: list[int], model_parallel: int) -> tuple[Any, Any]:
    """Reshard the state on ``mesh`` onto the mesh over ``ranks``; the ranks
    new to it pass the tree's shapes.  Collective over the world."""
    new_mesh = build_mesh(ranks, model_parallel, mesh.device_type)
    return reshard_state(state, new_mesh, old_mesh=mesh), new_mesh
