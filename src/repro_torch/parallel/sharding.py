"""Sharding rules: param/activation/cache partition specs for the 2D/3D mesh
(PyTorch port of ``repro.parallel.sharding``).

Scheme, as in the reference:
  * data axes  ("data", or ("pod","data") multi-pod): batch dimension of
    activations, FSDP dimension of parameters;
  * model axis ("model"): the second dimension of a weight, the expert
    axis, and sequence parallelism for the residual stream between blocks.

Every rule degrades gracefully: if a dimension is not divisible by the
mesh-axis size the rule falls back to an alternative dimension or to
replication, so small archs (whisper-base, xlstm-125m) shard on a 16-wide
model axis without special cases.

The rules are pure functions of (tree path, shape, mesh shape), and give
the reference's specs spec for spec.  A mesh is anything with axis names
and sizes: this module's :class:`AbstractMesh` (no process group, as the
production mesh and the rules' tests use it) or a
``torch.distributed.device_mesh.DeviceMesh``.  :func:`placements` turns a
spec into DTensor placements, one per mesh dimension, and
:func:`distribute_tree` places a tree of full tensors on a ``DeviceMesh``.

Paths are the reference's: dict keys and list indices joined by ``/``
(``jax.tree_util`` writes a list index as its number), walked in sorted
key order.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None``, a mesh-axis name, or a tuple of
    names (major first).  A one-name tuple is stored as the bare name, so
    ``P(("data",))`` equals ``P("data")`` (the canonical form the
    reference's rules give their param specs)."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


class AbstractMesh:
    """Axis names and sizes of a mesh, with no devices behind it."""

    def __init__(self, axis_sizes: tuple[int, ...], axis_names: tuple[str, ...]):
        if len(axis_sizes) != len(axis_names):
            raise ValueError(f"{axis_sizes} sizes for {axis_names} names")
        self.axis_names = tuple(axis_names)
        self.axis_sizes = tuple(int(n) for n in axis_sizes)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


def mesh_shape(mesh) -> dict[str, int]:
    """``{axis name: size}`` in mesh order, of an :class:`AbstractMesh` or a
    ``DeviceMesh``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    """Logical roles of the physical mesh axes."""

    data: tuple[str, ...] = ("data",)      # FSDP/DP (may include "pod")
    model: str = "model"

    @staticmethod
    def for_mesh(mesh) -> "MeshAxes":
        if "pod" in mesh_shape(mesh):
            return MeshAxes(data=("pod", "data"))
        return MeshAxes()


def axis_size(mesh, axes) -> int:
    """The number of ranks along ``axes`` (a name or a tuple of names)."""
    if isinstance(axes, str):
        axes = (axes,)
    shape = mesh_shape(mesh)
    return math.prod(shape[a] for a in axes)


def _fits(dim: int, mesh, axes) -> bool:
    return dim % axis_size(mesh, axes) == 0


def _is_container(x) -> bool:
    return isinstance(x, (dict, list, tuple)) and not isinstance(x, PartitionSpec)


def map_with_path(fn, tree: Any, prefix: str = "") -> Any:
    """``fn(path, leaf)`` on every leaf of a nest of dicts, lists and tuples
    (a :class:`PartitionSpec` is a leaf), dicts in sorted key order."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, tree[k], f"{prefix}/{k}" if prefix else str(k))
                for k in sorted(tree)}
    if _is_container(tree):
        return type(tree)(map_with_path(fn, v, f"{prefix}/{i}" if prefix else str(i))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def leaves_with_path(tree: Any) -> list[tuple[str, Any]]:
    """``(path, leaf)`` pairs in :func:`map_with_path`'s order."""
    found: list = []
    map_with_path(lambda path, leaf: found.append((path, leaf)), tree)
    return found


def spec_map(fn, *trees: Any) -> Any:
    """``fn`` over the leaves of trees of one structure, a
    :class:`PartitionSpec` being a leaf."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: spec_map(fn, *(t[k] for t in trees)) for k in sorted(first)}
    if _is_container(first):
        return type(first)(spec_map(fn, *parts) for parts in zip(*trees, strict=True))
    return fn(*trees)


# Rules: (substring, rank-agnostic spec builder).  The spec is built for the
# *trailing* dims; leading stacked-layer axes are padded with None.
def _param_rule(path: str, shape: tuple[int, ...], mesh, ax: MeshAxes) -> PartitionSpec:
    data, model = ax.data, ax.model
    nd = len(shape)

    def pad(spec_tail: list) -> PartitionSpec:
        return P(*([None] * (nd - len(spec_tail)) + spec_tail))

    def try_spec(tail: list) -> PartitionSpec | None:
        """tail entries: (axis_or_None); validate divisibility."""
        for dim, a in zip(shape[nd - len(tail):], tail):
            if a is None:
                continue
            if not _fits(dim, mesh, a):
                return None
        return pad(tail)

    # 1D params (norms, biases, A_log, ...): replicate.
    if nd == 1:
        return P(None)
    if path.endswith("embed/table"):
        return try_spec([model, data]) or try_spec([model, None]) or P(None)
    if "unembed" in path:
        return try_spec([data, model]) or try_spec([None, model]) or P(None)
    if any(s in path for s in ("w_gate", "w_up", "w_down")) and nd >= 3:
        # stacked experts (..., E, d, ff): EP over model, FSDP over d/ff
        if "w_down" in path:
            return try_spec([model, None, data]) or try_spec([model, None, None]) or P(None)
        return try_spec([model, data, None]) or try_spec([model, None, None]) or P(None)
    if "router" in path:
        return try_spec([data, None]) or P(None)
    # generic 2D matmul weights: prefer (in=FSDP, out=TP) for up-projections
    # and (in=TP, out=FSDP) for down/output projections.
    down_proj = any(s in path for s in ("wo", "down", "out_proj", "w_uv/w", "w_uk/w"))
    if nd >= 2:
        if down_proj:
            return (try_spec([model, data]) or try_spec([model, None])
                    or try_spec([None, data]) or try_spec([data, None]) or P(None))
        return (try_spec([data, model]) or try_spec([None, model])
                or try_spec([data, None]) or try_spec([None, data]) or P(None))
    return P(None)


def param_specs(params: Any, mesh) -> Any:
    """PartitionSpec tree matching ``params`` (anything with ``.shape`` at
    the leaves: tensors, ``meta`` tensors, DTensors)."""
    ax = MeshAxes.for_mesh(mesh)
    return map_with_path(lambda path, leaf: _param_rule(path, tuple(leaf.shape), mesh, ax),
                         params)


# -- activations / batches ----------------------------------------------------


def batch_dim_spec(dim: int, mesh, ax: MeshAxes):
    """Spec entry for a batch dimension (None when not divisible)."""
    return ax.data if _fits(dim, mesh, ax.data) else None


def data_batch_specs(shapes: dict[str, tuple], mesh) -> dict[str, PartitionSpec]:
    """Specs for a train/serve input batch dict: batch over data, the other
    dims unsharded."""
    ax = MeshAxes.for_mesh(mesh)
    out = {}
    for name, shp in shapes.items():
        if len(shp) == 0:
            out[name] = P()
            continue
        out[name] = P(batch_dim_spec(shp[0], mesh, ax), *([None] * (len(shp) - 1)))
    return out


def residual_spec(batch: int, seq: int, mesh) -> PartitionSpec:
    """Residual-stream constraint: batch over data + sequence over model
    (Megatron-style sequence parallelism between blocks)."""
    ax = MeshAxes.for_mesh(mesh)
    b = batch_dim_spec(batch, mesh, ax)
    s = ax.model if seq % mesh_shape(mesh)[ax.model] == 0 else None
    return P(b, s, None)


def moe_buffer_spec(n_experts: int, mesh, batch: int = 0) -> PartitionSpec | None:
    """(B, E, C, d) dispatch-buffer constraint: batch over data (per-row
    dispatch), experts over model."""
    ax = MeshAxes.for_mesh(mesh)
    if n_experts % mesh_shape(mesh)[ax.model] != 0:
        return None
    b = batch_dim_spec(batch, mesh, ax) if batch else None
    return P(b, ax.model, None, None)


def cache_specs(cache: Any, mesh, max_len: int, batch: int) -> Any:
    """KV/SSM cache specs: batch over data; heads (or head_dim) over model.

    The batch dim is identified by value (first dim == ``batch``, searched
    left-to-right so stacked-layer leading axes are never mistaken for it);
    dims equal to ``max_len`` are never sharded (decode writes into them at
    ``cur_len``); the model axis takes the last divisible remaining dim
    (kv-heads or head_dim).
    """
    ax = MeshAxes.for_mesh(mesh)
    tp = mesh_shape(mesh)[ax.model]

    def one(_path, leaf):
        shp = tuple(leaf.shape)
        spec: list = [None] * len(shp)
        bdim = None
        for i, d in enumerate(shp):
            if d == batch and d != max_len:
                bdim = i
                break
        if bdim is not None and shp[bdim] % axis_size(mesh, ax.data) == 0:
            spec[bdim] = ax.data
        for i in range(len(shp) - 1, -1, -1):
            if shp[i] == max_len or i == bdim:
                continue
            if spec[i] is None and shp[i] % tp == 0 and shp[i] > 1:
                spec[i] = ax.model
                break
        return P(*spec)

    return map_with_path(one, cache)


# -- DTensor placements ---------------------------------------------------------


def placements(spec: PartitionSpec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dimension:
    ``Shard(d)`` where tensor dim ``d``'s entry names that mesh axis, else
    ``Replicate()``.  A dim sharded over several axes (``("pod","data")``)
    is ``Shard(d)`` on each, the mesh's major axis first, as the reference
    splits it."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_shape(mesh))
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in ((entry,) if isinstance(entry, str) else entry):
            out[names.index(a)] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """A spec on a mesh (the reference's ``NamedSharding``).  On a
    ``DeviceMesh`` the sharded step's constraints also carry ``ctx``, the
    :class:`repro_torch.parallel.spmd.StepContext` whose collectives the
    model runs where the reference constrains a layout."""

    mesh: Any
    spec: PartitionSpec
    ctx: Any = None

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def param_shardings(params: Any, mesh) -> Any:
    """A :class:`NamedSharding` for every leaf of ``params`` on ``mesh``."""
    return spec_map(lambda s: NamedSharding(mesh, s), param_specs(params, mesh))


def distribute_tree(tree: Any, mesh, specs: Any | None = None) -> Any:
    """Full tensors -> DTensors on ``mesh`` (a ``DeviceMesh``) placed by
    ``specs`` (default: :func:`param_specs`).  Every rank passes the same
    full tree and keeps its own shard of it; nothing is sent."""
    from torch.distributed.tensor import distribute_tensor

    specs = param_specs(tree, mesh) if specs is None else specs
    return spec_map(lambda t, s: distribute_tensor(t, mesh, placements(s, mesh),
                                                   src_data_rank=None), tree, specs)
