"""The sharded step's explicit collectives (the port's counterpart of what
GSPMD inserts for the reference's sharding constraints).

At rest every parameter and both AdamW moments are DTensors placed by
:func:`repro_torch.parallel.sharding.param_specs`.  In compute the step
works on their local shards, and each reference constraint becomes an
explicit collective at the reference's place, differentiable through the
``torch.autograd.Function`` s below (c10d's ``all_gather_into_tensor``,
``reduce_scatter_tensor``, ``all_to_all_single`` and ``all_reduce`` inside,
which exist under these names in every torch this port runs on):

* FSDP: :meth:`StepContext.gather` all-gathers a parameter's shards where
  it is used (a stacked leaf one layer at a time, after
  :meth:`StepContext.unstack`'s ``unbind``) and the backward
  reduce-scatters its gradient onto the parameter's own placement;
* the residual stream ``P(batch/data, seq/model, None)``: each model rank
  holds its slice of the sequence (:meth:`StepContext.slice_seq`), and
  :meth:`StepContext.gather_seq` / :meth:`StepContext.whole_sequence` bring
  the rows together where a layer needs them.

A mesh axis along which the tokens are split (data when the batch divides,
model when the sequence does) is a *token axis*: the ranks along it hold
different parts of the loss, so a gradient is summed over it.  Along any
other axis every rank computes the same thing: an all-gather's backward
then takes the rank's own slice, and a slice's backward all-gathers.

A decode step (no gradient) runs on the cache's shards as
:func:`repro_torch.parallel.sharding.cache_specs` places them: where the
model axis splits each head's vector (or a state's last dim), the ranks'
partial scores are summed over model (:meth:`StepContext.sum_over_model`)
and the outputs gathered (:meth:`StepContext.gather_model`); no step
gathers a layer's KV cache.

A (data, model) ``DeviceMesh`` is taken, and the multi-pod
(pod, data, model) one, whose rules split a dim over ``("pod", "data")``:
those two axes act as one data axis, flattened pod-major
(:func:`data_axis`).
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.kernels import adamw as kadamw
from repro_torch.models.layers import tree_leaves, tree_map, tree_unflatten
from repro_torch.parallel.sharding import PartitionSpec, spec_map

AXES = ("data", "model")
#: the multi-pod mesh's data axes, which its rules always name together
POD_DATA = ("pod", "data")


# -- autograd collectives --------------------------------------------------------


class _Axis:
    """One mesh axis as the collectives need it: its group, size, this
    rank's index along it, and whether the tokens are split along it."""

    def __init__(self, group, size: int, rank: int, token: bool):
        self.group, self.size, self.rank, self.token = group, size, rank, token


def _all_gather(x: torch.Tensor, dim: int, ax: _Axis) -> torch.Tensor:
    xs = x.movedim(dim, 0).contiguous()
    out = xs.new_empty((ax.size * xs.shape[0], *xs.shape[1:]))
    dist.all_gather_into_tensor(out, xs, group=ax.group)
    return out.movedim(0, dim)


def _reduce_scatter(x: torch.Tensor, dim: int, ax: _Axis) -> torch.Tensor:
    xs = x.movedim(dim, 0).contiguous()
    out = xs.new_empty((xs.shape[0] // ax.size, *xs.shape[1:]))
    dist.reduce_scatter_tensor(out, xs, group=ax.group)
    return out.movedim(0, dim)


def _own_slice(x: torch.Tensor, dim: int, ax: _Axis) -> torch.Tensor:
    return x.chunk(ax.size, dim)[ax.rank]


def _zero_pad(x: torch.Tensor, dim: int, ax: _Axis) -> torch.Tensor:
    shape = list(x.shape)
    shape[dim] *= ax.size
    out = x.new_zeros(shape)
    _own_slice(out, dim, ax).copy_(x)
    return out


class _Gather(torch.autograd.Function):
    """All-gather along ``dim``; backward: reduce-scatter along a token
    axis, else the rank's own slice."""

    @staticmethod
    def forward(ctx, x, dim, ax):
        ctx.dim, ctx.ax = dim, ax
        return _all_gather(x, dim, ax)

    @staticmethod
    def backward(ctx, g):
        split = _reduce_scatter if ctx.ax.token else _own_slice
        return split(g, ctx.dim, ctx.ax), None, None


class _Slice(torch.autograd.Function):
    """The rank's slice along ``dim``; backward: zero-padded along a token
    axis (the other slices' gradients are the other ranks'), else
    all-gathered."""

    @staticmethod
    def forward(ctx, x, dim, ax):
        ctx.dim, ctx.ax = dim, ax
        return _own_slice(x, dim, ax).contiguous()

    @staticmethod
    def backward(ctx, g):
        join = _zero_pad if ctx.ax.token else _all_gather
        return join(g.contiguous(), ctx.dim, ctx.ax), None, None


class _SumGrad(torch.autograd.Function):
    """Identity; backward: the gradient summed over the group (a parameter
    replicated along a token axis)."""

    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.ax.group)
        return g, None


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` of equal chunks of dim 0; it is its own adjoint."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _a2a(x, group)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.group), None


def _a2a(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable ``all_to_all_single``: chunk i of dim 0 goes to rank i
    of ``group``, and chunk i of the result came from rank i."""
    if dist.get_world_size(group) == 1:
        return x
    return _AllToAll.apply(x, group)


def gather(x: torch.Tensor, dim: int, ax: _Axis) -> torch.Tensor:
    return x if ax.size == 1 else _Gather.apply(x, dim, ax)


def take_slice(x: torch.Tensor, dim: int, ax: _Axis) -> torch.Tensor:
    return x if ax.size == 1 else _Slice.apply(x, dim, ax)


def sum_grad(x: torch.Tensor, ax: _Axis) -> torch.Tensor:
    return x if ax.size == 1 else _SumGrad.apply(x, ax)


def mesh_axis(mesh, name: str, token: bool) -> _Axis:
    """Axis ``name`` of a ``DeviceMesh`` for the collectives above."""
    i = list(mesh.mesh_dim_names).index(name)
    return _Axis(mesh.get_group(name), mesh.size(i), mesh.get_local_rank(name), token)


def data_axis(mesh, token: bool) -> _Axis:
    """The data axis of a (data, model) ``DeviceMesh``, or of a (pod, data,
    model) one its pod and data axes flattened into one, pod-major, as the
    rules split a dim over ``("pod", "data")``."""
    if "pod" not in mesh.mesh_dim_names:
        return mesh_axis(mesh, "data", token)
    flat = mesh[POD_DATA]._flatten()
    return _Axis(flat.get_group(), flat.size(), flat.get_local_rank(), token)


# -- the step's context ----------------------------------------------------------


def context(*shardings) -> "StepContext | None":
    """The step context the first of ``shardings`` (the port's
    ``NamedSharding`` s, or None) carries; None on one device."""
    for sharding in shardings:
        if sharding is not None and sharding.ctx is not None:
            return sharding.ctx
    return None


def _axes_of(entry) -> tuple[str, ...]:
    """The step's axes a spec entry names: ``("pod", "data")`` is the one
    flattened data axis."""
    if entry is None:
        return ()
    axes = (entry,) if isinstance(entry, str) else tuple(entry)
    return ("data",) if axes == POD_DATA else axes


class StepContext:
    """A (data, model) ``DeviceMesh`` as one sharded step computes on it:
    its axes (:class:`_Axis`), whether the batch (over data) and the
    sequence (over model) are split, and the partition spec of every local
    parameter tensor the step hands the model (:meth:`bind`)."""

    def __init__(self, mesh, batch_split: bool, seq_split: bool):
        if tuple(mesh.mesh_dim_names or ()) not in (AXES, POD_DATA + ("model",)):
            raise NotImplementedError(
                f"the sharded step takes a ('data', 'model') or ('pod', 'data', 'model') "
                f"DeviceMesh, got {mesh.mesh_dim_names}")
        self.mesh = mesh
        self.batch_split, self.seq_split = batch_split, seq_split
        self.axes = {"data": data_axis(mesh, batch_split),
                     "model": mesh_axis(mesh, "model", seq_split)}
        # id -> (tensor, spec, whether the sums of its gradient over the token
        # axes it is replicated on are already taken, on its whole stack)
        self._specs: dict[int, tuple[torch.Tensor, PartitionSpec, bool]] = {}

    # parameters ------------------------------------------------------------

    @contextlib.contextmanager
    def bind(self, params: Any, specs: Any):
        """Register each local parameter tensor of ``params`` with its spec
        (by identity) while the block runs."""
        saved = dict(self._specs)
        spec_map(self._register, params, specs)
        try:
            yield
        finally:
            self._specs = saved

    def _register(self, t: torch.Tensor, spec: PartitionSpec, summed: bool = False) -> None:
        self._specs[id(t)] = (t, PartitionSpec(*spec), summed)

    def _entry(self, t: torch.Tensor) -> tuple[torch.Tensor, PartitionSpec, bool]:
        try:
            return self._specs[id(t)]
        except KeyError:
            raise KeyError("a tensor the sharded step did not bind reached a gather "
                           f"(shape {tuple(t.shape)})") from None

    def spec_of(self, t: torch.Tensor) -> PartitionSpec:
        return self._entry(t)[1]

    def _sum_unsharded(self, t: torch.Tensor, spec: PartitionSpec,
                       axes: tuple[str, ...]) -> torch.Tensor:
        """Identity whose backward sums the gradient over every token axis
        of ``axes`` that ``spec`` does not shard (the ranks along it hold
        other tokens' gradients of the same values)."""
        sharded = {a for entry in spec for a in _axes_of(entry)}
        for a in AXES:
            if a in axes and a not in sharded and self.axes[a].token:
                t = sum_grad(t, self.axes[a])
        return t

    def _gather_dims(self, t: torch.Tensor, spec: PartitionSpec,
                     axes: tuple[str, ...]) -> torch.Tensor:
        for d, entry in enumerate(spec):
            for a in reversed(_axes_of(entry)):
                if a in axes:
                    t = gather(t, d, self.axes[a])
        return t

    def gather_leaf(self, t: torch.Tensor, axes: tuple[str, ...] = AXES) -> torch.Tensor:
        """A bound parameter shard -> its whole over ``axes``: all-gathered
        dim by dim, the backward reduce-scattering its gradient onto the
        shard (and summing it over the token axes it is replicated on)."""
        _, spec, summed = self._entry(t)
        if not summed:
            t = self._sum_unsharded(t, spec, axes)
        return self._gather_dims(t, spec, axes)

    def gather(self, tree: Any, axes: tuple[str, ...] = AXES) -> Any:
        """Every bound tensor of ``tree`` whole over ``axes``."""
        return tree_map(lambda t: self.gather_leaf(t, axes), tree)

    def unstack(self, stacked: Any, axes: int = 1) -> list:
        """The layers of a bound stacked tree (local shards), as
        ``transformer.unstack`` takes them, each layer's tensors bound with
        the rest of their spec.  The rules pad the stacked axes of a weight
        with None, so a layer's slice of a shard is a shard of the layer;
        only the per-layer 1-D leaves (norm scales, biases, Mamba2's A_log,
        D, dt_bias: a few KB a layer) may be split along a stacked axis, and
        those are gathered along it first, whole."""
        leaves = []
        for t in tree_leaves(stacked):
            _, spec, summed = self._entry(t)
            head, tail = spec[:axes], PartitionSpec(*spec[axes:])
            if any(e is not None for e in head):
                if not summed:
                    t = self._sum_unsharded(t, spec, AXES)
                t = self._gather_dims(t, PartitionSpec(*head), AXES)
                summed = True
            leaves.append((t, tail, summed))
        per_leaf = [t.flatten(0, axes - 1).unbind(0) for t, _, _ in leaves]
        layers = []
        for parts in zip(*per_leaf):
            for part, (_, tail, summed) in zip(parts, leaves):
                self._register(part, tail, summed)
            layers.append(tree_unflatten(stacked, parts))
        return layers

    # activations -------------------------------------------------------------

    @property
    def model(self) -> _Axis:
        return self.axes["model"]

    def seq_offset(self, local_len: int) -> int:
        """Position of this rank's first row in the whole sequence."""
        return self.model.rank * local_len if self.seq_split else 0

    def whole_batch(self, local_rows: int) -> int:
        """Rows of the whole batch, from this rank's."""
        return local_rows * (self.axes["data"].size if self.batch_split else 1)

    def whole_len(self, local_len: int) -> int:
        """Length of the whole sequence, from this rank's slice."""
        return local_len * (self.model.size if self.seq_split else 1)

    def slice_seq(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's slice of a whole sequence (no-op when it is not split)."""
        return take_slice(x, dim, self.model) if self.seq_split else x

    def gather_seq(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """The whole sequence from every model rank's slice (no-op when it is
        not split); backward: each rank keeps the sum of its slice's
        gradients."""
        return gather(x, dim, self.model) if self.seq_split else x

    def whole_sequence(self, fn: Callable, *xs: torch.Tensor) -> torch.Tensor:
        """``fn`` over the whole sequence of ``xs`` (B, S_local, ...), its
        output cut back to this rank's slice: the layers with no sharding
        hint in the reference (the xLSTM scans, Mamba2 without ``ssm_h``,
        attention without ``kv``, the dense MoE's per-row routing)."""
        return self.slice_seq(fn(*(self.gather_seq(x) for x in xs)))

    def heads_from_seq(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S_local, H, ...) -> (B, S, H_local, ...) by one all-to-all over
        model (sequence-sharded to head-sharded)."""
        tp = self.model.size
        if not self.seq_split:
            return take_slice(x, 2, self.model)
        b, sl, h = x.shape[:3]
        rest = x.shape[3:]
        y = x.reshape(b, sl, tp, h // tp, *rest).movedim(2, 0)        # (tp, B, Sl, Hl, ...)
        y = all_to_all(y, self.model.group)                           # chunk i: rank i's rows
        return y.movedim(0, 1).reshape(b, tp * sl, h // tp, *rest)

    def seq_from_heads(self, y: torch.Tensor) -> torch.Tensor:
        """(B, S, H_local, ...) -> (B, S_local, H, ...), the inverse of
        :meth:`heads_from_seq`."""
        tp = self.model.size
        if not self.seq_split:
            return gather(y, 2, self.model)
        b, s, hl = y.shape[:3]
        rest = y.shape[3:]
        z = y.reshape(b, tp, s // tp, hl, *rest).movedim(1, 0)        # (tp, B, Sl, Hl, ...)
        z = all_to_all(z, self.model.group)                           # chunk i: rank i's heads
        return z.movedim(0, 2).reshape(b, s // tp, tp * hl, *rest)

    def slice_heads(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's heads of a per-head tensor (the head-parallel scan's
        share of A_log, D and dt_bias)."""
        return take_slice(t, dim, self.model)

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The whole batch's rows (dim 0) from every data rank's (no-op when
        the batch is not split); no gradient."""
        data = self.axes["data"]
        return _all_gather(x, 0, data) if self.batch_split and data.size > 1 else x

    # decode (no gradient) ------------------------------------------------------

    def sum_over_model(self, x: torch.Tensor) -> torch.Tensor:
        """Partial sums over the model ranks' slices of a split dim (a decode
        step's scores over a head's vector), added up in place."""
        if self.model.size > 1:
            dist.all_reduce(x, group=self.model.group)
        return x

    def gather_model(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole of ``dim`` from every model rank's slice."""
        return x if self.model.size == 1 else _all_gather(x, dim % x.dim(), self.model)

    def own_model(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This model rank's slice of ``dim``."""
        return x if self.model.size == 1 else _own_slice(x, dim, self.model)

    def model_dim(self, shard: torch.Tensor, whole: tuple[int, ...]) -> int | None:
        """The trailing dim (a negative index) of a cache shard that the model
        axis splits, from its trailing sizes ``whole`` before the split
        (``cache_specs`` puts the model axis on one dim at most); None where
        the shard holds them whole."""
        for i in range(1, len(whole) + 1):
            if shard.shape[-i] != whole[-i]:
                if shard.shape[-i] * self.model.size != whole[-i]:
                    raise ValueError(f"a cache shard of shape {tuple(shard.shape)} is no "
                                     f"model-axis split of (..., {whole})")
                return -i
        return None

    def whole_state(self, shard: torch.Tensor,
                    whole: tuple[int, ...]) -> tuple[torch.Tensor, int | None]:
        """A recurrent state's shard gathered whole over model, and the dim it
        was split on (for :meth:`keep_state`)."""
        dim = self.model_dim(shard, whole)
        return (shard if dim is None else self.gather_model(shard, dim)), dim

    def keep_state(self, shard: torch.Tensor, new: torch.Tensor, dim: int | None) -> None:
        """Write this rank's slice of a whole new state into its shard."""
        shard.copy_(new if dim is None else self.own_model(new, dim))

    def sum_over_tokens(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (no gradient) summed over every token axis."""
        x = x.detach().clone()
        for ax in self.axes.values():
            if ax.token and ax.size > 1:
                dist.all_reduce(x, group=ax.group)
        return x

    # optimizer ---------------------------------------------------------------

    def owns(self, spec: PartitionSpec) -> bool:
        """Whether this rank holds the copy of a shard of ``spec`` that is
        counted once: index 0 along every mesh axis the spec does not split."""
        sharded = {a for entry in spec for a in _axes_of(entry)}
        return all(self.axes[a].rank == 0 for a in AXES if a not in sharded)

    def global_norm(self, grads: Any, specs: Any) -> torch.Tensor:
        """The L2 norm of the whole gradient tree from its shards: this
        rank's sum of squares over the shards it holds the counted copy of
        (a replicated shard counted once), in fp64 by
        ``kernels.adamw.sum_of_squares`` (the fused kernel on the card),
        added over the mesh (one all-reduce a split axis), then its root in
        fp32, as ``kernels.adamw.grad_norm`` takes it.  On a mesh of one
        device, the one-device step's bits."""
        pairs: list = []
        spec_map(lambda g, s: pairs.append((g, s)), grads, specs)
        total = kadamw.sum_of_squares([g for g, s in pairs if self.owns(s)],
                                      pairs[0][0].device if pairs else None)
        for ax in self.axes.values():       # the mesh may be part of the world
            if ax.size > 1:
                dist.all_reduce(total, group=ax.group)
        return torch.sqrt(total).to(torch.float32)
