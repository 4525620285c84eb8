"""Roofline terms of a step, counted by running it (PyTorch port of
``repro.launch.roofline``).

Three terms a step, in seconds, per card (a sharded step computes on its
rank's shards, so what one rank runs is one card's work):

  compute    = FLOPs per card / 989e12              [bf16 dense peak]
  memory     = ~HBM bytes per card / 3.35e12        [HBM3 rate]
  collective = collective bytes per card / link rate

``HW`` holds an NVIDIA H100 SXM5 80GB at 700 W.  Compute and memory are
the NVIDIA H100 Tensor Core GPU datasheet's figures (989 TFLOP/s bf16
dense, 3.35 TB/s HBM3).  A mesh within one 8-card node talks over NVLink
4: 900 GB/s a card both ways, 450 GB/s a direction (datasheet).  A mesh
across nodes is held to one 400 Gb/s NDR InfiniBand port a GPU, 50 GB/s,
as a DGX H100 wires its eight ConnectX-7 ports (DGX H100 user guide); the
production meshes (256 and 512 cards) take this figure.

The reference walks XLA's optimized HLO; eager PyTorch has no such
program, so :func:`analyze_step` runs the step once under dispatch modes
(on ``meta`` tensors in the dry-run: shapes, no numbers) and counts what
reaches them:

  * FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` (2 x the
    multiply-adds of every product, as the reference's dot count);
  * HBM bytes: 2x the output bytes of every aten op that is neither a view
    nor a metadata or allocation op (written once, read once), the
    counterpart of the reference's "2x result bytes of non-fusion
    instructions".  Eager PyTorch fuses nothing, so each elementwise
    intermediate is counted: an upper bound.  An in-place write into a
    slice or at an index (``index_copy_``, ``index_put_``, ...) counts the
    update's bytes, not the buffer's, as the reference counts a
    dynamic-update-slice, so a decode step does not count its whole cache
    as written;
  * collective bytes by kind: the ``c10d`` ops (result bytes; 2x for
    all-reduce, its reduce-scatter and all-gather phases), which a fake
    process group lets run at any world size;
  * ``max_loop_mult`` is 1: eager runs every iteration of every loop.

The analytic MODEL_FLOPS = 6*N*D cross-check is recorded alongside.
"""

from __future__ import annotations

import dataclasses
import weakref
from collections import defaultdict
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

HW = {
    "peak_flops": 989e12,      # bf16 dense, per card (H100 SXM5)
    "hbm_Bps": 3.35e12,        # HBM3
    "nvlink_Bps": 450e9,       # NVLink 4, one direction, within a node
    "node_link_Bps": 50e9,     # one 400 Gb/s NDR InfiniBand port a GPU, across nodes
    "cards_per_node": 8,
}

#: c10d op -> the reference's collective kind (all-gather, all-reduce,
#: reduce-scatter, all-to-all, collective-permute)
_C10D_KINDS = {
    "_allgather_base_": "all-gather", "allgather_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "_reduce_scatter_base_": "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}

#: allocations, metadata and the views whose schema does not say so
#: (``_unsafe_view``: a reshape's result): no memory traffic
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
               "detach", "lift_fresh", "set_", "resize_", "_local_scalar_dense",
               "_unsafe_view"}

#: in-place writes at an index or into a slice: the traffic is the update
_UPDATES = {"index_copy_", "index_put_", "_index_put_impl_", "scatter_", "scatter_add_",
            "scatter_reduce_", "index_add_", "masked_scatter_", "index_fill_"}


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def tensor_bytes(tree) -> int:
    """Bytes of every tensor in ``tree`` (a DTensor counts its local shard)."""
    total = 0
    for t in _tensors(tree):
        t = t.to_local() if hasattr(t, "to_local") else t
        total += t.numel() * t.element_size()
    return total


@dataclasses.dataclass
class StepAnalysis:
    flops_per_chip: float
    hbm_bytes_per_chip: float
    collective_bytes_per_chip: float
    collectives: dict[str, float]
    collective_counts: dict[str, int]
    max_loop_mult: int
    top_hbm: list[tuple[str, float]] = dataclasses.field(default_factory=list)
    top_coll: list[tuple[str, float]] = dataclasses.field(default_factory=list)
    #: the step's output bytes (local shards), and the most bytes of storage
    #: alive at once while it ran, its arguments' included
    output_bytes: int = 0
    peak_bytes: int = 0


class _Counter(TorchDispatchMode):
    """HBM bytes, collective bytes and live storage of every op that runs."""

    def __init__(self, live_from: int):
        super().__init__()
        self.hbm = 0.0
        self.hbm_by_op: dict[str, float] = defaultdict(float)
        self.coll: dict[str, float] = defaultdict(float)
        self.coll_counts: dict[str, int] = defaultdict(int)
        self.coll_by_op: dict[str, float] = defaultdict(float)
        self.live = self.peak = live_from
        self._known: set[int] = set()

    def know(self, tensors) -> None:
        """Storages that are live already (the arguments): not counted again."""
        for t in _tensors(tensors):
            t = t.to_local() if hasattr(t, "to_local") else t
            self._known.add(t.untyped_storage()._cdata)

    def _track(self, out) -> None:
        for t in _tensors(out):
            storage = t.untyped_storage()
            key = storage._cdata
            if key in self._known:
                continue
            self._known.add(key)
            nbytes = storage.nbytes()
            self.live += nbytes
            self.peak = max(self.peak, self.live)
            weakref.finalize(storage, self._free, key, nbytes)

    def _free(self, key: int, nbytes: int) -> None:
        self._known.discard(key)
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._schema.name.split("::")[-1]
        if func.namespace == "c10d":
            kind = _C10D_KINDS.get(name, name)
            nbytes = tensor_bytes(args[0]) * (2.0 if kind == "all-reduce" else 1.0)
            self.coll[kind] += nbytes
            self.coll_counts[kind] += 1
            self.coll_by_op[f"{kind}:{name}"] += nbytes
            return out
        self._track(out)
        if func.is_view or name in _NO_TRAFFIC:
            return out
        if name in _UPDATES:
            # the update is the last tensor argument (source, values, src)
            nbytes = 2.0 * tensor_bytes(_tensors((args[1:], kwargs))[-1:])
        else:
            nbytes = 2.0 * tensor_bytes(out)
        self.hbm += nbytes
        if nbytes:
            self.hbm_by_op[name] += nbytes
        return out


def analyze_step(fn: Callable, *args: Any) -> StepAnalysis:
    """Run ``fn(*args)`` once, counting its FLOPs, HBM bytes, collectives
    and live storage (see the module's docstring)."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = _Counter(tensor_bytes(args))
    counter.know(args)
    flop_counter = FlopCounterMode(display=False)
    with flop_counter, counter:
        out = fn(*args)
    top = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:15]  # noqa: E731
    return StepAnalysis(
        flops_per_chip=float(flop_counter.get_total_flops()),
        hbm_bytes_per_chip=counter.hbm,
        collective_bytes_per_chip=sum(counter.coll.values()),
        collectives=dict(counter.coll),
        collective_counts=dict(counter.coll_counts),
        max_loop_mult=1,
        top_hbm=top(counter.hbm_by_op),
        top_coll=top(counter.coll_by_op),
        output_bytes=tensor_bytes(out),
        peak_bytes=counter.peak,
    )


@dataclasses.dataclass
class Roofline:
    flops_per_chip: float
    hbm_bytes: float              # per chip
    collective_bytes: float       # per chip
    chips: int
    model_flops: float            # analytic, whole job per step
    collectives: dict[str, float]

    @property
    def link_Bps(self) -> float:
        """NVLink within a node, the InfiniBand port a card across nodes."""
        within = self.chips <= HW["cards_per_node"]
        return HW["nvlink_Bps"] if within else HW["node_link_Bps"]

    @property
    def t_compute(self) -> float:
        return self.flops_per_chip / HW["peak_flops"]

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HW["hbm_Bps"]

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / self.link_Bps

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def useful_flop_ratio(self) -> float:
        total = self.flops_per_chip * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """MODEL_FLOPS at peak vs. the achievable step time (max term)."""
        t_ideal = self.model_flops / (self.chips * HW["peak_flops"])
        t_bound = max(self.t_compute, self.t_memory, self.t_collective)
        return t_ideal / t_bound if t_bound else 0.0

    def summary(self) -> dict:
        return {
            "flops_per_chip": self.flops_per_chip,
            "hbm_bytes_per_chip": self.hbm_bytes,
            "collective_bytes_per_chip": self.collective_bytes,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_flop_ratio": self.useful_flop_ratio,
            "roofline_fraction": self.roofline_fraction,
            "collectives": self.collectives,
        }


def model_flops_for_cell(arch, shape) -> float:
    """Analytic MODEL_FLOPS per step: 6*N*D train (N=active for MoE),
    2*N*D prefill, 2*N per token decode (x batch)."""
    n_active = arch.model.active_param_count()
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch
