"""Checkpoint traffic: a closed loop of cycles through the program's
checkpoint plane, over a training stage's state held on the card.  A cycle
saves one shard of that state with ``CheckpointManager.save`` (client-side
RS encode on the card, every cell written through the ``StorageCluster``'s
authenticated packet plane), takes down the nodes that hold the first
``failed_nodes`` data cells of the save's first object, restores the shard
through the degraded ``read_objects`` (a batched decode on the card) and
brings the nodes back with their data (a restart, not a rebuild).  The
shards come in turn: a layer's attention, then each of its three MLP
projections, then the next layer's, from a layer drawn from the seed, so
that every run saves the same sizes in the same order and the runs over
many seeds touch all of the state.

Set-up makes the state on the card from the seed (one seeded normal a stacked
tensor) and runs one whole cycle, which builds the kernels on a checkout's
first run and warms every shape.  A cycle that raises counts as failed.

Numbers compared (limit 0 each: the configuration's guarantees are exact),
over ``KEPT`` cycles drawn from the seed (set-up's among them), each
checked against its shard made again from the seed once the window has
closed:

* ``cells_wrong``: stored data and parity cells of the cycle's save that
  differ from the plain NumPy code's (``reference/rs_ref.py``) of the shard's
  bytes, and saves whose leaves do not match the shard's;
* ``restores_wrong``: leaves of the cycle's restore whose bytes differ from
  the shard saved (a restore that raised is a failed cycle instead);
* ``cycles_failed``: cycles that raised, set-up's included.
"""

from __future__ import annotations

import math
import time

import numpy as np

#: the ranges the traced run records
LABELS = ("save", "restore", "ec", "gf_matmul")
#: cycles whose save and restore the check compares, drawn from the seed
KEPT = 4
#: the shards of a layer, in the order they are saved: the tensors of each
PARTS = (("attn", ("wq", "wk", "wv", "wo")), ("gate", ("gate",)), ("up", ("up",)),
         ("down", ("down",)))
#: the leaf index of each tensor's seeds (weight, first moment, second moment)
TENSORS = ("wq", "wk", "wv", "wo", "gate", "up", "down")


def host_bytes(x) -> np.ndarray:
    """A tensor's bytes in C order, on the host."""
    import torch

    return x.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy()


def tensor_shapes(c: dict) -> dict[str, tuple[int, int]]:
    """A yi-9b layer's matrices, (d_in, d_out)."""
    w = c["state_widths"]
    d, ff = w["hidden_size"], w["intermediate_size"]
    h, hkv = w["num_attention_heads"], w["num_key_value_heads"]
    hd = d // h
    return {"wq": (d, h * hd), "wk": (d, hkv * hd), "wv": (d, hkv * hd), "wo": (h * hd, d),
            "gate": (d, ff), "up": (d, ff), "down": (ff, d)}


def stage_tensor(h, seed: int, c: dict, name: str, device) -> dict:
    """One matrix of every layer of the stage, stacked (layers, d_in, d_out),
    made on the card from the seed as the program trains it: fp32 weights at
    1/sqrt(fan-in), AdamW's fp32 first and second moments."""
    import torch

    shape = (c["stage_layers"], *tensor_shapes(c)[name])
    index = TENSORS.index(name)

    def normal(role, scale):
        gen = torch.Generator(device=device)
        gen.manual_seed(h.leaf_seed(seed, 3 * index + role))
        return torch.randn(shape, generator=gen, device=device).mul_(scale)

    return {"w": normal(0, 1.0 / math.sqrt(shape[1])), "mu": normal(1, 1e-3),
            "nu": normal(2, 1e-3).square_()}


def shard_state(stage: dict, layer: int, part: int, step) -> dict:
    """The tree one cycle saves: the part's weights and moments of one
    layer (views of the stage's tensors) and the optimizer's step."""
    names = PARTS[part][1]
    return {"params": {n: stage[n]["w"][layer] for n in names},
            "opt": {"mu": {n: stage[n]["mu"][layer] for n in names},
                    "nu": {n: stage[n]["nu"][layer] for n in names}},
            "step": step}


class Cell:
    def __init__(self, harness, config: dict, mix: dict, seed: int, device, chips: int = 1):
        self.h, self.c, self.mix, self.seed, self.dev = harness, config, mix, seed, device
        self.rng = np.random.default_rng(seed)
        self.first = len(PARTS) * int(self.rng.integers(0, config["stage_layers"]))
        self.kept: list[list] = []
        self.shard_bytes: dict[int, int] = {}
        self.cycles = 0
        self.failures: list[str] = []
        self.ec_s = 0.0
        self.gf_bytes = 0

    def shard_of(self, cycle: int) -> tuple[int, int]:
        """(layer, part) that cycle ``cycle`` saves."""
        j = (self.first + cycle) % (len(PARTS) * self.c["stage_layers"])
        return divmod(j, len(PARTS))

    def setup(self) -> None:
        import torch

        from repro_torch.checkpoint import CheckpointManager, CheckpointPolicy, StorageCluster

        c = self.c
        self.stage = {n: stage_tensor(self.h, self.seed, c, n, self.dev) for n in TENSORS}
        self.step = torch.tensor(self.seed % 100_000, dtype=torch.int64, device=self.dev)
        self.cluster = StorageCluster(num_nodes=c["nodes"], node_capacity=c["node_capacity_bytes"],
                                      device=self.dev)
        self.manager = CheckpointManager(self.cluster, CheckpointPolicy(
            k=c["data_units"], m=c["parity_units"], stripe_bytes=c["stripe_bytes"],
            encode="client"))
        self.cycle()

    def cycle(self) -> bool:
        """One cycle; False (its error kept) where it raised."""
        try:
            self._cycle()
            return True
        except (IOError, ValueError, RuntimeError, KeyError) as exc:
            self.failures.append(f"{type(exc).__name__}: {str(exc)[:200]}")
            return False

    def _cycle(self) -> None:
        """Save a shard, take nodes down, restore it degraded, bring them back."""
        from repro_torch.checkpoint.manager import flatten

        step = self.cycles
        self.cycles += 1
        tree = shard_state(self.stage, *self.shard_of(step), self.step)
        self.shard_bytes[step] = sum(x.numel() * x.element_size() for _, x in flatten(tree))
        self.manager.save(step, tree, blocking=True)
        kept = self.keep(step)
        manifest = self.manager._manifests[step]
        first = self.cluster.meta.lookup(manifest["leaves"][0]["stripes"][0]["oid"])
        down = sorted({first.data_coords[i].node for i in range(self.c["failed_nodes"])})
        for node in down:
            self.cluster.fail_node(node)
        try:
            got = self.manager.restore(step)
        finally:
            for node in down:
                self.cluster.failed.discard(node)
                self.cluster.router.heal(node)
        if kept is not None:
            kept[1] = got

    def keep(self, step: int) -> list | None:
        """A reservoir of the saves, drawn from the seed: the [step, restore]
        slot where this save is kept (its restore filled in once it is read
        back), else None."""
        if len(self.kept) < KEPT:
            self.kept.append([step, None])
            return self.kept[-1]
        j = int(self.rng.integers(0, self.cycles))
        if j >= KEPT:
            return None
        self.kept[j] = [step, None]
        return self.kept[j]

    def window(self, seconds: float) -> dict:
        """Cycles back to back until ``seconds`` have passed; the rate is the
        bytes saved and restored by the cycles that did not raise."""
        self.ec_s, self.gf_bytes = 0.0, 0
        start = time.perf_counter()
        done = failed = moved = 0
        while True:
            step = self.cycles
            ok = self.cycle()
            failed += not ok
            moved += 2 * self.shard_bytes[step] if ok else 0
            done += 1
            elapsed = time.perf_counter() - start
            if elapsed >= seconds:
                break
        self.window_cycles = done
        return {"attempted": done, "failed": failed, "window_s": elapsed,
                "metrics": {"ckpt_GBps": moved / elapsed / 1e9}}

    def trace_labels(self) -> tuple[str, ...]:
        return LABELS

    def instrument(self) -> None:
        """Ranges around save, restore, the erasure layer's batched encode
        and decode (their host time kept as the erasure layer's span), the
        GF(2^8) product, whose bytes are counted from its call's shapes, and
        the host's snapshot, cell writes and cell reads."""
        from repro_torch.checkpoint import manager, storage
        from repro_torch.core import erasure
        from repro_torch.kernels import ops

        trace, work = self.h.tracing, self.h.work
        trace.wrap(manager.CheckpointManager, "save", "save")
        trace.wrap(manager.CheckpointManager, "restore", "restore")
        # host spans that name the card's idle gaps
        trace.wrap(manager, "_snapshot", "snapshot")
        trace.wrap(storage.StorageCluster, "_write_bulk_shards", "write_cells")
        trace.wrap(storage.StorageCluster, "_read_shard", "read_cell")
        cell = self

        def timed(fn):
            def wrapper(*args, **kwargs):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    cell.ec_s += time.perf_counter() - t0
            return wrapper

        for name in ("encode_stripes", "decode_stripes"):
            setattr(erasure.RSCode, name, trace.ranged("ec", timed(getattr(erasure.RSCode, name))))
        inner = ops.gf_matmul_bytes_batched

        def counted(coeffs, data, *args, **kwargs):
            n, k = np.asarray(coeffs).shape
            s, _, length = data.shape
            cell.gf_bytes += work.gf_matmul_bytes(n, k, s, length)
            return inner(coeffs, data, *args, **kwargs)

        ops.gf_matmul_bytes_batched = trace.ranged("gf_matmul", counted)

    def work(self) -> dict:
        return {"cycles": self.window_cycles, "ec_s": self.ec_s, "gf_bytes": self.gf_bytes}

    def release(self) -> None:
        import torch

        self.stage = self.step = None
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
            torch.cuda.empty_cache()

    def reference_cells(self, saved: dict) -> dict:
        """leaf path -> [(data cells, parity cells)] of each stripe, from the
        plain code."""
        import rs_ref as rs

        k, m, stripe = self.c["data_units"], self.c["parity_units"], self.c["stripe_bytes"]
        out = {}
        for path, raw in saved.items():
            stripes = []
            for off in range(0, max(raw.size, 1), stripe):
                cells = rs.stripe_cells(raw[off:off + stripe], k)
                stripes.append((cells, rs.encode(cells, m)))
            out[path] = stripes
        return out

    def cells_wrong(self, manifest: dict, saved: dict) -> int:
        """Stored cells of one save that differ from the plain code's."""
        expected = self.reference_cells(saved)
        wrong = int(sorted(leaf["path"] for leaf in manifest["leaves"]) != sorted(saved))
        for leaf in manifest["leaves"]:
            want = expected.get(leaf["path"], [])
            wrong += len(leaf["stripes"]) != len(want)
            for stripe, (data, parity) in zip(leaf["stripes"], want):
                layout = self.cluster.meta.lookup(stripe["oid"])
                for coords, cells in ((layout.data_coords, data),
                                      (layout.parity_coords, parity)):
                    for coord, cell in zip(coords, cells):
                        mem = self.cluster.nodes[coord.node].storage.mem
                        wrong += not np.array_equal(mem[coord.addr:coord.addr + cell.size], cell)
        return wrong

    def check(self) -> dict:
        """The kept cycles against their shards, made again from the seed on
        the card once the program's state is freed."""
        import torch

        from repro_torch.checkpoint.manager import flatten, path_str

        step_t = torch.tensor(self.seed % 100_000, dtype=torch.int64, device=self.dev)
        stage: dict = {}
        wrong = restored = 0
        for step, got in sorted(self.kept, key=lambda kv: kv[0]):
            layer, part = self.shard_of(step)
            for name in PARTS[part][1]:
                if name not in stage:
                    stage[name] = stage_tensor(self.h, self.seed, self.c, name, self.dev)
            saved = {path_str(p): host_bytes(x) for p, x in
                     flatten(shard_state(stage, layer, part, step_t))}
            manifest = self.manager._manifests.get(step)
            wrong += 1 if manifest is None else self.cells_wrong(manifest, saved)
            if got is None:                 # the restore raised: a failed cycle
                continue
            for path, raw in saved.items():
                x = got.get(path)
                restored += not (x is not None and np.array_equal(host_bytes(x), raw))
        return {"cells_wrong": float(wrong), "restores_wrong": float(restored),
                "cycles_failed": float(len(self.failures)),
                "_saves": len(self.manager._manifests),
                "_kept": [[s, *self.shard_of(s)] for s, _ in self.kept],
                "_failures": self.failures[:3]}
