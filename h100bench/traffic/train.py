"""Training traffic: a closed loop of whole train steps (forward, backward,
AdamW) through the program's ``launch.steps.make_train_step``, on seeded
token rows, each step's rows new.

Set-up makes the weights on the card from the seed (one seeded normal a
tensor, fp32), the moments as the program's zeros, and drives the step
object through the mix's first ``checked_steps`` steps: they warm up every
shape the window uses and give the readings that the check compares.  The
window then runs that same object on the following rows until its time is
up.  After the window, with the program's state freed, the plain reference
(``reference/train_ref.py``) takes the same weights and rows again from the
seed and follows the first steps.

Numbers compared (each against the limit in ``limits/<cell>.json``):

* ``loss_gap``: the largest relative gap of a checked step's loss;
* ``grad_gap``: the worst leaf's gap between the program's and the
  reference's norm of the first gradient as the optimizer takes it (the
  program's worked out from its first moment after one step, m / (1 - b1)),
  over the larger of the reference leaf's norm and the median leaf's;
* ``delta_gap``: the same for the norm of each leaf's change over the
  checked steps;
* ``grad_gap_median_leaf``, ``delta_gap_median_leaf``: the median leaf's
  gaps, steady where a few leaves swing.

A cell's limits file says which of them it compares.

A stack's layers count as leaves of their own.  A leaf whose reference
gradient is under a thousandth of the median leaf's is left out of both
(its moves are round-off under Adam).
"""

from __future__ import annotations

import statistics
import time

import numpy as np

import port_config

B1 = 0.9
#: leaves whose reference gradient norm is under this share of the median
#: leaf's are left out of the comparison
QUIET_LEAF = 1e-3
#: the ranges the traced run records, around the program's functions
LABELS = ("attention", "adamw", "loss")


def token_rows(seed: int, pool: int, batch: int, seq: int, vocab: int) -> np.ndarray:
    """``pool`` batches of ``batch`` rows of ``seq + 1`` token ids, drawn
    from the seed: step i takes batch i mod ``pool``."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (pool, batch, seq + 1), dtype=np.int64).astype(np.int32)


def leaf_items(tree: dict):
    """(name, tensor) of every leaf of a {path: tensor} dict, a stack's
    layers each a leaf of its own."""
    for path, t in tree.items():
        if path.startswith("layers/"):
            for i in range(t.shape[0]):
                yield f"{path}#{i}", t[i]
        else:
            yield path, t


def leaf_gaps(program: dict, reference: dict, kept: list[str]) -> dict[str, float]:
    """Each leaf's |program - reference| norm gap over the larger of the
    reference leaf's norm and the median leaf's."""
    median = statistics.median(reference[k] for k in kept)
    return {k: abs(program[k] - reference[k]) / max(reference[k], median) for k in kept}


def compare(program: dict, reference: dict) -> dict:
    """The numbers compared, from both sides' readings."""
    grads = reference["grad"]
    median = statistics.median(grads.values())
    kept = [k for k, g in grads.items() if g >= QUIET_LEAF * median]
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(program["losses"], reference["losses"]))
    out = {"loss_gap": loss_gap}
    for name in ("grad", "delta"):
        gaps = leaf_gaps(program[name], reference[name], kept)
        worst = max(gaps, key=gaps.get)
        out[f"{name}_gap"] = gaps[worst]
        out[f"{name}_gap_median_leaf"] = statistics.median(gaps.values())
        out[f"_{name}_at"] = worst
    out["_left_out"] = len(grads) - len(kept)
    return out


class Cell:
    """One run of a training cell: ``setup``, ``window``, ``release``, ``check``."""

    def __init__(self, harness, config: dict, mix: dict, seed: int, device, chips: int = 1):
        self.h, self.c, self.mix, self.seed, self.dev = harness, config, mix, seed, device
        self.batch, self.seq = mix["batch"], mix["seq"]
        self.checked = mix["checked_steps"]
        self.tokens = token_rows(seed, mix["pool"], self.batch, self.seq, config["vocab_size"])
        self.readings: dict = {}
        self.steps_done = 0

    # -- inputs --------------------------------------------------------------------------

    def rows(self, i: int):
        import torch

        rows = torch.from_numpy(self.tokens[i % len(self.tokens)]).to(self.dev)
        return rows[:, :-1], rows[:, 1:]

    def weight(self, index: int, path: str, shape: tuple):
        return self.h.seeded_leaf(self.seed, index, path, shape, self.dev)

    # -- the program ---------------------------------------------------------------------

    def setup(self) -> None:
        from repro_torch.configs.base import ArchConfig, ShapeConfig
        from repro_torch.launch import steps
        from repro_torch.optim.adamw import init_opt_state

        cfg = port_config.model_config(self.c, remat=self.mix["remat"])
        arch = ArchConfig(model=cfg, smoke=cfg)
        shape = ShapeConfig("cell", "train", self.seq, self.batch)
        struct = steps.params_struct(arch)
        self.order = {}

        def fill(index, path, leaf):
            self.order[path] = (index, tuple(leaf.shape))
            return self.weight(index, path, tuple(leaf.shape))

        self.params = self.h.build_tree(struct, fill)
        self.opt = init_opt_state(self.params)
        self.step = steps.make_train_step(arch, shape)
        losses = []
        for i in range(self.checked):
            tokens, labels = self.rows(i)
            self.params, self.opt, metrics = self.step(self.params, self.opt,
                                                       {"tokens": tokens, "labels": labels})
            losses.append(float(metrics["loss"]))
            if i == 0:
                self.readings["grad"] = self._norms(self.opt["m"], 1.0 / (1.0 - B1))
        self.steps_done = self.checked
        self.readings["losses"] = losses
        self.readings["delta"] = self._delta()

    def _flat(self, tree) -> dict:
        return {path: leaf for path, leaf in self.h.tree_paths(tree)}

    def _norms(self, tree, scale: float) -> dict:
        return {k: float(t.double().norm()) * scale for k, t in leaf_items(self._flat(tree))}

    def _delta(self) -> dict:
        out = {}
        for path, leaf in self._flat(self.params).items():
            index, shape = self.order[path]
            diff = leaf.detach().float() - self.weight(index, path, shape)
            out.update({k: float(t.double().norm()) for k, t in leaf_items({path: diff})})
            del diff
        return out

    def window(self, seconds: float) -> dict:
        """Steps back to back until ``seconds`` have passed; every step ends
        synchronised, so the window is all of the steps' time."""
        import torch

        sync = (lambda: torch.cuda.synchronize(self.dev)) if self.dev.type == "cuda" else (
            lambda: None)
        sync()
        start = time.perf_counter()
        done = 0
        while True:
            tokens, labels = self.rows(self.steps_done)
            self.params, self.opt, _ = self.step(self.params, self.opt,
                                                 {"tokens": tokens, "labels": labels})
            sync()
            self.steps_done += 1
            done += 1
            elapsed = time.perf_counter() - start
            if elapsed >= seconds:
                break
        self.window_steps = done
        return {"attempted": done, "failed": 0, "window_s": elapsed,
                "metrics": {"train_tokens_per_s": done * self.batch * self.seq / elapsed}}

    def trace_labels(self) -> tuple[str, ...]:
        return LABELS

    def instrument(self) -> None:
        """Ranges around the program's attention (forward and its
        recomputing backward), AdamW and the loss."""
        from repro_torch.launch import steps
        from repro_torch.models import attention, model

        trace = self.h.tracing
        fn = attention._BlockwiseAttention
        trace.wrap(fn, "forward", "attention", static=True)
        trace.wrap(fn, "backward", "attention", static=True)
        trace.wrap(steps, "adamw_update", "adamw")
        trace.wrap(model, "chunked_cross_entropy", "loss")

    def work(self) -> dict:
        """What the per-layer readers divide by, from the configuration."""
        w = self.h.work
        return {"steps": self.window_steps,
                "flops_per_step": w.train_flops(self.c, self.batch, self.seq)}

    def release(self) -> None:
        import torch

        self.params = self.opt = self.step = None
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
            torch.cuda.empty_cache()

    # -- the check --------------------------------------------------------------------------

    def reference(self, control: bool = False) -> dict:
        import torch
        import train_ref as ref

        shapes = ref.param_shapes(self.c)
        order = {path: (i, shapes[path]) for i, path in enumerate(ref.sorted_paths(shapes))}
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

        def initial(path):
            index, shape = order[path]
            return self.weight(index, path, shape)

        params = {path: initial(path) for path in order}
        batches = [self.rows(i) for i in range(self.checked)]
        out = ref.train(params, self.c, batches, self.checked, control=control, initial=initial)
        del params
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        return out

    def check(self) -> dict:
        return compare(self.readings, self.reference())
