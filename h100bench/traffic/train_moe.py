"""Training traffic of a DeepSeek-V2 configuration: ``train.py``'s closed
loop of whole train steps through the program's
``launch.steps.make_train_step``, on token rows drawn from a Zipf law, with
the program's routing, balance term and experts checked besides.

What differs from ``train.py``'s cell (whose loop, norms and check this
one reuses):

* the configuration's published keys map to the program's ``ModelConfig``
  here (:func:`model_config`): MLA with the latent's norm and YaRN, the
  leading dense layer, routed and shared experts, top-k weights left as
  published, the sequence-wise balance term, dropless routing;
* token ids: rank r of the vocabulary drawn with probability proportional
  to 1 / r**``zipf_exponent`` (the unigram law of text), ranks mapped to ids
  by a seeded permutation, so that routing is uneven (on the seeded
  weights more so than a trained model's: ``routing_load.py``);
* the reference is ``reference/dsv2_ref.py`` (fp32; in fp8 as the control);
* numbers compared besides ``train.py``'s: ``aux_gap``, the root mean
  square of the balance terms' relative gaps over the checked steps, each
  expert layer's (as the program's ``route`` returns it) and their sum (the
  step's ``aux_loss``), and ``route_flip_share``, the share of
  step 0's (token, choice) pairs whose expert is not among the reference's
  choices for that token, over every expert layer;
* the traced run's ranges add ``experts`` (the grouped expert products,
  both directions) and ``moe`` (the MoE layer's forward and recomputation)
  to ``train.py``'s, and the work counts the routed experts' FLOPs and
  the busiest expert's load from the program's ``moe.ROUTED``.
"""

from __future__ import annotations

import statistics

import numpy as np

import harness
import work_moe

train = harness.load_file(harness.HERE / "traffic" / "train.py", "h100bench_traffic_train")

LABELS = train.LABELS + ("experts", "moe")

#: published keys the program computes only at these values
FIXED = {"scoring_func": "softmax", "topk_method": "greedy", "n_group": 1, "topk_group": 1,
         "routed_scaling_factor": 1, "moe_layer_freq": 1, "q_lora_rank": None,
         "attention_bias": False, "hidden_act": "silu", "tie_word_embeddings": False}


def zipf_rows(seed: int, pool: int, batch: int, seq: int, vocab: int,
              exponent: float) -> np.ndarray:
    """``pool`` batches of ``batch`` rows of ``seq + 1`` token ids drawn
    from the seed: rank r with probability proportional to 1 / r**exponent,
    rank r read as id ``perm[r - 1]`` of a seeded permutation."""
    rng = np.random.default_rng(seed)
    ids = rng.permutation(vocab)
    cdf = np.cumsum(1.0 / np.arange(1, vocab + 1, dtype=np.float64) ** exponent)
    cdf /= cdf[-1]
    ranks = np.searchsorted(cdf, rng.random((pool, batch, seq + 1)), side="right")
    return ids[np.minimum(ranks, vocab - 1)].astype(np.int32)


def model_config(c: dict, remat: bool):
    """The program's ``ModelConfig`` for a DeepSeek-V2 configuration's
    published keys; a key at a value the program does not compute raises."""
    from repro_torch.models.layers import Yarn
    from repro_torch.models.model import ModelConfig

    for key, value in FIXED.items():
        if c.get(key, value) != value:
            raise NotImplementedError(f"{key} = {c[key]!r}: the program computes {value!r}")
    if not c["seq_aux"] and c["aux_loss_alpha"]:
        raise NotImplementedError("a batch-wise balance term (seq_aux false)")
    y = c["rope_scaling"]
    if y["type"] != "yarn" or y["mscale"] != y["mscale_all_dim"]:
        raise NotImplementedError(f"rope_scaling {y}: the program computes YaRN with "
                                  "mscale equal to mscale_all_dim (cos and sin unscaled)")
    yarn = Yarn(factor=float(y["factor"]),
                original_max_position=y["original_max_position_embeddings"],
                beta_fast=float(y["beta_fast"]), beta_slow=float(y["beta_slow"]),
                mscale_all_dim=float(y["mscale_all_dim"]))
    return ModelConfig(
        name=c["model_type"], family="moe", n_layers=c["num_hidden_layers"],
        d_model=c["hidden_size"], n_heads=c["num_attention_heads"],
        n_kv_heads=c["num_key_value_heads"], d_ff=c["intermediate_size"],
        vocab=c["vocab_size"], rope_theta=float(c["rope_theta"]), norm_eps=c["rms_norm_eps"],
        remat=remat, moe_experts=c["n_routed_experts"], moe_top_k=c["num_experts_per_tok"],
        moe_shared=c["n_shared_experts"], moe_d_ff=c["moe_intermediate_size"],
        moe_dense_first_n=c["first_k_dense_replace"], mla_kv_lora=c["kv_lora_rank"],
        mla_qk_nope=c["qk_nope_head_dim"], mla_qk_rope=c["qk_rope_head_dim"],
        mla_v_head=c["v_head_dim"], mla_kv_norm=True, rope_yarn=yarn,
        moe_norm_topk=c["norm_topk_prob"], moe_aux_alpha=c["aux_loss_alpha"],
        moe_dropless=True, **c.get("port_options", {}))


def route_flips(program: list, reference: list) -> tuple[float, list[float]]:
    """The share of (token, choice) pairs, over all layers, whose expert is
    not among the reference's choices for that token; and each layer's."""
    per_layer, flipped, total = [], 0, 0
    for ours, theirs in zip(program, reference, strict=True):
        ours, theirs = np.asarray(ours), np.asarray(theirs)
        missing = int((~(ours[:, :, None] == theirs[:, None, :]).any(-1)).sum())
        per_layer.append(missing / ours.size)
        flipped, total = flipped + missing, total + ours.size
    return flipped / total, per_layer


def unclipped_median_gap(program: dict, reference: dict) -> float:
    """The median leaf's gap of the first gradient before the global clip:
    each side's clipped leaf norms times its own clip's inverse."""
    scale_p, scale_r = max(program["grad_norm"], 1.0), max(reference["grad_norm"], 1.0)
    grads = {k: g * scale_r for k, g in reference["grad"].items()}
    median = statistics.median(grads.values())
    kept = [k for k, g in grads.items() if g >= train.QUIET_LEAF * median]
    ours = {k: g * scale_p for k, g in program["grad"].items()}
    return statistics.median(train.leaf_gaps(ours, grads, kept).values())


def aux_gaps(program: dict, reference: dict) -> tuple[float, list[float]]:
    """The root mean square of the balance terms' relative gaps, each
    checked step's each layer's (the program's ``route``) and each step's
    sum over layers (the step's ``aux_loss``); and the sums' gaps alone."""
    def gap(p, r):
        return abs(p - r) / abs(r)

    sums = [gap(p, r) for p, r in zip(program["aux"], reference["aux"], strict=True)]
    layers = [gap(p, r) for ours, theirs in zip(program["aux_layers"], reference["aux_layers"],
                                                strict=True)
              for p, r in zip(ours, theirs, strict=True)]
    every = sums + layers
    return (sum(g * g for g in every) / len(every)) ** 0.5, sums


def compare(program: dict, reference: dict) -> dict:
    """``train.compare``'s numbers, with ``aux_gap`` and ``route_flip_share``;
    besides, not compared: each step's balance-term gap, the first
    gradient's global norm's relative gap, and the median leaf's gap before
    the clip."""
    out = train.compare(program, reference)
    out["aux_gap"], out["_aux_sum_gaps"] = aux_gaps(program, reference)
    if "grad_norm" in program and "grad_norm" in reference:
        out["_grad_norm_gap"] = (program["grad_norm"] - reference["grad_norm"]) / (
            reference["grad_norm"])
        out["_grad_gap_median_leaf_unclipped"] = unclipped_median_gap(program, reference)
    out["route_flip_share"], out["_route_flips_by_layer"] = route_flips(program["routes"],
                                                                        reference["routes"])
    return out


def _sorted_ids(ids):
    """A (T, K) tensor of expert ids, sorted per token, on the host."""
    import torch

    return torch.sort(ids.detach(), dim=-1).values.cpu().numpy()


class Cell(train.Cell):
    """One run of a DeepSeek-V2 training cell: ``setup``, ``window``,
    ``release``, ``check``."""

    def __init__(self, harness, config: dict, mix: dict, seed: int, device, chips: int = 1):
        self.h, self.c, self.mix, self.seed, self.dev = harness, config, mix, seed, device
        self.batch, self.seq = mix["batch"], mix["seq"]
        self.checked = mix["checked_steps"]
        self.tokens = zipf_rows(seed, mix["pool"], self.batch, self.seq, config["vocab_size"],
                                mix["zipf_exponent"])
        self.readings: dict = {}
        self.steps_done = 0

    def setup(self) -> None:
        from repro_torch.configs.base import ArchConfig, ShapeConfig
        from repro_torch.launch import steps
        from repro_torch.models import moe
        from repro_torch.optim.adamw import init_opt_state

        cfg = model_config(self.c, remat=self.mix["remat"])
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
        expert_layers = cfg.n_layers - cfg.moe_dense_first_n
        routes, aux_layers = [], []
        route = moe.route

        def recording(*args, **kwargs):
            out = route(*args, **kwargs)
            if len(aux_layers[-1]) < expert_layers:                  # not the recomputes
                aux_layers[-1].append(float(out[2].detach()))
                if len(aux_layers) == 1:
                    routes.append(_sorted_ids(out[1]))
            return out

        losses, auxes = [], []
        for i in range(self.checked):
            tokens, labels = self.rows(i)
            aux_layers.append([])
            moe.route = recording
            try:
                self.params, self.opt, metrics = self.step(
                    self.params, self.opt, {"tokens": tokens, "labels": labels})
            finally:
                moe.route = route
            losses.append(float(metrics["loss"]))
            auxes.append(float(metrics["aux_loss"]))
            if i == 0:
                self.readings["grad"] = self._norms(self.opt["m"], 1.0 / (1.0 - train.B1))
                self.readings["grad_norm"] = float(metrics["grad_norm"])
        self.steps_done = self.checked
        self.readings.update(losses=losses, aux=auxes, aux_layers=aux_layers, routes=routes,
                             delta=self._delta())

    def window(self, seconds: float) -> dict:
        from repro_torch.models import moe

        moe.ROUTED.reset()
        return super().window(seconds)

    def trace_labels(self) -> tuple[str, ...]:
        return LABELS

    def instrument(self) -> None:
        """``train.py``'s ranges, and ``experts`` around the grouped expert
        products (forward and backward), ``moe`` around the MoE layer."""
        from repro_torch.models import moe

        super().instrument()
        trace = self.h.tracing
        trace.wrap(moe._GroupedExperts, "forward", "experts", static=True)
        trace.wrap(moe._GroupedExperts, "backward", "experts", static=True)
        trace.wrap(moe, "moe_apply", "moe")

    def work(self) -> dict:
        """What the per-layer readers divide by: the configuration's FLOPs,
        and the busiest expert's choices over the mean, a routing call at a
        time (``moe.ROUTED``, where the program keeps it)."""
        from repro_torch.models import moe

        out = {"steps": self.window_steps,
               "flops_per_step": work_moe.train_flops(self.c, self.batch, self.seq),
               "expert_flops_per_step": work_moe.expert_flops(self.c, self.batch, self.seq)}
        routed = getattr(moe, "ROUTED", None)
        if routed is not None and routed.calls:
            out["moe_load_max"] = (float(routed.peak) * self.c["n_routed_experts"]
                                   / float(routed.counts.sum()))
        return out

    # -- the check -----------------------------------------------------------------------

    def reference(self, control: bool = False) -> dict:
        import dsv2_ref as ref
        import torch

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
        out["routes"] = [r.cpu().numpy() for r in out["routes"]]
        del params
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        return out

    def check(self) -> dict:
        return compare(self.readings, self.reference())

