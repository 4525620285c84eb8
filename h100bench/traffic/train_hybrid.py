"""Training traffic of a NemotronH configuration (Mamba-2, MoE and attention
blocks in one stack): ``train.py``'s closed loop of whole train steps
through the program's ``launch.steps.make_train_step``, on uniform token
rows, with the program's routing checked besides.

What differs from ``train_moe.py``'s cell (whose window, ranges and route
comparison this one reuses):

* the configuration's published keys map to the program's ``ModelConfig``
  here (:func:`model_config`): the block pattern's first
  ``num_hidden_layers`` letters, the published Mamba-2 mixer (the
  convolution, the gated group norm, d_inner from heads x head dim), the
  sigmoid router with its correction bias, relu^2 experts and the shared
  one, NoPE attention, and the chip's share of the experts
  (``expert_parallel``: the router scores all ``n_routed_experts``, this
  chip holds ``n_routed_experts`` / ``chips`` of them, from ``rank`` times
  that on); a published value the program does not compute raises;
* weights: as ``train.py`` draws them, but A_log, dt_bias, D and the
  convolution as Mamba-2's init draws them, and the correction bias
  (``score_bias``) a seeded normal times :data:`BIAS_SCALE`;
* token ids uniform over the vocabulary (``train.token_rows``);
* the reference is ``reference/nemotron_h_ref.py`` (fp32; in fp8 as the
  control); the numbers compared are ``train.py``'s and
  ``route_flip_share`` over the MoE blocks;
* the traced run's ranges add ``mamba`` (the mixer's forward and
  recomputation) and ``ssd_scan`` (the scan, both directions) to
  ``train_moe.py``'s, and the work counts the scan's FLOPs
  (``work_hybrid``).
"""

from __future__ import annotations

import math

import harness
import work_hybrid

train = harness.load_file(harness.HERE / "traffic" / "train.py", "h100bench_traffic_train")
train_moe = harness.load_file(harness.HERE / "traffic" / "train_moe.py",
                              "h100bench_traffic_train_moe")

LABELS = train_moe.LABELS + ("mamba", "ssd_scan")
#: the correction bias's scale: a seeded normal times this.  Trained values
#: are not published with the config, and a trained bias evens out the
#: experts' load; at 0.05 (a quarter of the sigmoid scores' spread) the
#: bias alone loaded the busiest expert 5.9x the mean, so it is kept small
#: beside the scores: it moves choices near a tie, and zeros would move none
BIAS_SCALE = 0.01

#: published keys the program computes only at these values
FIXED = {"model_type": "nemotron_h", "mamba_hidden_act": "silu", "mlp_hidden_act": "relu2",
         "n_group": 1, "topk_group": 1, "attention_bias": False, "mlp_bias": False,
         "use_bias": False, "mamba_proj_bias": False, "use_conv_bias": True,
         "tie_word_embeddings": False, "residual_in_fp32": False, "sliding_window": None,
         "moe_latent_size": None, "num_nextn_predict_layers": 0}


def model_config(c: dict, remat: bool):
    """The program's ``ModelConfig`` for a NemotronH configuration's
    published keys; a key at a value the program does not compute raises."""
    from repro_torch.models.model import ModelConfig

    for key, value in FIXED.items():
        if c.get(key, value) != value:
            raise NotImplementedError(f"{key} = {c[key]!r}: the program computes {value!r}")
    if c["layer_norm_epsilon"] != c["norm_eps"]:
        raise NotImplementedError("layer_norm_epsilon and norm_eps differ: the program takes "
                                  "one epsilon for every norm")
    ep = c.get("expert_parallel", {"chips": 1, "rank": 0})
    if c["n_routed_experts"] % ep["chips"]:
        raise NotImplementedError(f"{c['n_routed_experts']} experts over {ep['chips']} chips: "
                                  "the program holds an equal share on each")
    held = c["n_routed_experts"] // ep["chips"]
    return ModelConfig(
        name=c["model_type"], family="pattern", n_layers=c["num_hidden_layers"],
        d_model=c["hidden_size"], n_heads=c["num_attention_heads"],
        n_kv_heads=c["num_key_value_heads"], d_ff=c["intermediate_size"],
        vocab=c["vocab_size"], head_dim=c["head_dim"], norm_eps=c["layer_norm_epsilon"],
        remat=remat,
        # NemotronH's attention applies no rotary embedding: rope_theta goes unused
        rope_theta=0.0,
        block_pattern=c["hybrid_override_pattern"][:c["num_hidden_layers"]],
        ssm_state=c["ssm_state_size"], ssm_heads=c["mamba_num_heads"],
        ssm_head_dim=c["mamba_head_dim"], ssm_groups=c["n_groups"], ssm_chunk=c["chunk_size"],
        ssm_conv=c["conv_kernel"],
        moe_experts=held, moe_top_k=c["num_experts_per_tok"], moe_shared=c["n_shared_experts"],
        moe_d_ff=c["moe_intermediate_size"],
        moe_d_ff_shared=c["moe_shared_expert_intermediate_size"], moe_dropless=True,
        moe_norm_topk=c["norm_topk_prob"], moe_score="sigmoid",
        moe_scaling=float(c["routed_scaling_factor"]), moe_act="relu2",
        moe_router_experts=c["n_routed_experts"], moe_expert_first=held * ep["rank"],
        **c.get("port_options", {}))


def compare(program: dict, reference: dict) -> dict:
    """``train.compare``'s numbers and ``route_flip_share``; besides, not
    compared: the first gradient's global norm's relative gap."""
    out = train.compare(program, reference)
    out["_grad_norm_gap"] = (program["grad_norm"] - reference["grad_norm"]) / (
        reference["grad_norm"])
    out["route_flip_share"], out["_route_flips_by_layer"] = train_moe.route_flips(
        program["routes"], reference["routes"])
    return out


class Cell(train_moe.Cell):
    """One run of a NemotronH training cell: ``setup``, ``window``,
    ``release``, ``check``."""

    def __init__(self, harness, config: dict, mix: dict, seed: int, device, chips: int = 1):
        train.Cell.__init__(self, harness, config, mix, seed, device, chips)

    def weight(self, index: int, path: str, shape: tuple):
        """``train.py``'s seeded weight, but Mamba-2's init for A_log (log of
        a uniform draw in [1, 16]), dt_bias (the inverse softplus of a
        log-uniform dt in [time_step_min, time_step_max], floored at
        time_step_floor), D (ones) and the convolution (uniform within
        1/sqrt(kernel), ``nn.Conv1d``'s), and the correction bias."""
        import torch

        last = path.rsplit("/", 1)[-1]
        if last not in ("A_log", "dt_bias", "D", "conv_w", "conv_b", "score_bias"):
            return super().weight(index, path, shape)
        if last == "D":
            return torch.ones(shape, dtype=torch.float32, device=self.dev)
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(self.h.leaf_seed(self.seed, index))
        if last == "score_bias":
            return torch.randn(shape, generator=gen, device=self.dev) * BIAS_SCALE
        u = torch.rand(shape, generator=gen, device=self.dev)
        if last == "A_log":
            return torch.log(1 + 15 * u)
        if last == "dt_bias":
            lo, hi = math.log(self.c["time_step_min"]), math.log(self.c["time_step_max"])
            dt = torch.exp(lo + u * (hi - lo)).clamp_min(self.c["time_step_floor"])
            return dt + torch.log(-torch.expm1(-dt))
        return (2 * u - 1) / math.sqrt(self.c["conv_kernel"])

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
        moe_blocks = cfg.block_pattern.count("E")
        routes = []
        route = moe.route

        def recording(*args, **kwargs):
            out = route(*args, **kwargs)
            if len(routes) < moe_blocks:                              # not the recomputes
                routes.append(train_moe._sorted_ids(out[1]))
            return out

        losses = []
        for i in range(self.checked):
            tokens, labels = self.rows(i)
            moe.route = recording if i == 0 else route
            try:
                self.params, self.opt, metrics = self.step(
                    self.params, self.opt, {"tokens": tokens, "labels": labels})
            finally:
                moe.route = route
            losses.append(float(metrics["loss"]))
            if i == 0:
                self.readings["grad"] = self._norms(self.opt["m"], 1.0 / (1.0 - train.B1))
                self.readings["grad_norm"] = float(metrics["grad_norm"])
        self.steps_done = self.checked
        self.readings.update(losses=losses, routes=routes, delta=self._delta())

    def trace_labels(self) -> tuple[str, ...]:
        return LABELS

    def instrument(self) -> None:
        """``train_moe.py``'s ranges, and ``mamba`` around the Mamba-2 mixer,
        ``ssd_scan`` around the scan's Function (forward and backward)."""
        from repro_torch.models import mamba2

        super().instrument()
        trace = self.h.tracing
        trace.wrap(mamba2, "mamba2_apply", "mamba")
        trace.wrap(mamba2._SSDScan, "forward", "ssd_scan", static=True)
        trace.wrap(mamba2._SSDScan, "backward", "ssd_scan", static=True)

    def work(self) -> dict:
        """What the per-layer readers divide by: the configuration's FLOPs,
        the held experts' and the scan's, and the busiest expert's choices
        over the mean, a routing call at a time, over all the router's
        experts (``moe.ROUTED``)."""
        from repro_torch.models import moe

        c, b, s = self.c, self.batch, self.seq
        out = {"steps": self.window_steps,
               "flops_per_step": work_hybrid.train_flops(c, b, s),
               "expert_flops_per_step": work_hybrid.expert_flops(c, b, s),
               "ssd_flops_per_step": work_hybrid.ssd_flops(c, b, s)}
        routed = getattr(moe, "ROUTED", None)
        if routed is not None and routed.calls:
            out["moe_load_max"] = (float(routed.peak) * work_hybrid.router_experts(c)
                                   / float(routed.counts.sum()))
        return out

    # -- the check -----------------------------------------------------------------------

    def reference(self, control: bool = False) -> dict:
        import nemotron_h_ref as ref
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
