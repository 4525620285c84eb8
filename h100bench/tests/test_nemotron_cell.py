"""The NemotronH training cell (``nemotron3nano-train8k``) on the CPU: its
configuration against the catalog's numbers, the config mapping's
refusals, its yardstick against hand-worked values and the port's own
parameter count, the reference's layout against the program's tree, the
weights' draws, the new readers, and the cell driven at small widths
through ``traffic/train_hybrid.py`` against the plain reference, with the
fp8 control seen as not correct under the cell's own limits.

    python3 -m pytest -q h100bench/tests
"""

from __future__ import annotations

import math
import sys
from pathlib import Path

import numpy as np
import pytest

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

import harness as h  # noqa: E402
import run  # noqa: E402
import work_hybrid  # noqa: E402

h.port_path()
SPEC = h.load_spec()
CELL = "nemotron3nano-train8k"
SEED = 2**31 + 54321
#: NVIDIA-Nemotron-3-Nano-30B-A3B-BF16's config.json, as the catalog holds it
PUBLISHED = {
    "attention_bias": False, "chunk_size": 128, "conv_kernel": 4, "expand": 2, "head_dim": 128,
    "hidden_size": 2688,
    "hybrid_override_pattern": "MEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEMEM*EMEMEMEME",
    "intermediate_size": 1856, "layer_norm_epsilon": 1e-05, "mamba_head_dim": 64,
    "mamba_hidden_act": "silu", "mamba_num_heads": 64, "mamba_proj_bias": False,
    "max_position_embeddings": 262144, "mlp_bias": False, "mlp_hidden_act": "relu2",
    "model_type": "nemotron_h", "moe_intermediate_size": 1856,
    "moe_shared_expert_intermediate_size": 3712, "n_group": 1, "n_groups": 8,
    "n_routed_experts": 128, "n_shared_experts": 1, "norm_eps": 1e-05, "norm_topk_prob": True,
    "num_attention_heads": 32, "num_experts_per_tok": 6, "num_hidden_layers": 52,
    "num_key_value_heads": 2, "num_logits_to_keep": 1, "partial_rotary_factor": 1,
    "rescale_prenorm_residual": True, "residual_in_fp32": False, "rope_theta": 10000,
    "routed_scaling_factor": 2.5, "sliding_window": None, "ssm_state_size": 128,
    "tie_word_embeddings": False, "time_step_floor": 0.0001, "time_step_max": 0.1,
    "time_step_min": 0.001, "topk_group": 1, "use_bias": False, "use_conv_bias": True,
    "use_mamba_kernels": True, "vocab_size": 131072}
SMALL = {"hidden_size": 64, "mamba_num_heads": 8, "mamba_head_dim": 16, "n_groups": 2,
         "ssm_state_size": 16, "chunk_size": 16, "num_attention_heads": 8,
         "num_key_value_heads": 2, "head_dim": 16, "n_routed_experts": 16,
         "num_experts_per_tok": 3, "moe_intermediate_size": 32,
         "moe_shared_expert_intermediate_size": 64, "vocab_size": 256,
         "num_hidden_layers": 7, "port_options": {"loss_chunk": 16, "attn_block": 16}}


def config() -> dict:
    return h.config_of(SPEC, h.cell_of(SPEC, CELL)["config"])


def small() -> tuple[dict, dict]:
    entry = h.cell_of(SPEC, CELL)
    c, mix = h.config_of(SPEC, entry["config"]), h.mix_of(entry["traffic"])
    c.update(SMALL)
    mix.update(seq=64, batch=2, pool=4)
    return c, mix


def kind():
    return h.kind_of(h.mix_of(h.cell_of(SPEC, CELL)["traffic"]))


# -- the configuration and the yardstick -----------------------------------------------------


def test_configuration_holds_the_catalog_numbers_outside_reduced():
    c = config()
    assert set(c["reduced"]) == {"num_hidden_layers"}
    assert c["num_hidden_layers"] == 13
    # 32 of the 128 experts held here: one of the 4 chips that share a layer
    assert c["expert_parallel"] == {"chips": 4, "rank": 0}
    assert work_hybrid.held_experts(c) == 32
    for key, value in PUBLISHED.items():
        if key not in c["reduced"]:
            assert c[key] == value, key
    # the first 13 blocks: 6 Mamba-2, 5 MoE, 2 attention, one whole period EMEMEM*
    assert work_hybrid.kinds(c) == "MEMEM*EMEMEM*"
    assert work_hybrid.router_experts(c) == PUBLISHED["n_routed_experts"]


def test_the_config_mapping_gives_the_published_model_and_refuses_the_rest():
    c = config()
    cfg = kind().model_config(c, remat=True)
    assert (cfg.family, cfg.block_pattern, cfg.rope_theta) == ("pattern", "MEMEM*EMEMEM*", 0.0)
    assert (cfg.d_inner, cfg.n_ssm_heads, cfg.ssm_conv, cfg.ssm_groups) == (4096, 64, 4, 8)
    assert (cfg.moe_experts, cfg.moe_router_experts, cfg.moe_expert_first) == (32, 128, 0)
    assert (cfg.moe_score, cfg.moe_act, cfg.moe_scaling, cfg.moe_d_ff_shared) == (
        "sigmoid", "relu2", 2.5, 3712)
    for key, value in (("mlp_hidden_act", "silu"), ("n_group", 8), ("moe_latent_size", 1024),
                       ("mamba_proj_bias", True), ("use_conv_bias", False),
                       ("residual_in_fp32", True), ("num_nextn_predict_layers", 1)):
        with pytest.raises(NotImplementedError, match=key):
            kind().model_config({**c, key: value}, remat=True)
    with pytest.raises(NotImplementedError, match="epsilon"):
        kind().model_config({**c, "layer_norm_epsilon": 1e-6}, remat=True)


def test_work_counts_against_hand_worked_values():
    c = config()
    # in_proj 2688 x (4096 + 6144 + 64), conv 6144 x (4 + 1), A_log, D, dt_bias, norm, out_proj
    assert work_hybrid.mamba_params(c) == (2688 * 10304 + 6144 * 5 + 3 * 64 + 4096
                                           + 4096 * 2688) == 38_742_208
    assert work_hybrid.attn_params(c) == 2 * 2688 * 128 * 34 == 23_396_352
    # the router and its bias, 32 held experts and the shared one, two matrices each
    assert work_hybrid.moe_params(c, 32) == 2688 * 128 + 128 + 2 * 2688 * (32 * 1856 + 3712)
    assert work_hybrid.param_count(c) == (2 * 131072 * 2688 + 2688 + 13 * 2688
                                          + 6 * 38_742_208 + 2 * 23_396_352
                                          + 5 * 339_591_296) == 2_681_883_136
    assert round(work_hybrid.param_count(c) * 16 / 1e9, 1) == 42.9     # fp32 w, grad, m, v
    # 2 (Q^2 N / (2 x 8 heads a group) + Q^2 P / 2 + 2 Q N P) a chunk, over 64 heads,
    # 64 chunks, 2 rows, 6 Mamba blocks
    chunk = 2 * (128 * 128 * 128 // 16 + 128 * 128 * 64 // 2 + 2 * 128 * 128 * 64)
    assert chunk == 5_505_024
    assert work_hybrid.ssd_pass_flops(c, 2, 8192) == chunk * 64 * 64 * 2 * 6 == 270_582_939_648
    assert work_hybrid.ssd_flops(c, 2, 8192) == 4 * 270_582_939_648
    # a token meets 6 x 32 / 128 = 1.5 held experts: 2 x 2 x 24,576 x 2688 x 1856, 4 passes, 5 blocks
    assert work_hybrid.expert_flops(c, 2, 8192) == 4 * 2 * 2 * 24_576 * 2688 * 1856 * 5
    active = work_hybrid.active_param_count(c)
    assert active == (2 * 131072 * 2688 + 2688 + 13 * 2688 + 6 * 38_742_208 + 2 * 23_396_352
                      + 5 * (2688 * 128 + 2 * 2688 * (1.5 * 1856 + 3712)))
    attn = 3 * 2 * 32 * 8192 ** 2 * 256 * 2
    assert work_hybrid.train_flops(c, 2, 8192) == pytest.approx(
        6 * active * 16384 + attn + 3 * 270_582_939_648, rel=1e-12)


def test_the_yardstick_counts_the_ports_parameters():
    """At the small widths, the yardstick's count is the sum of the port's
    leaves (``init_params`` on ``meta``), the held experts and the biases
    included."""
    from repro_torch.configs.base import ArchConfig
    from repro_torch.launch import steps

    c, _ = small()
    cfg = kind().model_config(c, remat=True)
    struct = steps.params_struct(ArchConfig(model=cfg, smoke=cfg))
    assert sum(leaf.numel() for _, leaf in h.tree_paths(struct)) == work_hybrid.param_count(c)


def test_reference_shapes_are_the_ports_tree():
    import nemotron_h_ref
    from repro_torch.configs.base import ArchConfig
    from repro_torch.launch import steps

    c = config()
    cfg = kind().model_config(c, remat=True)
    struct = steps.params_struct(ArchConfig(model=cfg, smoke=cfg))
    port = {path: tuple(leaf.shape) for path, leaf in h.tree_paths(struct)}
    shapes = nemotron_h_ref.param_shapes(c)
    assert shapes == port
    assert nemotron_h_ref.sorted_paths(shapes) == list(port)
    assert sum(np.prod(s) for s in shapes.values()) == work_hybrid.param_count(c)


def test_the_weights_are_drawn_as_mamba2_draws_them():
    import torch

    c, mix = small()
    cell = kind().Cell(h, c, mix, SEED, torch.device("cpu"))
    a_log = cell.weight(3, "blocks/0/mixer/A_log", (4096,))
    assert 0 <= float(a_log.min()) and float(a_log.max()) <= math.log(16)
    dt = torch.nn.functional.softplus(cell.weight(4, "blocks/0/mixer/dt_bias", (4096,)))
    assert 1e-3 * 0.999 <= float(dt.min()) and float(dt.max()) <= 0.1 * 1.001
    assert float(dt.median()) == pytest.approx(math.sqrt(1e-3 * 0.1), rel=0.1)
    assert torch.equal(cell.weight(5, "blocks/0/mixer/D", (64,)), torch.ones(64))
    conv = cell.weight(6, "blocks/0/mixer/conv_w", (4, 6144))
    assert float(conv.abs().max()) <= 0.5 and float(conv.std()) == pytest.approx(
        1 / math.sqrt(12), rel=0.05)
    bias = cell.weight(7, "blocks/1/mixer/score_bias", (4096,))
    assert float(bias.std()) == pytest.approx(kind().BIAS_SCALE, rel=0.05)
    assert torch.equal(bias, cell.weight(7, "blocks/1/mixer/score_bias", (4096,)))


# -- the readers -------------------------------------------------------------------------------


def test_the_new_readers_read_their_ranges_and_counts():
    ctx = {"summary": {"range_s": {"ssd_scan": 2.4, "mamba": 0.6}}, "window_s": 10.0,
           "work": {"steps": 8, "ssd_flops_per_step": 2.06e12}}
    assert h.reader_of("ssd_scan_ms.train")(ctx) == pytest.approx(300.0)
    assert h.reader_of("mamba_ms.train")(ctx) == pytest.approx(75.0)
    assert h.reader_of("ssd_scan_roofline.train")(ctx) == pytest.approx(
        100 * 8 * 2.06e12 / 2.4 / 989e12)
    silent = {"summary": {"range_s": {}}, "window_s": 10.0, "work": {"steps": 8}}
    for name in ("ssd_scan_ms.train", "mamba_ms.train", "ssd_scan_roofline.train"):
        assert h.reader_of(name)(silent) is None


# -- the cell on the CPU ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def driven():
    """The cell's set-up, window and check at small widths, and its
    reference kept for the control."""
    import torch

    c, mix = small()
    obj = kind().Cell(h, c, mix, SEED, torch.device("cpu"))
    out = run.drive(obj, SPEC, CELL, 0.5, False, torch.device("cpu"), 1)
    return obj, out, obj.reference()


def test_the_cell_agrees_with_the_reference(driven):
    # bf16 products over 7 blocks of width 64 against fp32
    _, out, _ = driven
    n = out["numbers"]
    assert out["result"]["failed"] == 0 and out["result"]["attempted"] >= 1
    assert n["loss_gap"] < 4e-3 and n["grad_gap"] < 0.05 and n["delta_gap"] < 0.05, n
    assert n["route_flip_share"] < 0.03, n


def test_the_cell_counts_every_routers_choices(driven):
    from repro_torch.models import moe

    assert moe.ROUTED.calls > 0 and moe.ROUTED.counts.shape == (16,)
    assert int(moe.ROUTED.counts.sum()) == moe.ROUTED.calls * 2 * 64 * 3


def test_the_fp8_control_is_not_correct(driven):
    obj, _, ref = driven
    control = kind().compare(obj.reference(control=True), ref)
    assert not h.judge(control, run.limits_of(CELL))[0], control
