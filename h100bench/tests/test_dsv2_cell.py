"""The DeepSeek-V2 training cell (``dsv2lite-train4k``) on the CPU: its
configuration against the published numbers, its yardstick against
hand-worked values, the reference's layout against the program's tree, the
Zipf token draw, the new readers, and the cell driven at small widths
through ``traffic/train_moe.py`` against the plain reference, with the fp8
control and a planted normalised top-k seen as not correct under the
cell's own limits.

    python3 -m pytest -q h100bench/tests
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

import harness as h  # noqa: E402
import run  # noqa: E402
import work_moe  # noqa: E402

h.port_path()
SPEC = h.load_spec()
CELL = "dsv2lite-train4k"
SEED = 2**31 + 54321
#: DeepSeek-V2-Lite's config.json (https://huggingface.co/deepseek-ai/DeepSeek-V2-Lite)
PUBLISHED = {
    "attention_bias": False, "first_k_dense_replace": 1, "hidden_act": "silu",
    "hidden_size": 2048, "intermediate_size": 10944, "kv_lora_rank": 512,
    "max_position_embeddings": 163840, "model_type": "deepseek_v2",
    "moe_intermediate_size": 1408, "moe_layer_freq": 1, "n_group": 1, "n_routed_experts": 64,
    "n_shared_experts": 2, "norm_topk_prob": False, "num_attention_heads": 16,
    "num_experts_per_tok": 6, "num_hidden_layers": 27, "num_key_value_heads": 16,
    "q_lora_rank": None, "qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
    "rms_norm_eps": 1e-06,
    "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 0.707,
                     "mscale_all_dim": 0.707, "original_max_position_embeddings": 4096,
                     "type": "yarn"},
    "rope_theta": 10000, "routed_scaling_factor": 1, "scoring_func": "softmax",
    "seq_aux": True, "tie_word_embeddings": False, "topk_group": 1, "topk_method": "greedy",
    "v_head_dim": 128, "vocab_size": 102400, "aux_loss_alpha": 0.001}
SMALL = {"hidden_size": 64, "intermediate_size": 128, "num_attention_heads": 4,
         "num_key_value_heads": 4, "kv_lora_rank": 32, "qk_nope_head_dim": 16,
         "qk_rope_head_dim": 8, "v_head_dim": 16, "n_routed_experts": 8,
         "num_experts_per_tok": 3, "moe_intermediate_size": 32, "vocab_size": 256,
         "num_hidden_layers": 3, "port_options": {"loss_chunk": 16, "attn_block": 16}}


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


def test_configuration_holds_the_published_numbers_outside_reduced():
    c = config()
    assert set(c["reduced"]) == {"num_hidden_layers"} and c["num_hidden_layers"] == 5
    for key, value in PUBLISHED.items():
        if key not in c["reduced"]:
            assert c[key] == value, key
    assert c["departs"] == {}


def test_work_counts_against_hand_worked_values():
    c = config()
    # MLA: 2048*16*192 + 2048*576 + 512 + 512*16*256 + 16*128*2048
    assert work_moe.mla_params(c) == 13_763_072
    # embedding and head 419.4 M, a dense layer 81.0 M, an expert layer 584.8 M (4 of them)
    assert work_moe.param_count(c) == 2_839_831_040
    assert round(work_moe.param_count(c) * 16 / 1e9, 1) == 45.4      # fp32 w, grad, m, v
    whole = {**c, "num_hidden_layers": 27}
    assert round(work_moe.param_count(whole) / 1e9, 1) == 15.7       # "15.7B-A2.4B"
    # 6 x 832.9 M x 16,384 + 3 x 4 x 16 x 4096^2 x 320 x 5
    assert abs(work_moe.train_flops(c, 4, 4096) / 1e12 - 87.03) < 0.01
    # 4 layers x 4 passes x 3 products x 2 x 98,304 x 2048 x 1408
    assert work_moe.expert_flops(c, 4, 4096) == 4 * 4 * 3 * 2 * 98_304 * 2048 * 1408


def test_reference_shapes_are_the_ports_tree():
    import dsv2_ref
    from repro_torch.configs.base import ArchConfig
    from repro_torch.launch import steps

    c = config()
    cfg = kind().model_config(c, remat=True)
    struct = steps.params_struct(ArchConfig(model=cfg, smoke=cfg))
    port = {path: tuple(leaf.shape) for path, leaf in h.tree_paths(struct)}
    shapes = dsv2_ref.param_shapes(c)
    assert shapes == port
    assert dsv2_ref.sorted_paths(shapes) == list(port)
    assert sum(np.prod(s) for s in shapes.values()) == work_moe.param_count(c)


def test_the_config_mapping_refuses_what_the_program_does_not_compute():
    c = config()
    for key, value in (("scoring_func", "sigmoid"), ("q_lora_rank", 1536),
                       ("routed_scaling_factor", 16), ("topk_method", "group_limited_greedy")):
        with pytest.raises(NotImplementedError, match=key):
            kind().model_config({**c, key: value}, remat=True)


# -- the traffic -----------------------------------------------------------------------------


def test_the_zipf_draw_is_the_seeds():
    k = kind()
    a = k.zipf_rows(SEED, 4, 4, 4096, 102400, 1.0)
    assert a.shape == (4, 4, 4097) and a.dtype == np.int32
    assert np.array_equal(a, k.zipf_rows(SEED, 4, 4, 4096, 102400, 1.0))
    assert not np.array_equal(a, k.zipf_rows(SEED + 1, 4, 4, 4096, 102400, 1.0))
    top = np.bincount(a.ravel(), minlength=102400).max() / a.size
    assert 0.07 < top < 0.095                  # 1 / H(102400) = 8.3%
    assert a.min() >= 0 and a.max() < 102400


# -- the readers -------------------------------------------------------------------------------


def test_the_new_readers_read_their_ranges_and_counts():
    ctx = {"summary": {"range_s": {"experts": 0.8, "moe": 0.3}}, "window_s": 10.0,
           "work": {"steps": 8, "expert_flops_per_step": 27.2e12, "moe_load_max": 1.9}}
    assert h.reader_of("experts_ms.train")(ctx) == pytest.approx(100.0)
    assert h.reader_of("moe_ms.train")(ctx) == pytest.approx(37.5)
    assert h.reader_of("experts_roofline.train")(ctx) == pytest.approx(
        100 * 8 * 27.2e12 / 0.8 / 989e12)
    assert h.reader_of("moe_load_max.train")(ctx) == 1.9
    silent = {"summary": {"range_s": {}}, "window_s": 10.0, "work": {"steps": 8}}
    for name in ("experts_ms.train", "moe_ms.train", "experts_roofline.train",
                 "moe_load_max.train"):
        assert h.reader_of(name)(silent) is None


# -- the cell on the CPU ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def driven():
    """The cell's set-up, window and check at small widths, and its
    reference kept for the control and the planted fault."""
    import torch

    c, mix = small()
    obj = kind().Cell(h, c, mix, SEED, torch.device("cpu"))
    out = run.drive(obj, SPEC, CELL, 0.5, False, torch.device("cpu"), 1)
    return obj, out, obj.reference()


def judged(numbers: dict) -> bool:
    return h.judge(numbers, run.limits_of(CELL))[0]


def test_the_cell_agrees_with_the_reference(driven):
    # bf16 products over 3 layers of width 64 against fp32
    _, out, _ = driven
    n = out["numbers"]
    assert out["result"]["failed"] == 0 and out["result"]["attempted"] >= 1
    assert n["loss_gap"] < 2e-3 and n["grad_gap"] < 0.03 and n["delta_gap"] < 0.03, n
    assert n["aux_gap"] < 1e-2 and n["route_flip_share"] < 0.03, n


def test_the_cell_counts_the_routed_choices(driven):
    obj, _, _ = driven
    from repro_torch.models import moe

    assert moe.ROUTED.calls > 0
    assert int(moe.ROUTED.counts.sum()) == moe.ROUTED.calls * 2 * 64 * 3


def test_the_fp8_control_is_not_correct(driven):
    obj, _, ref = driven
    control = kind().compare(obj.reference(control=True), ref)
    assert not judged(control), control


def test_a_planted_normalised_top_k_is_not_correct(driven):
    import torch

    _, _, ref = driven
    c, mix = small()
    planted = kind().Cell(h, {**c, "norm_topk_prob": True}, mix, SEED, torch.device("cpu"))
    planted.setup()
    planted.release()
    numbers = kind().compare(planted.readings, ref)
    assert not judged(numbers), numbers


def test_the_routing_probe_measures_every_part_and_puts_them_back():
    import routing_load
    import torch
    from repro_torch.configs.base import ArchConfig
    from repro_torch.launch import steps
    from repro_torch.models import moe

    c, mix = small()
    cell = kind().Cell(h, c, mix, SEED, torch.device("cpu"))
    cfg = kind().model_config(c, remat=False)
    struct = steps.params_struct(ArchConfig(model=cfg, smoke=cfg))
    params = h.build_tree(struct, lambda index, path, leaf: cell.weight(
        index, path, tuple(leaf.shape)))
    route = moe.route
    rows = routing_load.probe(params, cfg, cell.rows(0)[0])
    assert moe.route is route
    # the embedding, then attention and MLP a layer, the router inside the 2 expert layers
    assert [r["part"] for r in rows] == ["embed", "attn", "mlp", "attn", "route", "mlp",
                                         "attn", "route", "mlp"]
    assert abs(rows[0]["rms"] - 0.02) < 2e-3
    for r in rows:
        assert 0 <= r["shared"] <= 1, r
        if r["part"] == "route":
            assert 1 <= r["load_max_centred"] and 1 <= r["load_max"] <= c["n_routed_experts"]
    x = torch.randn(64, 8)
    assert routing_load.shared_share(x.new_ones(64, 8) + 0 * x) == pytest.approx(1.0)
    assert routing_load.load_max(torch.arange(8).repeat(4), 8) == 1.0
