"""DeepSeek-V2 as published, on the port, against the plain reference
``h100bench/reference/dsv2_ref.py`` (``modeling_deepseek.py``'s equations
in fp32, loaded by path), on seeded weights at small widths on the CPU.

The five published features the port takes as ``ModelConfig`` fields:
YaRN (``rope_yarn``), the latent's RMSNorm (``mla_kv_norm``), top-k weights
left unnormalised (``moe_norm_topk`` False), the sequence-wise balance
term (``moe_aux_alpha``) and dropless routing (``moe_dropless``).  Each
comparison is run once as published, where it must hold its tolerance, and
once with one feature switched off in the port alone, where it must not:
the tolerances are tight enough to see each feature.

Tolerances: the port computes its products in bf16 (operands rounded to
2^-9 of their value, sums in fp32) against the reference's fp32, so a
result of a few chained products differs by about 1% of its RMS; each
check states its bound beside it.
"""

from __future__ import annotations

import dataclasses
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "h100bench" / "reference"))

import dsv2_ref as ref  # noqa: E402  (the benchmark's plain reference)

from repro_torch.configs.base import ArchConfig, ShapeConfig  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.layers import Yarn, rope_freqs  # noqa: E402
from repro_torch.optim.adamw import init_opt_state  # noqa: E402

CPU = torch.device("cpu")
PUBLISHED_YARN = Yarn(factor=40.0, original_max_position=4096, beta_fast=32.0, beta_slow=1.0,
                      mscale_all_dim=0.707)
#: a published config's keys at small widths (the reference reads these)
SMALL = {"hidden_size": 64, "intermediate_size": 128, "num_attention_heads": 4,
         "kv_lora_rank": 32, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
         "n_routed_experts": 8, "num_experts_per_tok": 3, "moe_intermediate_size": 32,
         "n_shared_experts": 2, "first_k_dense_replace": 1, "num_hidden_layers": 3,
         "vocab_size": 256, "rms_norm_eps": 1e-6, "rope_theta": 10000,
         "rope_scaling": {"type": "yarn", "factor": 40, "original_max_position_embeddings": 4096,
                          "beta_fast": 32, "beta_slow": 1, "mscale": 0.707,
                          "mscale_all_dim": 0.707},
         "norm_topk_prob": False, "routed_scaling_factor": 1, "seq_aux": True,
         "aux_loss_alpha": 0.001}
PUBLISHED = M.ModelConfig(
    name="dsv2-published-small", family="moe", n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256, norm_eps=1e-6, moe_experts=8, moe_top_k=3, moe_shared=2, moe_d_ff=32,
    moe_dense_first_n=1, mla_kv_lora=32, mla_qk_nope=16, mla_qk_rope=8, mla_v_head=16,
    loss_chunk=16, attn_block=16, mla_kv_norm=True, rope_yarn=PUBLISHED_YARN,
    moe_norm_topk=False, moe_aux_alpha=0.001, moe_dropless=True)


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """Relative RMS error of ``got`` against ``want``."""
    got, want = got.detach().double(), want.detach().double()
    return float((got - want).norm() / want.norm())


def _normal(gen, *shape, scale=1.0):
    return torch.randn(shape, generator=gen) * scale


# -- YaRN ---------------------------------------------------------------------------------


def test_yarn_at_the_published_numbers():
    """The correction range is pairs 10..23 of 32 and mscale 1.2608; pairs
    below the range keep theta^(-2i/64), pairs from its end on are divided
    by 40, and the frequencies equal the reference's, whose cos/sin scale
    is 1."""
    assert PUBLISHED_YARN.correction_range(64, 1e4) == (10, 23)
    assert math.isclose(math.sqrt(PUBLISHED_YARN.attention_scale()),
                        0.1 * 0.707 * math.log(40) + 1, rel_tol=1e-12)
    assert round(math.sqrt(PUBLISHED_YARN.attention_scale()), 4) == 1.2608
    assert ref.yarn_get_mscale(40, 0.707) / ref.yarn_get_mscale(40, 0.707) == 1.0
    plain = rope_freqs(64, 1e4, CPU)
    yarn = rope_freqs(64, 1e4, CPU, PUBLISHED_YARN)
    assert torch.equal(yarn[:11], plain[:11])
    torch.testing.assert_close(yarn[23:], plain[23:] / 40, rtol=1e-6, atol=0)
    assert ((yarn[11:23] < plain[11:23]) & (yarn[11:23] > plain[11:23] / 40)).all()
    c = {"qk_rope_head_dim": 64, "rope_theta": 10000, "rope_scaling": SMALL["rope_scaling"]}
    torch.testing.assert_close(yarn, ref.yarn_inv_freq(c), rtol=1e-6, atol=0)


# -- MLA ----------------------------------------------------------------------------------


def _mla_weights(gen):
    d, h, lora, nope, rope, v = 64, 4, 32, 16, 8, 16
    return {"attn/wq/w": _normal(gen, d, h * (nope + rope), scale=d ** -0.5),
            "attn/w_dkv/w": _normal(gen, d, lora + rope, scale=d ** -0.5),
            "attn/kv_norm/scale": 1 + 0.5 * _normal(gen, lora),
            "attn/w_uk/w": _normal(gen, lora, h * nope, scale=lora ** -0.5),
            "attn/w_uv/w": _normal(gen, lora, h * v, scale=lora ** -0.5),
            "attn/wo/w": _normal(gen, h * v, d, scale=(h * v) ** -0.5)}


@pytest.mark.parametrize("off", [None, "yarn", "kv_norm"])
def test_mla_forward_and_backward_match_the_reference(off):
    """MLA's output and its gradients (input and every weight) within 2% of
    the reference's RMS, the bf16 products' rounding (about 0.6% read); with
    YaRN or the latent's norm switched off in the port, further than 2%."""
    gen = torch.Generator().manual_seed(11)
    w = _mla_weights(gen)
    x = _normal(gen, 2, 48, 64)
    dout = _normal(gen, 2, 48, 64)
    c = {**SMALL}
    rope = ref.cos_sin(c, 48, CPU)

    def reference():
        leaves = {k: v.clone().requires_grad_() for k, v in w.items()}
        xx = x.clone().requires_grad_()
        out = ref.mla(leaves, xx, c, ref.Precision(), rope)
        out.backward(dout)
        return out, xx.grad, {k: v.grad for k, v in leaves.items()}

    def port():
        p = {k.split("/")[1]: ({"scale": v} if k.endswith("scale") else {"w": v})
             for k, v in w.items()}
        if off == "kv_norm":
            del p["kv_norm"]
        p = {k: {kk: vv.clone().requires_grad_() for kk, vv in leaf.items()}
             for k, leaf in p.items()}
        xx = x.clone().requires_grad_()
        out = attn.mla_apply(p, xx, 4, 32, 16, 8, 16, rope_theta=1e4, block=16,
                             yarn=None if off == "yarn" else PUBLISHED_YARN, norm_eps=1e-6)
        out.float().backward(dout)
        grads = {f"attn/{k}/{kk}": vv.grad for k, leaf in p.items() for kk, vv in leaf.items()}
        return out, xx.grad, grads

    want, want_dx, want_dw = reference()
    got, got_dx, got_dw = port()
    errors = {"out": _rel(got, want), "dx": _rel(got_dx, want_dx)}
    errors.update({k: _rel(g, want_dw[k]) for k, g in got_dw.items()})
    if off is None:
        assert max(errors.values()) < 0.02, errors
    else:
        assert max(errors.values()) > 0.02, errors


# -- the MoE layer ------------------------------------------------------------------------


def _moe_case(gen, s=64, e=8, k=3, d=64, ff=32):
    """Weights and a batch whose tokens crowd three experts: every token
    shares one direction that the router favours, so the capacity path
    (1.25 x the mean load a row) would drop choices."""
    common = _normal(gen, d)
    x = (common + 0.3 * _normal(gen, 2, s, d)).to(torch.bfloat16)
    router = _normal(gen, d, e, scale=d ** -0.5)
    router[:, :3] += 0.3 * common[:, None] / common.norm()
    w = {"mlp/router/w": router,
         "mlp/w_gate": _normal(gen, e, d, ff, scale=d ** -0.5),
         "mlp/w_up": _normal(gen, e, d, ff, scale=d ** -0.5),
         "mlp/w_down": _normal(gen, e, ff, d, scale=ff ** -0.5),
         "mlp/shared/gate/w": _normal(gen, d, 2 * ff, scale=d ** -0.5),
         "mlp/shared/up/w": _normal(gen, d, 2 * ff, scale=d ** -0.5),
         "mlp/shared/down/w": _normal(gen, 2 * ff, d, scale=(2 * ff) ** -0.5)}
    return x, w


def _port_moe_params(w):
    return {"router": {"w": w["mlp/router/w"]}, "w_gate": w["mlp/w_gate"],
            "w_up": w["mlp/w_up"], "w_down": w["mlp/w_down"],
            "shared": {n: {"w": w[f"mlp/shared/{n}/w"]} for n in ("gate", "up", "down")}}


@pytest.mark.parametrize("off", [None, "norm_topk", "seq_aux", "dropless"])
def test_moe_apply_matches_the_reference_where_capacity_would_drop(off):
    """The published MoE layer (unnormalised top-3 of 8, the balance term at
    alpha 0.05, dropless) on tokens the capacity path drops from: the output
    and the gradients of the input and every weight within 2% of the
    reference's RMS (bf16 products, about 0.5% read), the balance term within
    1e-4 of its value (its counts are exact, its mean probabilities fp32 of
    a bf16 input); with any of the three switched off, further."""
    gen = torch.Generator().manual_seed(5)
    x, w = _moe_case(gen)
    b, s, d = x.shape
    dout = _normal(gen, b, s, d)
    c = {**SMALL, "aux_loss_alpha": 0.05}
    alpha = 0.05
    probs = torch.softmax(x.reshape(-1, d).float() @ w["mlp/router/w"], -1)
    load = torch.nn.functional.one_hot(probs.topk(3).indices, 8).sum(1).reshape(b, s, 8).sum(1)
    assert (load > int(s * 3 / 8 * 1.25)).any()          # the capacity path would drop here

    leaves = {k: v.clone().requires_grad_() for k, v in w.items()}
    xr = x.float().clone().requires_grad_()
    want, want_aux, _ = ref.moe(leaves, xr, c, ref.Precision())
    (want * dout).sum().add(want_aux).backward()
    want_grads = {"x": xr.grad, **{k: v.grad for k, v in leaves.items()}}

    opts = {"norm_topk": False, "aux_alpha": alpha, "dropless": True}
    if off is not None:
        opts.update({"norm_topk": {"norm_topk": True}, "seq_aux": {"aux_alpha": 0.0},
                     "dropless": {"dropless": False}}[off])
    p = M.tree_map(lambda t: t.clone().requires_grad_(), _port_moe_params(w))
    xp = x.clone().requires_grad_()
    with moe.AUX.collect() as aux:
        got = moe.moe_apply(p, xp, 8, 3, **opts)
        got.float().backward(dout)
    got_grads = {"x": xp.grad, "mlp/router/w": p["router"]["w"].grad,
                 "mlp/w_gate": p["w_gate"].grad, "mlp/w_up": p["w_up"].grad,
                 "mlp/w_down": p["w_down"].grad,
                 **{f"mlp/shared/{n}/w": p["shared"][n]["w"].grad for n in ("gate", "up", "down")}}
    errors = {"out": _rel(got, want), **{k: _rel(g, want_grads[k]) for k, g in got_grads.items()}}
    aux_error = abs(float(sum(aux)) - float(want_aux.detach())) if aux else float("inf")
    if off is None:
        assert max(errors.values()) < 0.02 and aux_error < 1e-4, (errors, aux_error)
    else:
        assert max(errors.values()) > 0.02 or aux_error > 1e-4, (errors, aux_error)


def test_route_returns_the_reference_choices_and_balance_term():
    """``moe.route``'s weights (unnormalised), ids and balance term against
    the reference's gate on the same fp32 input: the same experts, weights
    and term to fp32 rounding."""
    gen = torch.Generator().manual_seed(9)
    x, w = _moe_case(gen)
    xf = x.float().reshape(-1, 64)
    weights, ids, aux = moe.route({"w": w["mlp/router/w"]}, xf, 3, 2, norm_topk=False,
                                  aux_alpha=0.05)
    scores = torch.softmax(xf @ w["mlp/router/w"], -1)
    top_w, top_i = torch.topk(scores, 3, sorted=True)
    assert torch.equal(ids, top_i)
    torch.testing.assert_close(weights, top_w, rtol=1e-6, atol=0)
    _, want_aux, _ = ref.moe(w, x.float(), {**SMALL, "aux_loss_alpha": 0.05}, ref.Precision())
    torch.testing.assert_close(aux, want_aux, rtol=1e-5, atol=0)


def test_grouped_experts_match_per_expert_products_on_the_cpu():
    """``moe._GroupedExperts`` (``torch._grouped_mm``) against autograd
    through a loop over the experts in fp32 on the same bf16 operands, empty
    experts included: within 1% of the RMS (bf16 results of chained
    products), and 0 for the weights of an expert with no rows."""
    gen = torch.Generator().manual_seed(3)
    counts = torch.tensor([5, 0, 7, 3, 0, 9])
    ends = torch.cumsum(counts, 0).to(torch.int32)
    xs = _normal(gen, int(counts.sum()), 32).to(torch.bfloat16)
    ws = [_normal(gen, 6, 32, 16, scale=32 ** -0.5), _normal(gen, 6, 32, 16, scale=32 ** -0.5),
          _normal(gen, 6, 16, 32, scale=16 ** -0.5)]
    dy = _normal(gen, int(counts.sum()), 32)

    x1 = xs.clone().requires_grad_()
    w1 = [t.clone().requires_grad_() for t in ws]
    moe._GroupedExperts.apply(x1, ends, *w1).float().backward(dy)
    x2 = xs.float().clone().requires_grad_()
    w2 = [t.to(torch.bfloat16).float().requires_grad_() for t in ws]
    parts, start = [], 0
    for e, n in enumerate(counts.tolist()):
        rows = x2[start:start + n]
        parts.append((torch.nn.functional.silu(rows @ w2[0][e]) * (rows @ w2[1][e])) @ w2[2][e])
        start += n
    torch.cat(parts).backward(dy)
    for got, want in zip([x1.grad, *(t.grad for t in w1)], [x2.grad, *(t.grad for t in w2)]):
        assert _rel(got, want) < 0.01
    for t in w1:
        assert (t.grad[counts == 0] == 0).all()


def test_moe_ep_apply_refuses_the_published_routing():
    """The expert-parallel path runs the capacity path only: each published
    routing keyword raises before any collective, naming its field."""
    x = torch.zeros(1, 4, 8)
    for field, value in (("norm_topk", False), ("aux_alpha", 0.001), ("dropless", True)):
        with pytest.raises(NotImplementedError, match=f"ModelConfig.moe_{field}"):
            moe.moe_ep_apply({}, x, 4, 2, 1.25, None, ("data",), "model", **{field: value})


def test_routing_options_are_empty_for_every_registry_config():
    """Every registry config, deepseek-v2-lite-16b's included, keeps the
    capacity path and the reference's attention: the fields at their
    defaults, so ``moe_apply`` is called as before."""
    for arch in ARCHS.values():
        for cfg in (arch.model, arch.smoke):
            assert moe.routing_options(cfg) == {}
            assert cfg.rope_yarn is None and not cfg.mla_kv_norm


# -- the model: train steps and decode ----------------------------------------------------


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _paths(tree[key], f"{prefix}{key}/")
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            yield from _paths(value, f"{prefix}{i}/")
    else:
        yield prefix.rstrip("/"), tree


def _seeded_params(cfg, seed=0):
    """The port's params with the norms' scales drawn around 1, so that the
    latent's norm is seen; and the same as the reference's dict."""
    params = M.init_params(cfg, seed, device=CPU)
    gen = torch.Generator().manual_seed(seed + 1)
    for path, leaf in _paths(params):
        if path.endswith("scale"):
            leaf.copy_(1 + 0.3 * torch.randn(leaf.shape, generator=gen))
    return params, {path: leaf.clone() for path, leaf in _paths(params)}


def _tokens(seed, b, s, vocab=256):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, vocab, (b, s + 1), generator=gen)


def test_reference_layout_is_the_ports_tree():
    params = M.init_params(PUBLISHED, 0, device="meta",
                           generator=steps._MetaGenerator())
    port = {path: tuple(leaf.shape) for path, leaf in _paths(params)}
    shapes = ref.param_shapes({**SMALL})
    assert shapes == port
    assert ref.sorted_paths(shapes) == list(port)


def test_three_train_steps_match_the_reference():
    """Three ``make_train_step`` steps (remat on, AdamW, the published
    features all on) against ``dsv2_ref.train``'s: each step's loss within
    2e-3 of it and balance term (``aux_loss``, summed over layers) within
    5e-3 (bf16 over three layers), the first gradient of every leaf, as
    AdamW takes it, within 3% of the larger of its norm and the median
    leaf's, and the norm of every leaf's change over the steps within 3% of
    the same (``h100bench``'s training check at small widths: bf16 read
    about 0.7% and 1%)."""
    params, ref_params = _seeded_params(PUBLISHED)
    start = {k: v.clone() for k, v in ref_params.items()}
    rows = [_tokens(i, 2, 32) for i in range(3)]
    batches = [(r[:, :-1], r[:, 1:]) for r in rows]
    step = steps.make_train_step(ArchConfig(model=PUBLISHED, smoke=PUBLISHED),
                                 ShapeConfig("t", "train", 32, 2))
    opt = init_opt_state(params)
    losses, auxes = [], []
    for i, (tokens, labels) in enumerate(batches):
        params, opt, metrics = step(params, opt, {"tokens": tokens, "labels": labels})
        losses.append(float(metrics["loss"]))
        auxes.append(float(metrics["aux_loss"]))
        if i == 0:
            first = {k: v / (1 - ref.B1) for k, v in _paths(opt["m"])}
    want = ref.train(ref_params, {**SMALL}, batches, 3, initial=start.__getitem__)
    loss_gap = max(abs(a - b) / b for a, b in zip(losses, want["losses"]))
    aux_gap = max(abs(a - b) / b for a, b in zip(auxes, want["aux"]))
    grads = ref.leaf_norms(first)
    median = float(np.median(list(want["grad"].values())))
    grad_gap = max(abs(grads[k] - g) / max(g, median) for k, g in want["grad"].items())
    deltas = ref.leaf_norms({k: v - start[k] for k, v in _paths(params)})
    median = float(np.median(list(want["delta"].values())))
    delta_gap = max(abs(deltas[k] - g) / max(g, median) for k, g in want["delta"].items())
    gaps = {"loss": loss_gap, "aux": aux_gap, "grad": grad_gap, "delta": delta_gap}
    assert loss_gap < 2e-3 and aux_gap < 5e-3 and grad_gap < 0.03 and delta_gap < 0.03, gaps


def test_prefill_then_decode_matches_the_full_forward(monkeypatch):
    """Sixteen ``decode_step``s from an empty cache (the latent cached
    normed, YaRN on q and the cached key) against the reference's full
    forward: every position's logits within 5% of their RMS, and their
    median within 2.5% (bf16 products, residual stream and cache: the
    port's own full forward reads 1.6-1.8% median over three seeds).  A token the two route apart (a near-tie of the
    router under bf16) leaves the comparison with the rest of its row, which
    attends to it; at most 2 of the 32 tokens may."""
    params, ref_params = _seeded_params(PUBLISHED)
    tokens = _tokens(4, 2, 16)[:, :16]
    record, routed = [], []
    route = moe.route

    def recording(*args, **kwargs):
        out = route(*args, **kwargs)
        routed.append(torch.sort(out[1], dim=-1).values)
        return out

    monkeypatch.setattr(moe, "route", recording)
    with torch.no_grad():
        hidden, _ = ref.forward(ref_params, {**SMALL}, tokens, ref.Precision(), record)
        want = hidden @ ref_params["unembed/w"]
        cache = M.init_cache(PUBLISHED, 2, 16, device=CPU)
        got = []
        for t in range(16):
            logits, cache = M.decode_step(params, PUBLISHED, cache,
                                          {"tokens": tokens[:, t:t + 1], "cur_len": t})
            got.append(logits)
    got = torch.cat(got, dim=1)
    layers = len(record)
    apart = torch.zeros(2, 16, dtype=torch.bool)
    for t in range(16):
        for layer in range(layers):
            ours, theirs = routed[t * layers + layer], record[layer].reshape(2, 16, -1)[:, t]
            apart[:, t] |= (ours != theirs).any(-1)
    assert int(apart.sum()) <= 2, apart
    unsure = apart.cumsum(dim=1) > 0
    errors = [_rel(got[b, t], want[b, t]) for b in range(2) for t in range(16)
              if not unsure[b, t]]
    assert max(errors) < 0.05 and np.median(errors) < 0.025, np.round(errors, 4)


def test_aux_loss_is_reported_only_where_the_config_sets_it():
    cfg = dataclasses.replace(PUBLISHED, moe_aux_alpha=0.0)
    params = M.init_params(cfg, 0, device=CPU)
    step = steps.make_train_step(ArchConfig(model=cfg, smoke=cfg), ShapeConfig("t", "train", 16, 1))
    rows = _tokens(0, 1, 16)
    _, _, metrics = step(params, init_opt_state(params),
                         {"tokens": rows[:, :-1], "labels": rows[:, 1:]})
    assert "aux_loss" not in metrics
