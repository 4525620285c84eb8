"""NemotronH as published, on the port, against the plain reference
``h100bench/reference/nemotron_h_ref.py`` (``modeling_nemotron_h.py``'s
equations in fp32, loaded by path), on seeded weights at small widths on
the CPU.

The pattern family (``ModelConfig.block_pattern``) and what its mixers
take: the published Mamba-2 mixer (``ssm_conv``, which brings the gated
group norm, and ``ssm_head_dim``), the sigmoid router with its correction
bias (``moe_score``, ``moe_scaling``), relu^2 experts
(``moe_act``) and a shared expert of its own width, the chip's share of
the experts (``moe_router_experts``, ``moe_expert_first``) and NoPE
attention (``rope_theta`` 0).  Each comparison is run as published, where
it must hold its tolerance, and with one feature planted away in the port
alone, where it must not.

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

import nemotron_h_ref as ref  # noqa: E402  (the benchmark's plain reference)

from repro_torch.configs.base import ArchConfig, ShapeConfig  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import mamba2 as m2  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.layers import relu2_mlp_apply, rmsnorm_apply, trainable  # noqa: E402
from repro_torch.optim.adamw import init_opt_state  # noqa: E402

CPU = torch.device("cpu")
#: a published config's keys at small widths (the reference reads these):
#: 8 Mamba heads of 16 in 4 groups, 8 query heads over 2 KV heads of 16,
#: 2 of 8 routed experts held (the second of 4 shares), top 3
SMALL = {"hidden_size": 64, "vocab_size": 256, "hybrid_override_pattern": "MEM*E",
         "num_hidden_layers": 5, "mamba_num_heads": 8, "mamba_head_dim": 16, "n_groups": 4,
         "ssm_state_size": 16, "chunk_size": 16, "conv_kernel": 4, "layer_norm_epsilon": 1e-5,
         "norm_eps": 1e-5, "num_attention_heads": 8, "num_key_value_heads": 2, "head_dim": 16,
         "n_routed_experts": 8, "expert_parallel": {"chips": 4, "rank": 1},
         "num_experts_per_tok": 3, "norm_topk_prob": True, "routed_scaling_factor": 2.5,
         "moe_intermediate_size": 32, "moe_shared_expert_intermediate_size": 64,
         "n_shared_experts": 1}
PUBLISHED = M.ModelConfig(
    name="nemotron-h-small", family="pattern", n_layers=5, d_model=64, n_heads=8, n_kv_heads=2,
    d_ff=32, vocab=256, head_dim=16, rope_theta=0.0, loss_chunk=16, attn_block=16,
    block_pattern="MEM*E", ssm_state=16, ssm_heads=8, ssm_head_dim=16, ssm_groups=4,
    ssm_chunk=16, ssm_conv=4, moe_experts=2, moe_top_k=3, moe_shared=1, moe_d_ff=32,
    moe_d_ff_shared=64, moe_dropless=True, moe_score="sigmoid", moe_scaling=2.5,
    moe_act="relu2", moe_router_experts=8, moe_expert_first=2)
D, H, P, G, N = 64, 8, 16, 4, 16
DI = H * P
CONV = DI + 2 * G * N


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """Relative RMS error of ``got`` against ``want``."""
    got, want = got.detach().double(), want.detach().double()
    return float((got - want).norm() / want.norm())


def _normal(gen, *shape, scale=1.0):
    return torch.randn(shape, generator=gen) * scale


def _uniform(gen, *shape, lo=0.0, hi=1.0):
    return lo + (hi - lo) * torch.rand(shape, generator=gen)


# -- the Mamba-2 mixer ----------------------------------------------------------------------


def _mamba_weights(gen):
    """A mixer's weights as Mamba-2 draws them (A in [1, 16], dt from
    [0.001, 0.1]), the norm's weight around 1 and each group's channels at
    their own scale in out_proj's input, so that the groups' norms differ."""
    dt = torch.exp(_uniform(gen, H, lo=math.log(1e-3), hi=math.log(0.1)))
    return {"in_proj/w": _normal(gen, D, 2 * DI + 2 * G * N + H, scale=D ** -0.5)
            * torch.cat([torch.ones(DI), torch.linspace(0.3, 3.0, DI), torch.ones(2 * G * N + H)]),
            "conv_w": _uniform(gen, 4, CONV, lo=-0.5, hi=0.5),
            "conv_b": _uniform(gen, CONV, lo=-0.5, hi=0.5),
            "A_log": torch.log(_uniform(gen, H, lo=1.0, hi=16.0)),
            "dt_bias": dt + torch.log(-torch.expm1(-dt)),
            "D": 1 + 0.1 * _normal(gen, H),
            "norm/scale": 1 + 0.3 * _normal(gen, DI),
            "out_proj/w": _normal(gen, DI, D, scale=DI ** -0.5)}


def _port_mamba_params(w, conv=True):
    p = {"in_proj": {"w": w["in_proj/w"]}, "out_proj": {"w": w["out_proj/w"]},
         "norm": {"scale": w["norm/scale"]}, "A_log": w["A_log"], "D": w["D"],
         "dt_bias": w["dt_bias"]}
    if conv:
        p.update(conv_w=w["conv_w"], conv_b=w["conv_b"])
    return p


def _norm_then_gate(scale, y, gate, groups, eps):
    """The reference's zamba2 order: one RMSNorm over all of d_inner, then
    the gate."""
    y = y.to(gate.dtype)
    return rmsnorm_apply({"scale": scale}, y, eps) * torch.nn.functional.silu(gate)


def _one_norm(scale, y, gate, groups, eps, grouped=m2.gated_group_norm):
    """The gate first, then one RMSNorm over all of d_inner."""
    return grouped(scale, y, gate, 1, eps)


@pytest.mark.parametrize("off", [None, "conv", "norm_then_gate", "one_norm"])
def test_mamba_mixer_forward_and_backward_match_the_reference(off, monkeypatch):
    """The published mixer's output and its gradients (input and every
    weight) within 2% of the reference's RMS (bf16 products, about 0.5%
    read); with the convolution left out, the norm taken before the gate
    (the reference's zamba2 mixer), or one norm over all of d_inner after
    the gate, further than 2%."""
    gen = torch.Generator().manual_seed(21)
    w = _mamba_weights(gen)
    x = _normal(gen, 2, 64, D)
    dout = _normal(gen, 2, 64, D)
    c = {**SMALL}

    leaves = {k: v.clone().requires_grad_() for k, v in w.items()}
    xr = x.clone().requires_grad_()
    want = ref.mamba(leaves, xr, c, ref.Precision())
    want.backward(dout)
    want_grads = {"x": xr.grad, **{k: v.grad for k, v in leaves.items()}}

    p = M.tree_map(lambda t: t.clone().requires_grad_(), _port_mamba_params(w, off != "conv"))
    xp = x.to(torch.bfloat16).requires_grad_()
    planted = {"norm_then_gate": _norm_then_gate, "one_norm": _one_norm}.get(off)
    if planted is not None:
        monkeypatch.setattr(m2, "gated_group_norm", planted)
    got = m2.mamba2_apply(p, xp, DI, H, N, G, chunk=16)
    got.float().backward(dout)
    got_grads = {"x": xp.grad, "in_proj/w": p["in_proj"]["w"].grad,
                 "out_proj/w": p["out_proj"]["w"].grad, "norm/scale": p["norm"]["scale"].grad,
                 "A_log": p["A_log"].grad, "D": p["D"].grad, "dt_bias": p["dt_bias"].grad}
    if off != "conv":
        got_grads.update(conv_w=p["conv_w"].grad, conv_b=p["conv_b"].grad)
    errors = {"out": _rel(got, want), **{k: _rel(g, want_grads[k]) for k, g in got_grads.items()}}
    if off is None:
        assert max(errors.values()) < 0.02, errors
    else:
        assert max(errors.values()) > 0.02, errors


def _recurrence(x, dt, a, b, c):
    """The per-token recurrence in float64: h' = exp(dt a) h + dt B x,
    y = C h, for x (B, S, H, P), dt (B, S, H), a (H,), b and c (B, S, H, N)."""
    x, dt, a, b, c = (t.double() for t in (x, dt, a, b, c))
    bsz, s, h, p = x.shape
    state = x.new_zeros(bsz, h, p, b.shape[-1])
    ys = []
    for t in range(s):
        decay = torch.exp(dt[:, t] * a)[..., None, None]
        state = decay * state + (dt[:, t, :, None] * x[:, t])[..., None] * b[:, t, :, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", state, c[:, t]))
    return torch.stack(ys, dim=1)


def test_the_reference_scan_is_the_per_token_recurrence():
    """``nemotron_h_ref.ssd`` (chunks of 16, the groups' B and C read by 2
    heads each) against the recurrence token by token in float64: within
    1e-5 of the RMS (fp32 rounding through 4 chunks of decay); the port's
    scan too."""
    gen = torch.Generator().manual_seed(8)
    bsz, s = 2, 64
    x = _normal(gen, bsz, s, H, P)
    dt = torch.nn.functional.softplus(_normal(gen, bsz, s, H) - 2)
    a = -_uniform(gen, H, lo=1.0, hi=16.0)
    b, c = _normal(gen, bsz, s, G, N), _normal(gen, bsz, s, G, N)
    want = _recurrence(x, dt, a, b.repeat_interleave(2, 2), c.repeat_interleave(2, 2))
    got = ref.ssd(x, dt, a, b, c, 16, ref.Precision())
    assert _rel(got, want) < 1e-5
    # the port's scan takes dt before the softplus and adds the D skip
    raw = torch.log(torch.expm1(dt))
    port = m2._ssd_scan(x, b.repeat_interleave(2, 2), c.repeat_interleave(2, 2), raw,
                        torch.zeros(H), torch.log(-a), torch.zeros(H), 16)
    assert _rel(port, want) < 1e-5


def test_the_scan_function_gives_the_scans_own_gradients():
    """``mamba2._SSDScan`` (the backward reruns the scan under autograd)
    against autograd through ``_ssd_scan`` itself: the same values and
    gradients, bit for bit."""
    gen = torch.Generator().manual_seed(4)
    args = [_normal(gen, 2, 32, H, P), _normal(gen, 2, 32, H, N), _normal(gen, 2, 32, H, N),
            _normal(gen, 2, 32, H), _normal(gen, H), _normal(gen, H), _normal(gen, H)]
    dy = _normal(gen, 2, 32, H, P)
    one = [t.clone().requires_grad_() for t in args]
    two = [t.clone().requires_grad_() for t in args]
    y1 = m2._SSDScan.apply(*one, 16)
    y1.backward(dy)
    y2 = m2._ssd_scan(*two, 16)
    y2.backward(dy)
    assert torch.equal(y1, y2)
    for t1, t2 in zip(one, two):
        assert torch.equal(t1.grad, t2.grad)


# -- the router and the experts ---------------------------------------------------------------


def _moe_weights(gen, routed=8, held=2, ff=32, sff=64):
    return {"router/w": _normal(gen, D, routed, scale=D ** -0.5),
            "score_bias": 0.05 * _normal(gen, routed),
            "w_up": _normal(gen, held, D, ff, scale=D ** -0.5),
            "w_down": _normal(gen, held, ff, D, scale=ff ** -0.5),
            "shared/up/w": _normal(gen, D, sff, scale=D ** -0.5),
            "shared/down/w": _normal(gen, sff, D, scale=sff ** -0.5)}


def _port_moe_params(w):
    p = {"router": {"w": w["router/w"]}, "w_up": w["w_up"], "w_down": w["w_down"],
         "shared": {"up": {"w": w["shared/up/w"]}, "down": {"w": w["shared/down/w"]}}}
    if "score_bias" in w:
        p["score_bias"] = w["score_bias"]
    if "w_gate" in w:
        p["w_gate"] = w["w_gate"]
    return p


def _moe_grads(p):
    out = {"mlp/router/w": p["router"]["w"].grad, "w_up": p["w_up"].grad,
           "w_down": p["w_down"].grad, "shared/up/w": p["shared"]["up"]["w"].grad,
           "shared/down/w": p["shared"]["down"]["w"].grad}
    return {k.replace("mlp/", ""): v for k, v in out.items()}


@pytest.mark.parametrize("off", [None, "softmax", "bias", "swiglu"])
def test_moe_apply_matches_the_reference_on_its_share(off):
    """The published MoE layer on the second of four shares (experts 2-3 of
    8, top 3 by sigmoid score plus the correction bias, weights
    renormalised and times 2.5, relu^2, the shared expert): the output and
    the gradients of the input and every weight within 2% of the
    reference's RMS (bf16 products, about 0.5% read); with softmax routing,
    the bias left out of the choice, or SwiGLU experts, further."""
    gen = torch.Generator().manual_seed(5)
    w = _moe_weights(gen)
    x = _normal(gen, 2, 64, D).to(torch.bfloat16)
    dout = _normal(gen, 2, 64, D)
    c = {**SMALL}

    leaves = {k: v.clone().requires_grad_(k != "score_bias") for k, v in w.items()}
    xr = x.float().clone().requires_grad_()
    want, _ = ref.moe(leaves, xr, c, ref.Precision())
    want.backward(dout)
    want_grads = {"x": xr.grad, **{k: v.grad for k, v in leaves.items() if k != "score_bias"}}

    opts = {"dropless": True, "score": "sigmoid", "scaling": 2.5, "act": "relu2",
            "expert_first": 2}
    pw = dict(w)
    if off == "softmax":
        opts["score"] = "softmax"
        del pw["score_bias"]
    elif off == "bias":
        del pw["score_bias"]
    elif off == "swiglu":
        opts["act"] = "swiglu"
        pw["w_gate"] = _normal(gen, 2, D, 32, scale=D ** -0.5)
        pw["shared/gate/w"] = _normal(gen, D, 64, scale=D ** -0.5)
    p = _port_moe_params(pw)
    if off == "swiglu":
        p["shared"]["gate"] = {"w": pw["shared/gate/w"]}
    p = M.tree_map(lambda t: t.clone().requires_grad_(), p)
    if "score_bias" in p:
        p["score_bias"].requires_grad_(False)
    xp = x.clone().requires_grad_()
    got = moe.moe_apply(p, xp, 2, 3, **opts)
    got.float().backward(dout)
    got_grads = {"x": xp.grad, "router/w": p["router"]["w"].grad, "w_up": p["w_up"].grad,
                 "w_down": p["w_down"].grad, "shared/up/w": p["shared"]["up"]["w"].grad,
                 "shared/down/w": p["shared"]["down"]["w"].grad}
    errors = {"out": _rel(got, want), **{k: _rel(g, want_grads[k]) for k, g in got_grads.items()}}
    if off is None:
        assert max(errors.values()) < 0.02, errors
    else:
        assert max(errors.values()) > 0.02, errors


def test_route_chooses_by_score_and_bias_and_weights_by_score():
    """``moe.route`` with sigmoid scores against the reference's router on
    the same fp32 input: the same experts (as sets) and weights to fp32
    rounding; with the bias, at least one token's choice differs from the
    choice by score alone."""
    gen = torch.Generator().manual_seed(9)
    w = _moe_weights(gen)
    xf = _normal(gen, 128, D)
    weights, ids, aux = moe.route({"w": w["router/w"]}, xf, 3, 2, score="sigmoid",
                                  bias=w["score_bias"], scaling=2.5)
    assert aux is None
    scores = torch.sigmoid(xf @ w["router/w"])
    want_ids = torch.topk(scores + w["score_bias"], 3).indices
    assert torch.equal(ids.sort(-1).values, want_ids.sort(-1).values)
    want_w = scores.gather(1, ids)
    want_w = want_w / (want_w.sum(-1, keepdim=True) + 1e-20) * 2.5
    torch.testing.assert_close(weights, want_w, rtol=1e-6, atol=0)
    _, plain, _ = moe.route({"w": w["router/w"]}, xf, 3, 2, score="sigmoid")
    assert not torch.equal(plain.sort(-1).values, ids.sort(-1).values)


def test_relu2_grouped_experts_match_per_expert_products():
    """``moe._GroupedExperts`` with relu^2 experts (no ``w_gate``) and rows
    after the last group (choices of experts not held) against autograd
    through a loop over the experts in fp32 on the same bf16 operands:
    within 1% of the RMS, the rows after the last group zero both ways, and
    0 for the weights of an expert with no rows."""
    gen = torch.Generator().manual_seed(3)
    counts = torch.tensor([5, 0, 7, 3])
    held = int(counts.sum())
    ends = torch.cumsum(counts, 0).to(torch.int32)
    xs = _normal(gen, held + 6, 32).to(torch.bfloat16)
    ws = [_normal(gen, 4, 32, 16, scale=32 ** -0.5), _normal(gen, 4, 16, 32, scale=16 ** -0.5)]
    dy = _normal(gen, held + 6, 32)

    x1 = xs.clone().requires_grad_()
    w1 = [t.clone().requires_grad_() for t in ws]
    y1 = moe._GroupedExperts.apply(x1, ends, None, *w1, True)
    y1.float().backward(dy)
    assert (y1[held:] == 0).all() and (x1.grad[held:] == 0).all()
    x2 = xs.float()[:held].clone().requires_grad_()
    w2 = [t.to(torch.bfloat16).float().requires_grad_() for t in ws]
    parts, start = [], 0
    for e, n in enumerate(counts.tolist()):
        rows = x2[start:start + n]
        parts.append(torch.relu(rows @ w2[0][e]).square() @ w2[1][e])
        start += n
    torch.cat(parts).backward(dy[:held])
    assert _rel(y1[:held], torch.cat(parts)) < 0.01
    for got, want in zip([x1.grad[:held], *(t.grad for t in w1)], [x2.grad, *(t.grad for t in w2)]):
        assert _rel(got, want) < 0.01
    for t in w1:
        assert (t.grad[counts == 0] == 0).all()


def test_the_held_shares_add_up_to_the_uncut_layer():
    """The four shares of 2 of 8 experts, summed with the shared expert
    (which every share computes alike) counted once, give the uncut layer
    that holds all 8: in the reference to fp32 rounding, in the port
    within 1% of the RMS (each share's result is rounded to bf16 once)."""
    gen = torch.Generator().manual_seed(13)
    whole = _moe_weights(gen, held=8)
    x = _normal(gen, 2, 64, D).to(torch.bfloat16)

    def ref_share(rank, held):
        w = {**whole, "w_up": whole["w_up"][2 * rank:2 * rank + held] if held == 2
             else whole["w_up"], "w_down": whole["w_down"][2 * rank:2 * rank + held]
             if held == 2 else whole["w_down"]}
        c = {**SMALL, "expert_parallel": {"chips": 8 // held, "rank": rank}}
        return ref.moe(w, x.float(), c, ref.Precision())[0]

    with torch.no_grad():
        shared = ref.relu2(x.float().reshape(-1, D), whole["shared/up/w"],
                           whole["shared/down/w"], ref.Precision()).reshape(2, 64, D)
        shares = sum(ref_share(r, 2) for r in range(4)) - 3 * shared
        uncut = ref_share(0, 8)
        assert _rel(shares, uncut) < 1e-6

        def port(rank, held):
            w = {**whole, "w_up": whole["w_up"][2 * rank:2 * rank + held],
                 "w_down": whole["w_down"][2 * rank:2 * rank + held]}
            opts = {"dropless": True, "score": "sigmoid", "scaling": 2.5, "act": "relu2"}
            if held < 8:
                opts.update(expert_first=2 * rank)
            return moe.moe_apply(_port_moe_params(w), x, held, 3, **opts).float()

        once = relu2_mlp_apply({"up": {"w": whole["shared/up/w"]},
                                "down": {"w": whole["shared/down/w"]}},
                               x.reshape(-1, D)).float().reshape(2, 64, D)
        assert _rel(sum(port(r, 2) for r in range(4)) - 3 * once, port(0, 8)) < 0.01


def test_moe_routed_counts_cover_every_expert_of_the_router():
    """On a share, ``moe.ROUTED`` counts the choices of all 8 of the
    router's experts, the held ones' and the others'."""
    gen = torch.Generator().manual_seed(2)
    w = _moe_weights(gen)
    x = _normal(gen, 1, 32, D).to(torch.bfloat16)
    moe.ROUTED.reset()
    moe.moe_apply(_port_moe_params(w), x, 2, 3, dropless=True, score="sigmoid", act="relu2",
                  expert_first=2)
    assert moe.ROUTED.counts.shape == (8,) and int(moe.ROUTED.counts.sum()) == 32 * 3


# -- attention ----------------------------------------------------------------------------------


def test_nope_attention_at_a_group_of_four_matches_the_reference():
    """GQA with no rotary embedding (``rope_theta`` 0), 8 query heads over 2
    KV heads: the output within 2% of the reference's RMS (bf16 products);
    with RoPE at the published 10,000 (which NemotronH does not apply),
    further."""
    gen = torch.Generator().manual_seed(6)
    w = {"wq/w": _normal(gen, D, 128, scale=D ** -0.5), "wk/w": _normal(gen, D, 32, scale=D ** -0.5),
         "wv/w": _normal(gen, D, 32, scale=D ** -0.5), "wo/w": _normal(gen, 128, D, scale=128 ** -0.5)}
    x = _normal(gen, 2, 64, D)
    want = ref.attention(w, x, {**SMALL}, ref.Precision())
    p = {k.split("/")[0]: {"w": v} for k, v in w.items()}
    xb = x.to(torch.bfloat16)
    assert _rel(attn.gqa_apply(p, xb, 8, 2, 16, rope_theta=0.0, block=16), want) < 0.02
    assert _rel(attn.gqa_apply(p, xb, 8, 2, 16, rope_theta=1e4, block=16), want) > 0.02


# -- the model: layout, train steps, the bias, the refusals ------------------------------------


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
    """The port's params with the norms' scales drawn around 1, Mamba-2's
    A_log and dt_bias, the convolution's bias and the correction bias
    drawn; and the same as the reference's dict."""
    params = M.init_params(cfg, seed, device=CPU)
    gen = torch.Generator().manual_seed(seed + 1)
    for path, leaf in _paths(params):
        last = path.rsplit("/", 1)[-1]
        if last == "scale":
            leaf.copy_(1 + 0.3 * torch.randn(leaf.shape, generator=gen))
        elif last == "A_log":
            leaf.copy_(torch.log(_uniform(gen, *leaf.shape, lo=1.0, hi=16.0)))
        elif last == "dt_bias":
            dt = torch.exp(_uniform(gen, *leaf.shape, lo=math.log(1e-3), hi=math.log(0.1)))
            leaf.copy_(dt + torch.log(-torch.expm1(-dt)))
        elif last in ("conv_b", "score_bias"):
            leaf.copy_(0.1 * torch.randn(leaf.shape, generator=gen))
    return params, {path: leaf.clone() for path, leaf in _paths(params)}


def _tokens(seed, b, s, vocab=256):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, vocab, (b, s + 1), generator=gen)


def test_reference_layout_is_the_ports_tree():
    params = M.init_params(PUBLISHED, 0, device="meta", generator=steps._MetaGenerator())
    port = {path: tuple(leaf.shape) for path, leaf in _paths(params)}
    shapes = ref.param_shapes({**SMALL})
    assert shapes == port
    assert ref.sorted_paths(shapes) == list(port)


def _train(cfg, params, batches):
    step = steps.make_train_step(ArchConfig(model=cfg, smoke=cfg),
                                 ShapeConfig("t", "train", batches[0][0].shape[1], 2))
    opt = init_opt_state(params)
    losses, first = [], None
    for i, (tokens, labels) in enumerate(batches):
        params, opt, metrics = step(params, opt, {"tokens": tokens, "labels": labels})
        losses.append(float(metrics["loss"]))
        if i == 0:
            first = {k: v / (1 - ref.B1) for k, v in _paths(opt["m"])}
    return params, opt, losses, first


def test_three_train_steps_match_the_reference():
    """Three ``make_train_step`` steps (remat on, AdamW, every published
    feature on) against ``nemotron_h_ref.train``'s: each step's loss within
    2e-3 of it, the first gradient of every trained leaf, as AdamW takes it,
    and the norm of every trained leaf's change over the steps within 3% of
    the larger of its norm and the median leaf's (``h100bench``'s training
    check at small widths: bf16 over five blocks of width 64)."""
    params, ref_params = _seeded_params(PUBLISHED)
    start = {k: v.clone() for k, v in ref_params.items()}
    rows = [_tokens(i, 2, 64) for i in range(3)]
    batches = [(r[:, :-1], r[:, 1:]) for r in rows]
    params, _, losses, first = _train(PUBLISHED, params, batches)
    want = ref.train(ref_params, {**SMALL}, batches, 3, initial=start.__getitem__)
    loss_gap = max(abs(a - b) / b for a, b in zip(losses, want["losses"]))
    grads = ref.leaf_norms(first)
    median = float(np.median(list(want["grad"].values())))
    grad_gap = max(abs(grads[k] - g) / max(g, median) for k, g in want["grad"].items())
    deltas = ref.leaf_norms({k: v - start[k] for k, v in _paths(params)})
    median = float(np.median(list(want["delta"].values())))
    delta_gap = max(abs(deltas[k] - g) / max(g, median) for k, g in want["delta"].items())
    gaps = {"loss": loss_gap, "grad": grad_gap, "delta": delta_gap}
    assert gaps["loss"] < 2e-3 and gaps["grad"] < 0.03 and gaps["delta"] < 0.03, gaps


def test_the_correction_bias_takes_no_gradient_and_no_step():
    """Three train steps leave every ``score_bias`` bit for bit as it was,
    with no moments: weight decay, which would shrink a (1, E) stack, does
    not reach it either; every other leaf moves."""
    params, _ = _seeded_params(PUBLISHED)
    before = {k: v.clone() for k, v in _paths(params)}
    rows = [_tokens(i, 2, 32) for i in range(3)]
    params, opt, _, _ = _train(PUBLISHED, params, [(r[:, :-1], r[:, 1:]) for r in rows])
    for path, leaf in _paths(params):
        if path.endswith("score_bias"):
            assert torch.equal(leaf, before[path]), path
            assert not dict(_paths(opt["m"]))[path].any()
            assert not dict(_paths(opt["v"]))[path].any()
        else:
            assert not torch.equal(leaf, before[path]), path


def test_the_fields_leave_every_other_config_and_path_as_it_was():
    """Every new field's default keeps the configs as they were: the
    registry's routing options stay empty and no leaf is a buffer."""
    from repro_torch.configs.registry import ARCHS

    for arch in ARCHS.values():
        for cfg in (arch.model, arch.smoke):
            assert moe.routing_options(cfg) == {}
            M.refuse_one_device_fields(cfg, "nothing")
            params = M.init_params(cfg, 0, device="meta", generator=steps._MetaGenerator())
            assert [p for p, _ in _paths(trainable(params))] == [p for p, _ in _paths(params)]


def test_the_new_fields_are_refused_where_they_are_not_computed():
    """Decode (a convolution state is not kept), the decode cache, the
    sharded steps, the expert-parallel layer and the capacity path refuse
    the new fields, naming them."""
    with pytest.raises(NotImplementedError, match="ModelConfig.block_pattern"):
        M.init_cache(PUBLISHED, 1, 16, device=CPU)
    params = M.init_params(PUBLISHED, 0, device=CPU)
    with pytest.raises(NotImplementedError, match="ModelConfig.ssm_conv"):
        M.decode_step(params, PUBLISHED, None, {"tokens": torch.zeros(1, 1, dtype=torch.int64),
                                                "cur_len": 0})

    class Mesh:                      # passes the steps' mesh check; no collective is reached
        mesh_dim_names = ("data", "model")

        def get_group(self):
            raise AssertionError("a collective was reached")

    arch = ArchConfig(model=PUBLISHED, smoke=PUBLISHED)
    shape = ShapeConfig("t", "train", 32, 2)
    for make in (steps.make_train_step, steps.make_prefill_step, steps.make_serve_step):
        with pytest.raises(NotImplementedError, match="ModelConfig.moe_score"):
            make(arch, shape, Mesh())
    x = torch.zeros(1, 4, 8)
    for field, value in (("score", "sigmoid"), ("scaling", 2.5), ("act", "relu2"),
                         ("expert_first", 2)):
        with pytest.raises(NotImplementedError, match=f"ModelConfig.moe_{field}"):
            moe.moe_ep_apply({}, x, 4, 2, 1.25, None, ("data",), "model", **{field: value})
    w = _port_moe_params(_moe_weights(torch.Generator().manual_seed(1)))
    with pytest.raises(NotImplementedError, match="ModelConfig.moe_act"):
        moe.moe_apply(w, torch.zeros(1, 4, D), 8, 3, act="relu2")
    with pytest.raises(NotImplementedError, match="ModelConfig.moe_router_experts"):
        moe.moe_apply(w, torch.zeros(1, 4, D), 2, 3)


def test_the_pattern_is_checked_against_the_layer_count():
    with pytest.raises(ValueError, match="block_pattern"):
        M.init_params(dataclasses.replace(PUBLISHED, block_pattern="MEM*"), 0, device=CPU)
    with pytest.raises(ValueError, match="block_pattern"):
        M.init_params(dataclasses.replace(PUBLISHED, block_pattern="MEMxE"), 0, device=CPU)
