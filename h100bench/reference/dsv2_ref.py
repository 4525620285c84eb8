"""Plain PyTorch train step of DeepSeek-V2 as published: the equations of
``modeling_deepseek.py`` (``DeepseekV2ForCausalLM`` in training) in float32
with TF32 off, or, as the control, with every product's operands in fp8
(``train_ref.Precision``).

It imports nothing of the program.  Per decoder layer: RMSNorm; MLA with
no q LoRA (q split into a no-RoPE and a RoPE part, the latent from
``kv_a_proj_with_mqa``, ``kv_a_layernorm`` on it, ``kv_b_proj`` up to
per-head K and V, the RoPE key shared by the heads), YaRN's frequencies
and softmax scale (``DeepseekV2YarnRotaryEmbedding``, ``yarn_get_mscale``),
RoPE on de-interleaved pairs as ``apply_rotary_pos_emb`` takes them; then
RMSNorm and a dense SwiGLU (the first ``first_k_dense_replace`` layers) or
the MoE: softmax gate over the routed experts, greedy top-k, the weights
normalised only with ``norm_topk_prob``, times ``routed_scaling_factor``,
every choice computed (a loop over the experts, nothing dropped), the
shared experts as one SwiGLU, and with ``seq_aux`` the sequence-wise
balance term ``aux_loss_alpha * sum_e f_e * P_e`` per row, averaged over
the rows, added to the loss that is differentiated (what
``AddAuxiliaryLoss`` does).  The reported loss is the cross-entropy alone.

Weights come in the benchmark's input layout, the program's tree: a
dict of paths to tensors, the expert layers stacked on a leading axis
(``layers/...``), the dense ones as ``first_layers/<i>/...``; ``kv_b_proj``
as its two column blocks ``w_uk`` (keys) and ``w_uv`` (values), the experts
as (E, d, ff) and (E, ff, d) stacks, matrices as (d_in, d_out).  AdamW is
``train_ref``'s.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from train_ref import B1, B2, CLIP, EPS, LR, WARMUP, WD, Precision, leaf_norms, rmsnorm

# -- shapes ------------------------------------------------------------------------


def _attn_shapes(c: dict) -> dict[str, tuple]:
    d, h = c["hidden_size"], c["num_attention_heads"]
    nope, rope, vd = c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"]
    lora = c["kv_lora_rank"]
    return {"attn/kv_norm/scale": (lora,), "attn/w_dkv/w": (d, lora + rope),
            "attn/w_uk/w": (lora, h * nope), "attn/w_uv/w": (lora, h * vd),
            "attn/wo/w": (h * vd, d), "attn/wq/w": (d, h * (nope + rope)),
            "ln1/scale": (d,), "ln2/scale": (d,)}


def param_shapes(c: dict) -> dict[str, tuple]:
    """Every weight of the configuration in the benchmark's input layout."""
    d, v = c["hidden_size"], c["vocab_size"]
    ff, eff, n_e = c["intermediate_size"], c["moe_intermediate_size"], c["n_routed_experts"]
    shared = eff * c["n_shared_experts"]
    dense_n = c["first_k_dense_replace"]
    moe_n = c["num_hidden_layers"] - dense_n
    out = {"embed/table": (v, d), "ln_f/scale": (d,), "unembed/w": (d, v)}
    dense = {**_attn_shapes(c), "mlp/gate/w": (d, ff), "mlp/up/w": (d, ff),
             "mlp/down/w": (ff, d)}
    for i in range(dense_n):
        out.update({f"first_layers/{i}/{k}": s for k, s in dense.items()})
    moe = {**_attn_shapes(c), "mlp/router/w": (d, n_e), "mlp/w_gate": (n_e, d, eff),
           "mlp/w_up": (n_e, d, eff), "mlp/w_down": (n_e, eff, d),
           "mlp/shared/gate/w": (d, shared), "mlp/shared/up/w": (d, shared),
           "mlp/shared/down/w": (shared, d)}
    out.update({f"layers/{k}": (moe_n, *s) for k, s in moe.items()})
    return out


def sorted_paths(shapes: dict) -> list[str]:
    """The paths in the order of a nest walked with dicts in sorted key
    order and lists in index order."""
    return sorted(shapes, key=lambda path: [(0, int(x), "") if x.isdigit() else (1, 0, x)
                                            for x in path.split("/")])


# -- YaRN --------------------------------------------------------------------------


def yarn_get_mscale(scale: float = 1.0, mscale: float = 1.0) -> float:
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def yarn_find_correction_dim(num_rotations, dim, base, max_position_embeddings):
    return (dim * math.log(max_position_embeddings / (num_rotations * 2 * math.pi))) / (
        2 * math.log(base))


def yarn_find_correction_range(low_rot, high_rot, dim, base, max_position_embeddings):
    low = math.floor(yarn_find_correction_dim(low_rot, dim, base, max_position_embeddings))
    high = math.ceil(yarn_find_correction_dim(high_rot, dim, base, max_position_embeddings))
    return max(low, 0), min(high, dim - 1)


def yarn_inv_freq(c: dict, device=None) -> torch.Tensor:
    """``DeepseekV2YarnRotaryEmbedding``'s ``inv_freq`` over the RoPE dims."""
    y, dim, base = c["rope_scaling"], c["qk_rope_head_dim"], float(c["rope_theta"])
    exponent = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    freq_extra = 1.0 / (base ** exponent)
    freq_inter = 1.0 / (y["factor"] * base ** exponent)
    low, high = yarn_find_correction_range(y["beta_fast"], y["beta_slow"], dim, base,
                                           y["original_max_position_embeddings"])
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
                       / (high - low), 0, 1)
    inv_freq_mask = 1.0 - ramp
    return freq_inter * (1 - inv_freq_mask) + freq_extra * inv_freq_mask


def softmax_scale(c: dict) -> float:
    scale = (c["qk_nope_head_dim"] + c["qk_rope_head_dim"]) ** -0.5
    y = c["rope_scaling"]
    if y and y.get("mscale_all_dim"):
        m = yarn_get_mscale(y["factor"], y["mscale_all_dim"])
        scale = scale * m * m
    return scale


def cos_sin(c: dict, seq: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(S, D) cos and sin of positions 0..S-1, YaRN's cos/sin scale on them."""
    y = c["rope_scaling"]
    freqs = torch.outer(torch.arange(seq, dtype=torch.float32, device=device),
                        yarn_inv_freq(c, device))
    mscale = yarn_get_mscale(y["factor"], y["mscale"]) / yarn_get_mscale(
        y["factor"], y["mscale_all_dim"])
    emb = torch.cat((freqs, freqs), dim=-1)
    return emb.cos() * mscale, emb.sin() * mscale


def rotate_half(x):
    x1, x2 = x[..., : x.shape[-1] // 2], x[..., x.shape[-1] // 2:]
    return torch.cat((-x2, x1), dim=-1)


def apply_rotary_pos_emb(q, k, cos, sin):
    """q (B, H, S, D), k (B, 1, S, D): pairs (2i, 2i+1) de-interleaved to
    (i, i + D/2), then rotated."""
    b, h, s, d = q.shape
    q = q.view(b, h, s, d // 2, 2).transpose(4, 3).reshape(b, h, s, d)
    b, h, s, d = k.shape
    k = k.view(b, h, s, d // 2, 2).transpose(4, 3).reshape(b, h, s, d)
    return q * cos + rotate_half(q) * sin, k * cos + rotate_half(k) * sin


# -- the layers ---------------------------------------------------------------------


def mla(p, x, c, pr: Precision, rope):
    b, s, _ = x.shape
    h = c["num_attention_heads"]
    nope, rdim, vd = c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"]
    lora = c["kv_lora_rank"]
    q = pr.mm(x, p["attn/wq/w"]).view(b, s, h, nope + rdim).transpose(1, 2)
    q_nope, q_pe = torch.split(q, [nope, rdim], dim=-1)
    compressed = pr.mm(x, p["attn/w_dkv/w"])
    compressed, k_pe = torch.split(compressed, [lora, rdim], dim=-1)
    k_pe = k_pe.view(b, s, 1, rdim).transpose(1, 2)
    latent = rmsnorm(compressed, p["attn/kv_norm/scale"], c["rms_norm_eps"])
    k_nope = pr.mm(latent, p["attn/w_uk/w"]).view(b, s, h, nope).transpose(1, 2)
    value = pr.mm(latent, p["attn/w_uv/w"]).view(b, s, h, vd).transpose(1, 2)
    q_pe, k_pe = apply_rotary_pos_emb(q_pe, k_pe, *rope)
    query = torch.cat([q_nope, q_pe], dim=-1)
    key = torch.cat([k_nope, k_pe.expand(b, h, s, rdim)], dim=-1)
    scale = softmax_scale(c)
    mask = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    outs = []
    for i in range(b):                    # a row at a time: one (H, S, S) score block
        scores = pr.mm(query[i], key[i].transpose(1, 2)) * scale
        weights = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
        outs.append(pr.mm(weights, value[i]).transpose(0, 1))
    return pr.mm(torch.stack(outs).reshape(b, s, h * vd), p["attn/wo/w"])


def swiglu(x, gate, up, down, pr: Precision):
    return pr.mm(F.silu(pr.mm(x, gate)) * pr.mm(x, up), down)


def moe(p, x, c, pr: Precision):
    """The routed and shared experts of one layer: (output, balance term,
    top-k ids (T, K))."""
    b, s, d = x.shape
    k, n_e = c["num_experts_per_tok"], c["n_routed_experts"]
    xf = x.reshape(b * s, d)
    scores = torch.softmax(pr.mm(xf, p["mlp/router/w"]).float(), dim=-1)
    topk_weight, topk_idx = torch.topk(scores, k=k, dim=-1, sorted=False)
    if c["norm_topk_prob"]:
        topk_weight = topk_weight / (topk_weight.sum(dim=-1, keepdim=True) + 1e-20)
    topk_weight = topk_weight * c["routed_scaling_factor"]
    aux = scores.new_zeros(())
    if c["seq_aux"] and c["aux_loss_alpha"]:
        per_row = topk_idx.view(b, -1)
        ce = torch.zeros(b, n_e, device=x.device)
        ce.scatter_add_(1, per_row, torch.ones(b, s * k, device=x.device)).div_(s * k / n_e)
        aux = (ce * scores.view(b, s, -1).mean(dim=1)).sum(dim=1).mean() * c["aux_loss_alpha"]
    flat = topk_idx.view(-1)
    xr = xf.repeat_interleave(k, dim=0)
    y = torch.zeros_like(xr)
    for e in range(n_e):
        rows = flat == e
        if bool(rows.any()):
            y[rows] = swiglu(xr[rows], p["mlp/w_gate"][e], p["mlp/w_up"][e],
                             p["mlp/w_down"][e], pr)
    y = (y.view(b * s, k, d) * topk_weight.unsqueeze(-1)).sum(dim=1)
    y = y + swiglu(xf, p["mlp/shared/gate/w"], p["mlp/shared/up/w"], p["mlp/shared/down/w"], pr)
    return y.view(b, s, d), aux, topk_idx


def dense_layer(p, x, c, pr, rope):
    eps = c["rms_norm_eps"]
    x = x + mla(p, rmsnorm(x, p["ln1/scale"], eps), c, pr, rope)
    hn = rmsnorm(x, p["ln2/scale"], eps)
    return x + swiglu(hn, p["mlp/gate/w"], p["mlp/up/w"], p["mlp/down/w"], pr)


def moe_layer(p, x, c, pr, rope):
    """One expert layer: (output, balance term, top-k ids)."""
    eps = c["rms_norm_eps"]
    x = x + mla(p, rmsnorm(x, p["ln1/scale"], eps), c, pr, rope)
    y, aux, ids = moe(p, rmsnorm(x, p["ln2/scale"], eps), c, pr)
    return x + y, aux, ids


def forward(params: dict, c: dict, tokens, pr: Precision, record: list | None = None,
            aux_record: list | None = None):
    """(final hidden states (B, S, d), the balance terms summed over the
    layers); every layer under activation checkpointing.  ``record`` gets
    each expert layer's top-k ids, sorted per token, and ``aux_record`` its
    balance term."""
    x = params["embed/table"][tokens.long()]
    rope = cos_sin(c, tokens.shape[1], x.device)
    aux_total = x.new_zeros(())
    for i in range(c["first_k_dense_replace"]):
        prefix = f"first_layers/{i}/"
        lp = {k[len(prefix):]: v for k, v in params.items() if k.startswith(prefix)}
        x = checkpoint(dense_layer, lp, x, c, pr, rope, use_reentrant=False)
    stacked = {k[len("layers/"):]: v for k, v in params.items() if k.startswith("layers/")}
    for i in range(c["num_hidden_layers"] - c["first_k_dense_replace"]):
        x, aux, ids = checkpoint(moe_layer, {k: v[i] for k, v in stacked.items()}, x, c, pr,
                                 rope, use_reentrant=False)
        aux_total = aux_total + aux
        if aux_record is not None:
            aux_record.append(float(aux.detach()))
        if record is not None:
            record.append(torch.sort(ids, dim=-1).values)
    return rmsnorm(x, params["ln_f/scale"], c["rms_norm_eps"]), aux_total


def loss(params: dict, c: dict, tokens, labels, pr: Precision, record: list | None = None,
         chunk: int = 1024, aux_record: list | None = None):
    """(mean next-token cross-entropy, the balance terms summed over the
    layers) of :func:`forward`, the loss in checkpointed chunks of rows."""
    x, aux_total = forward(params, c, tokens, pr, record, aux_record)
    b, s, d = x.shape
    flat, gold = x.reshape(b * s, d), labels.reshape(b * s).long()

    def part(h, y):
        logits = pr.mm(h, params["unembed/w"])
        return (torch.logsumexp(logits, -1) - logits.gather(1, y[:, None])[:, 0]).sum()

    total = sum(checkpoint(part, flat[i:i + chunk], gold[i:i + chunk], use_reentrant=False)
                for i in range(0, b * s, chunk))
    return total / (b * s), aux_total


# -- the step ------------------------------------------------------------------------


def train(params: dict, c: dict, batches, steps: int = 3, control: bool = False,
          initial=None) -> dict:
    """``steps`` AdamW steps from ``params`` (updated in place) on
    ``batches``; the gradient is that of the cross-entropy plus the balance
    terms.  Returns each step's cross-entropy and balance terms summed over
    the layers (and each layer's, ``aux_layers``), step 0's top-k ids of
    each expert layer (``routes``, (T, K) sorted per token), the norm of
    each leaf's first gradient as the optimizer takes it (clipped), the
    first gradient's global norm (``grad_norm``, before the clip), and the
    norm of each leaf's change over the steps (``initial()`` gives a leaf's
    starting value again by path)."""
    pr = Precision(control)
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    vv = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, auxes, aux_layers, routes, first_grad = [], [], [], [], None
    for t in range(steps):
        live = {k: v.detach().requires_grad_() for k, v in params.items()}
        aux_layers.append([])
        ce, aux = loss(live, c, *batches[t], pr, record=routes if t == 0 else None,
                       aux_record=aux_layers[-1])
        grads = torch.autograd.grad(ce + aux, list(live.values()))
        losses.append(float(ce.detach()))
        auxes.append(float(aux.detach()))
        g = dict(zip(live, grads))
        gnorm = torch.sqrt(sum(x.double().square().sum() for x in g.values()))
        clip = min(1.0, CLIP / max(float(gnorm), 1e-9))
        lr = LR * t / WARMUP
        with torch.no_grad():
            for path, p in params.items():
                gp = g[path] * clip
                m[path].mul_(B1).add_(gp, alpha=1 - B1)
                vv[path].mul_(B2).addcmul_(gp, gp, value=1 - B2)
                direction = (m[path] / (1 - B1 ** (t + 1))) / (
                    (vv[path] / (1 - B2 ** (t + 1))).sqrt() + EPS)
                if p.ndim >= 2:
                    direction = direction + WD * p
                p.sub_(lr * direction)
        if t == 0:
            first_grad = leaf_norms({k: x * clip for k, x in g.items()})
            first_norm = float(gnorm)
        del g, grads, live
    delta = {}
    for path, p in params.items():
        delta.update(leaf_norms({path: p - initial(path)}))
    return {"losses": losses, "aux": auxes, "aux_layers": aux_layers, "routes": routes,
            "grad": first_grad, "grad_norm": first_norm, "delta": delta}
