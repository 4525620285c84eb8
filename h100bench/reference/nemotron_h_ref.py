"""Plain PyTorch train step of NemotronH as published: the equations of
``modeling_nemotron_h.py`` (``NemotronHForCausalLM`` in training) in float32
with TF32 off, or, as the control, with every product's operands in fp8
(``train_ref.Precision``).

It imports nothing of the program.  Each block is one pre-norm residual
mixer, h + mixer(RMSNorm(h)), the mixer named by the block's letter of
``hybrid_override_pattern``:

* ``M``, ``NemotronHMamba2Mixer``: ``in_proj`` to z, xBC and dt; a causal
  depthwise ``nn.Conv1d`` (kernel ``conv_kernel``, with bias) and SiLU over
  xBC; the SSD scan with A = -exp(A_log), dt = softplus(dt + dt_bias), B and
  C shared by the heads of a group, and the D skip; ``MambaRMSNormGated``
  (y * silu(z), an RMSNorm over each of ``n_groups`` groups of channels,
  times the weight); ``out_proj``.  The scan is the chunked SSD of the
  Mamba-2 paper's minimal listing (``ssd_minimal_discrete``: the blocks
  within a chunk from the stable segment sum, the states between chunks
  from one decay matrix over the chunks), run a row at a time so that
  16,384 tokens fit;
* ``E``, ``NemotronHMoE``: ``NemotronHTopkRouter`` (sigmoid scores of fp32
  logits, the top k by score plus ``e_score_correction_bias``, with
  ``n_group`` = ``topk_group`` = 1 no group limit; the weights the chosen
  scores, renormalised with ``norm_topk_prob``, times
  ``routed_scaling_factor``), relu^2 experts down(relu(up(x))^2) by a loop
  over the experts, and the shared relu^2 expert on every token;
* ``*``, ``NemotronHAttention``: GQA with no rotary embedding, a softmax
  at 1/sqrt(head_dim), a few heads at a time.

Departures, each also the program's:

* the chip's share of the experts (``expert_parallel``): the router scores
  all ``n_routed_experts`` experts, the weights hold held =
  ``n_routed_experts`` / ``chips`` of them, experts [rank x held,
  (rank + 1) x held), and a choice of another expert adds nothing; the
  shared expert is computed for every token;
* the correction bias is held fixed (the published recipe updates it
  outside the gradient, by the experts' load: not in the config);
* the loss is the mean next-token cross-entropy in chunks of rows.

Weights come in the benchmark's input layout, the program's tree: a dict of
paths to tensors, ``blocks/<i>/norm/scale`` and ``blocks/<i>/mixer/...``,
matrices as (d_in, d_out), the convolution's taps as (kernel, channels),
the experts as (E, d, ff) and (E, ff, d) stacks.  AdamW is ``train_ref``'s;
the correction bias (``score_bias``) takes no step.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from train_ref import B1, B2, CLIP, EPS, LR, WARMUP, WD, Precision, fp8, leaf_norms, rmsnorm

#: leaves that take no gradient and no optimizer step
BUFFERS = ("score_bias",)
#: query heads a score block holds at once (4 x 8,192^2 fp32 is 1.07 GB)
HEADS_AT_ONCE = 4


# -- shapes ------------------------------------------------------------------------


def kinds(c: dict) -> str:
    """The blocks' letters: the pattern's first ``num_hidden_layers``."""
    return c["hybrid_override_pattern"][:c["num_hidden_layers"]]


def share(c: dict) -> tuple[int, int, int]:
    """(experts held, the router's experts, the first held)."""
    routed = c["n_routed_experts"]
    ep = c.get("expert_parallel", {"chips": 1, "rank": 0})
    held = routed // ep["chips"]
    return held, routed, held * ep["rank"]


def _mixer_shapes(c: dict, kind: str) -> dict[str, tuple]:
    d = c["hidden_size"]
    if kind == "M":
        h, p = c["mamba_num_heads"], c["mamba_head_dim"]
        di, gn = h * p, c["n_groups"] * c["ssm_state_size"]
        return {"A_log": (h,), "D": (h,), "conv_b": (di + 2 * gn,),
                "conv_w": (c["conv_kernel"], di + 2 * gn), "dt_bias": (h,),
                "in_proj/w": (d, 2 * di + 2 * gn + h), "norm/scale": (di,),
                "out_proj/w": (di, d)}
    if kind == "*":
        h, hkv, hd = c["num_attention_heads"], c["num_key_value_heads"], c["head_dim"]
        return {"wk/w": (d, hkv * hd), "wo/w": (h * hd, d), "wq/w": (d, h * hd),
                "wv/w": (d, hkv * hd)}
    held, routed, _ = share(c)
    ff, sff = c["moe_intermediate_size"], c["moe_shared_expert_intermediate_size"]
    sff *= c["n_shared_experts"]
    return {"router/w": (d, routed), "score_bias": (routed,), "shared/down/w": (sff, d),
            "shared/up/w": (d, sff), "w_down": (held, ff, d), "w_up": (held, d, ff)}


def param_shapes(c: dict) -> dict[str, tuple]:
    """Every weight of the configuration in the benchmark's input layout."""
    d, v = c["hidden_size"], c["vocab_size"]
    out = {"embed/table": (v, d), "ln_f/scale": (d,), "unembed/w": (d, v)}
    for i, kind in enumerate(kinds(c)):
        out[f"blocks/{i}/norm/scale"] = (d,)
        out.update({f"blocks/{i}/mixer/{k}": s for k, s in _mixer_shapes(c, kind).items()})
    return out


def sorted_paths(shapes: dict) -> list[str]:
    """The paths in the order of a nest walked with dicts in sorted key
    order and lists in index order."""
    return sorted(shapes, key=lambda path: [(0, int(x), "") if x.isdigit() else (1, 0, x)
                                            for x in path.split("/")])


# -- Mamba-2 -----------------------------------------------------------------------


def _ein(pr: Precision, equation: str, *operands):
    """``torch.einsum``, its operands in fp8 under the control."""
    if pr.control:
        operands = [fp8(t) for t in operands]
    return torch.einsum(equation, *operands)


def segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., T) -> (..., T, T): out[i, j] = x[j+1] + ... + x[i] for j <= i,
    -inf above the diagonal; summed from the masked copies, never as a
    difference of cumulative sums."""
    t = x.shape[-1]
    x = x[..., None].expand(*x.shape, t)                              # x[..., i, j] = x[i]
    below = torch.ones(t, t, dtype=torch.bool, device=x.device).tril(-1)
    sums = torch.cumsum(x.masked_fill(~below, 0), dim=-2)
    keep = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    return sums.masked_fill(~keep, -math.inf)


def ssd_row(x, dt, a, b, c, chunk: int, pr: Precision):
    """One row's scan: x (S, H, P), dt (S, H) after the softplus, a (H,),
    b and c (S, H, N) -> y (S, H, P) without the D skip."""
    s, h, p = x.shape
    n = b.shape[-1]
    nc = s // chunk
    xs = (x * dt[..., None]).reshape(nc, chunk, h, p)
    adt = (dt * a).reshape(nc, chunk, h).permute(2, 0, 1)             # (H, C, L)
    bs, cs = b.reshape(nc, chunk, h, n), c.reshape(nc, chunk, h, n)
    cum = torch.cumsum(adt, dim=-1)
    blocks = torch.exp(segsum(adt))                                   # (H, C, L, L)
    y_diag = _ein(pr, "clhn,cshn,hcls,cshp->clhp", cs, bs, blocks, xs)
    to_end = torch.exp(cum[..., -1:] - cum)                           # (H, C, L)
    states = _ein(pr, "clhn,hcl,clhp->chpn", bs, to_end, xs)
    states = torch.cat([states.new_zeros(1, h, p, n), states])        # (C + 1, H, P, N)
    chunk_decay = torch.exp(segsum(F.pad(cum[..., -1], (1, 0))))      # (H, C + 1, C + 1)
    states = _ein(pr, "hzc,chpn->zhpn", chunk_decay, states)[:-1]
    y_off = _ein(pr, "clhn,chpn,hcl->clhp", cs, states, torch.exp(cum))
    return (y_diag + y_off).reshape(s, h, p)


def ssd(x, dt, a, b, c, chunk: int, pr: Precision):
    """The scan of x (B, S, H, P) with dt (B, S, H), a (H,), b and c
    (B, S, G, N), a group's B and C read by its H / G heads: y (B, S, H, P),
    a row at a time under activation checkpointing."""
    rep = x.shape[2] // b.shape[2]
    b, c = b.repeat_interleave(rep, dim=2), c.repeat_interleave(rep, dim=2)
    return torch.stack([checkpoint(ssd_row, x[i], dt[i], a, b[i], c[i], chunk, pr,
                                   use_reentrant=False) for i in range(x.shape[0])])


def mamba(p, x, c, pr: Precision):
    b, s, _ = x.shape
    h, hp, g, n = (c["mamba_num_heads"], c["mamba_head_dim"], c["n_groups"],
                   c["ssm_state_size"])
    di = h * hp
    conv_dim = di + 2 * g * n
    gate, xbc, dt = torch.split(pr.mm(x, p["in_proj/w"]), [di, conv_dim, h], dim=-1)
    k = c["conv_kernel"]
    weight = p["conv_w"].t().reshape(conv_dim, 1, k)                  # nn.Conv1d's (C, 1, K)
    xbc = F.conv1d(xbc.transpose(1, 2), weight, p["conv_b"], padding=k - 1, groups=conv_dim)
    xbc = F.silu(xbc[..., :s].transpose(1, 2))
    xs, bm, cm = torch.split(xbc, [di, g * n, g * n], dim=-1)
    dt = F.softplus(dt + p["dt_bias"])
    a = -torch.exp(p["A_log"])
    xs = xs.reshape(b, s, h, hp)
    y = ssd(xs, dt, a, bm.reshape(b, s, g, n), cm.reshape(b, s, g, n), c["chunk_size"], pr)
    y = (y + xs * p["D"][:, None]).reshape(b, s, di)
    gated = (y * F.silu(gate)).reshape(b, s, g, di // g)
    gated = gated * torch.rsqrt(gated.pow(2).mean(-1, keepdim=True) + c["layer_norm_epsilon"])
    return pr.mm(p["norm/scale"] * gated.reshape(b, s, di), p["out_proj/w"])


# -- attention -----------------------------------------------------------------------


def _heads(q, k, v, first: int, rep: int, pr: Precision):
    """Causal softmax attention of q (S, n, D), query heads first..first+n,
    against k and v (S, Hkv, D): (S, n, D)."""
    s, n, d = q.shape
    kv = [(first + j) // rep for j in range(n)]
    qh = q.transpose(0, 1)
    kh, vh = k[:, kv].transpose(0, 1), v[:, kv].transpose(0, 1)
    scores = pr.mm(qh, kh.transpose(1, 2)) / math.sqrt(d)
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    weights = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    return pr.mm(weights, vh).transpose(0, 1)


def attention(p, x, c, pr: Precision):
    b, s, _ = x.shape
    h, hkv, hd = c["num_attention_heads"], c["num_key_value_heads"], c["head_dim"]
    q = pr.mm(x, p["wq/w"]).reshape(b, s, h, hd)
    k = pr.mm(x, p["wk/w"]).reshape(b, s, hkv, hd)
    v = pr.mm(x, p["wv/w"]).reshape(b, s, hkv, hd)
    rows = []
    for i in range(b):
        rows.append(torch.cat([
            checkpoint(_heads, q[i, :, f:f + HEADS_AT_ONCE], k[i], v[i], f, h // hkv, pr,
                       use_reentrant=False)
            for f in range(0, h, HEADS_AT_ONCE)], dim=1))
    return pr.mm(torch.stack(rows).reshape(b, s, h * hd), p["wo/w"])


# -- the MoE -------------------------------------------------------------------------


def relu2(x, up, down, pr: Precision):
    return pr.mm(torch.relu(pr.mm(x, up)).square(), down)


def moe(p, x, c, pr: Precision):
    """The held routed experts and the shared expert of one layer: (output,
    top-k ids (T, K) over the router's experts)."""
    b, s, d = x.shape
    held, _, first = share(c)
    xf = x.reshape(b * s, d)
    scores = pr.mm(xf, p["router/w"]).float().sigmoid()
    choice = scores + p["score_bias"]
    topk_idx = torch.topk(choice, c["num_experts_per_tok"], dim=-1, sorted=False)[1]
    topk_weight = scores.gather(1, topk_idx)
    if c["norm_topk_prob"]:
        topk_weight = topk_weight / (topk_weight.sum(dim=-1, keepdim=True) + 1e-20)
    topk_weight = topk_weight * c["routed_scaling_factor"]
    y = torch.zeros_like(xf)
    for j in range(held):
        tokens, slots = torch.where(topk_idx == first + j)
        if tokens.numel():
            out = relu2(xf[tokens], p["w_up"][j], p["w_down"][j], pr)
            y = y.index_add(0, tokens, out * topk_weight[tokens, slots, None])
    y = y + relu2(xf, p["shared/up/w"], p["shared/down/w"], pr)
    return y.reshape(b, s, d), topk_idx


# -- the model -------------------------------------------------------------------------


def block(p, x, c, pr: Precision, kind: str):
    """h + mixer(RMSNorm(h)): (output, the MoE's top-k ids or None)."""
    h = rmsnorm(x, p["norm/scale"], c["layer_norm_epsilon"])
    mixer = {k[len("mixer/"):]: v for k, v in p.items() if k.startswith("mixer/")}
    if kind == "M":
        return x + mamba(mixer, h, c, pr), None
    if kind == "*":
        return x + attention(mixer, h, c, pr), None
    y, ids = moe(mixer, h, c, pr)
    return x + y, ids


def forward(params: dict, c: dict, tokens, pr: Precision, record: list | None = None):
    """The final hidden states (B, S, d), every block under activation
    checkpointing; ``record`` gets each MoE block's top-k ids, sorted per
    token."""
    x = params["embed/table"][tokens.long()]
    for i, kind in enumerate(kinds(c)):
        prefix = f"blocks/{i}/"
        bp = {k[len(prefix):]: v for k, v in params.items() if k.startswith(prefix)}
        x, ids = checkpoint(block, bp, x, c, pr, kind, use_reentrant=False)
        if record is not None and ids is not None:
            record.append(torch.sort(ids, dim=-1).values)
    return rmsnorm(x, params["ln_f/scale"], c["norm_eps"])


def loss(params: dict, c: dict, tokens, labels, pr: Precision, record: list | None = None,
         chunk: int = 1024):
    """Mean next-token cross-entropy of :func:`forward`, in checkpointed
    chunks of rows."""
    x = forward(params, c, tokens, pr, record)
    b, s, d = x.shape
    flat, gold = x.reshape(b * s, d), labels.reshape(b * s).long()

    def part(h, y):
        logits = pr.mm(h, params["unembed/w"])
        return (torch.logsumexp(logits, -1) - logits.gather(1, y[:, None])[:, 0]).sum()

    total = sum(checkpoint(part, flat[i:i + chunk], gold[i:i + chunk], use_reentrant=False)
                for i in range(0, b * s, chunk))
    return total / (b * s)


# -- the step ------------------------------------------------------------------------


def is_buffer(path: str) -> bool:
    return path.rsplit("/", 1)[-1] in BUFFERS


def train(params: dict, c: dict, batches, steps: int = 3, control: bool = False,
          initial=None) -> dict:
    """``steps`` AdamW steps from ``params`` (updated in place, the buffers
    left as they are) on ``batches``.  Returns each step's loss, step 0's
    top-k ids of each MoE block (``routes``, (T, K) sorted per token), the
    norm of each trained leaf's first gradient as the optimizer takes it
    (clipped), the first gradient's global norm (``grad_norm``, before the
    clip), and the norm of each trained leaf's change over the steps
    (``initial()`` gives a leaf's starting value again by path)."""
    pr = Precision(control)
    trained = [k for k in params if not is_buffer(k)]
    m = {k: torch.zeros_like(params[k]) for k in trained}
    vv = {k: torch.zeros_like(params[k]) for k in trained}
    losses, routes, first_grad, first_norm = [], [], None, None
    for t in range(steps):
        live = {k: (v if is_buffer(k) else v.detach().requires_grad_())
                for k, v in params.items()}
        value = loss(live, c, *batches[t], pr, record=routes if t == 0 else None)
        grads = torch.autograd.grad(value, [live[k] for k in trained])
        losses.append(float(value.detach()))
        g = dict(zip(trained, grads))
        gnorm = torch.sqrt(sum(x.double().square().sum() for x in g.values()))
        clip = min(1.0, CLIP / max(float(gnorm), 1e-9))
        lr = LR * t / WARMUP
        with torch.no_grad():
            for path in trained:
                p = params[path]
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
    for path in trained:
        delta.update(leaf_norms({path: params[path] - initial(path)}))
    return {"losses": losses, "routes": routes, "grad": first_grad, "grad_norm": first_norm,
            "delta": delta}
