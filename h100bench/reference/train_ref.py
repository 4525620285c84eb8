"""Plain PyTorch train step for the benchmark's training configurations: the
loss, its gradients and AdamW, in float32 with TF32 off (or, as the control,
in fp8: every product's operands rounded to e4m3 going forward and the
gradients flowing back into them to e5m2, each at a per-tensor scale).

It imports nothing of the program.  It follows the published layer equations
of a ``llama`` decoder (RMSNorm, GQA with RoPE, SwiGLU) and the
configuration's ``assumed`` (RoPE on interleaved pairs).  Weights come in the
benchmark's input layout: a dict of paths to tensors, a stack's layers on a
leading axis.

The optimizer is AdamW as the program configures it: lr 3e-4 under a linear
warm-up from 0 over 200 steps, betas (0.9, 0.95), eps 1e-8, decoupled decay
0.1 on every tensor of two or more dims in that layout (a stack's norm
scales included), global-norm clipping at 1.0.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

LR, B1, B2, EPS, WD, CLIP, WARMUP = 3e-4, 0.9, 0.95, 1e-8, 0.1, 1.0, 200


def _rounded(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` rounded to an fp8 format at a per-tensor scale (its amax to the
    format's largest value), back in fp32."""
    scale = torch.finfo(dtype).max / x.abs().amax().clamp_min(1e-30)
    return (x * scale).to(dtype).float() / scale


class _Fp8(torch.autograd.Function):
    """fp8 training's usual recipe: a product's operands in e4m3 going
    forward, the gradient flowing back into them in e5m2."""

    @staticmethod
    def forward(ctx, x):
        return _rounded(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, grad):
        return _rounded(grad, torch.float8_e5m2)


def fp8(x: torch.Tensor) -> torch.Tensor:
    return _Fp8.apply(x)


class Precision:
    """Products in fp32, or with fp8 operands (the control)."""

    def __init__(self, control: bool = False):
        self.control = control

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.control:
            a, b = fp8(a), fp8(b)
        return a @ b


# -- shapes ------------------------------------------------------------------------


def param_shapes(c: dict) -> dict[str, tuple]:
    """Every weight of the configuration in the benchmark's input layout."""
    d, h, v = c["hidden_size"], c["num_attention_heads"], c["vocab_size"]
    out = {"embed/table": (v, d), "ln_f/scale": (d,), "unembed/w": (d, v)}
    hd = d // h
    hkv = c["num_key_value_heads"]
    ff = c["intermediate_size"]
    n = c["num_hidden_layers"]
    layer = {"attn/wq/w": (d, h * hd), "attn/wk/w": (d, hkv * hd), "attn/wv/w": (d, hkv * hd),
             "attn/wo/w": (h * hd, d), "ln1/scale": (d,), "ln2/scale": (d,),
             "mlp/gate/w": (d, ff), "mlp/up/w": (d, ff), "mlp/down/w": (ff, d)}
    for key, shape in layer.items():
        out[f"layers/{key}"] = (n, *shape)
    return out


def sorted_paths(shapes: dict) -> list[str]:
    """The paths in the order of a nest of dicts walked in sorted key order."""
    return sorted(shapes, key=lambda path: path.split("/"))


# -- the model -------------------------------------------------------------------------


def rmsnorm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope(x, theta):
    """x (B, S, H, D), positions 0..S-1, interleaved pairs."""
    s, dim = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=x.device) / dim)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None, None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1).reshape(x.shape)


def causal_attention(q, k, v, pr: Precision):
    """q (B, S, H, Dq), k (B, S, Hkv, Dq), v (B, S, Hkv, Dv); head h reads
    KV head h // (H / Hkv); softmax in fp32 at 1/sqrt(Dq)."""
    b, s, h, dq = q.shape
    rep = h // k.shape[2]
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    outs = []
    for i in range(b):                    # a row at a time: one (H, S, S) score block
        qi = q[i].transpose(0, 1)
        ki = k[i].transpose(0, 1).repeat_interleave(rep, 0)
        vi = v[i].transpose(0, 1).repeat_interleave(rep, 0)
        scores = pr.mm(qi, ki.transpose(1, 2)) / math.sqrt(dq)
        p = torch.softmax(scores.masked_fill(~mask, float("-inf")), -1)
        outs.append(pr.mm(p, vi).transpose(0, 1))
    return torch.stack(outs)


def swiglu(x, gate, up, down, pr: Precision):
    return pr.mm(F.silu(pr.mm(x, gate)) * pr.mm(x, up), down)


def gqa(p, x, c, pr):
    b, s, _ = x.shape
    h, hkv = c["num_attention_heads"], c["num_key_value_heads"]
    hd = c["hidden_size"] // h
    q = rope(pr.mm(x, p["attn/wq/w"]).reshape(b, s, h, hd), c["rope_theta"])
    k = rope(pr.mm(x, p["attn/wk/w"]).reshape(b, s, hkv, hd), c["rope_theta"])
    v = pr.mm(x, p["attn/wv/w"]).reshape(b, s, hkv, hd)
    return pr.mm(causal_attention(q, k, v, pr).reshape(b, s, h * hd), p["attn/wo/w"])


def layer(p, x, c, pr):
    eps = c["rms_norm_eps"]
    x = x + gqa(p, rmsnorm(x, p["ln1/scale"], eps), c, pr)
    hn = rmsnorm(x, p["ln2/scale"], eps)
    return x + swiglu(hn, p["mlp/gate/w"], p["mlp/up/w"], p["mlp/down/w"], pr)


def loss(params: dict, c: dict, tokens, labels, pr: Precision, chunk: int = 1024):
    """Mean next-token cross-entropy; every layer and loss chunk under
    activation checkpointing, so a step fits beside the fp32 state."""
    x = params["embed/table"][tokens.long()]
    stacked = {k[len("layers/"):]: v for k, v in params.items() if k.startswith("layers/")}
    for i in range(c["num_hidden_layers"]):
        x = checkpoint(layer, {k: v[i] for k, v in stacked.items()}, x, c, pr,
                       use_reentrant=False)
    x = rmsnorm(x, params["ln_f/scale"], c["rms_norm_eps"])
    b, s, d = x.shape
    flat, gold = x.reshape(b * s, d), labels.reshape(b * s).long()

    def part(h, y):
        logits = pr.mm(h, params["unembed/w"])
        return (torch.logsumexp(logits, -1) - logits.gather(1, y[:, None])[:, 0]).sum()

    total = sum(checkpoint(part, flat[i:i + chunk], gold[i:i + chunk], use_reentrant=False)
                for i in range(0, b * s, chunk))
    return total / (b * s)


# -- the step ------------------------------------------------------------------------------


def leaf_norms(tree: dict) -> dict[str, float]:
    """The norm of every leaf, a stack's layers each a leaf of its own."""
    out = {}
    for path, t in tree.items():
        if path.startswith("layers/"):
            for i in range(t.shape[0]):
                out[f"{path}#{i}"] = float(t[i].double().norm())
        else:
            out[path] = float(t.double().norm())
    return out


def train(params: dict, c: dict, batches, steps: int = 3, control: bool = False,
          initial=None) -> dict:
    """``steps`` AdamW steps from ``params`` (updated in place) on
    ``batches`` [(tokens, labels), ...].  Returns each step's loss, the norm
    of each leaf's first gradient as the optimizer takes it (clipped), and
    of each leaf's change over the steps (``initial()`` gives a leaf's
    starting value again by path, so the start need not be kept)."""
    pr = Precision(control)
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    vv = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, first_grad = [], None
    for t in range(steps):
        live = {k: v.detach().requires_grad_() for k, v in params.items()}
        value = loss(live, c, *batches[t], pr)
        grads = torch.autograd.grad(value, list(live.values()))
        losses.append(float(value.detach()))
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
        del g, grads, live
    delta = {}
    for path, p in params.items():
        delta.update(leaf_norms({path: p - initial(path)}))
    return {"losses": losses, "grad": first_grad, "delta": delta}
