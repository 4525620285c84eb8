"""Unified LM: one config dataclass + family-dispatched build/forward/decode
(PyTorch port of ``repro.models.model``).

Families:
  dense   llama-style GQA decoder (yi, minitron, qwen1.5, starcoder2;
          llava = dense + vision_stub frontend)
  moe     dense skeleton with MoE FFN (dbrx; deepseek = moe + MLA)
  hybrid  zamba2: mamba2 backbone + one *shared* attention block applied
          every ``shared_attn_every`` layers on concat(h, embeddings)
  xlstm   alternating mLSTM / sLSTM blocks (1 sLSTM per ``slstm_every``)
  encdec  whisper: bidirectional encoder over stub frame embeddings +
          causal decoder with cross attention
  pattern NemotronH: one pre-norm residual mixer a block, h + mixer(RMSNorm(h)),
          the mixer named by the block's letter of ``block_pattern``: ``M``
          Mamba-2 (published: the convolution and the gated group norm),
          ``E`` MoE (sigmoid routing, relu^2 experts, a shared expert),
          ``*`` GQA attention (``rope_theta`` 0: no positions)

Entry points used by the launcher:
  init_params(cfg, seed, device)             -> params
  forward(params, cfg, batch)                -> final hidden states
  loss_fn(params, cfg, batch)                -> scalar CE
  init_cache(cfg, batch, max_len, device=)   -> decode cache
  decode_step(params, cfg, cache, batch)     -> (logits, cache)

Params and caches keep the reference's tree layout (stacked layers with a
leading axis, the hybrid family's (groups, per_group) axes, the xLSTM
blocks as a list and their cache as a list of tuples), so either package's
trees carry across through :mod:`repro_torch.models.convert`.  Inits draw
from one ``torch.Generator`` seeded by ``seed`` on ``device``; the numbers
differ from ``jax.random``'s.  ``device`` defaults to CUDA, which raises
without a GPU; pass ``device="cpu"`` to run the plain versions there.

``cfg.remat`` runs under ``torch.utils.checkpoint`` where the reference
puts ``jax.checkpoint``: each layer of a stack, each xLSTM block, each
Mamba2 layer of a hybrid group and the shared block; only while autograd
records, so serving is unchanged.  The reference's sharding arguments
(``ep_spec``, ``resid``, ``attn_specs``) carry the sharded step's context
on a mesh (:mod:`repro_torch.parallel.spmd`): ``params`` are then local
shards, the batch rows are this rank's, and the residual stream holds the
rank's slice of the sequence; every module gathers what it needs where it
uses it, and ``loss_fn`` returns the rank's share of the mean.  With none
given, the model runs on one device as before.
Decode writes every attention cache and SSM state in place and returns
the cache; ``decode_step`` takes ``cur_len`` as an int or a 0-d tensor and
turns it into a 0-d tensor on the model's device once, so no step reads a
value back to the host and a step traces on ``meta`` tensors (the
dry-run).  On a mesh ``decode_step`` takes ``resid``, the sharded decode's
batch sharding: the caches are then this rank's shards as ``cache_specs``
places them (:mod:`repro_torch.models.attention` attends them where they
lie).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch import DEFAULT_DEVICE
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba2 as m2
from repro_torch.models import moe as moe_mod
from repro_torch.models import transformer as tf
from repro_torch.models import xlstm as xl
from repro_torch.parallel import spmd
from repro_torch.models.layers import (
    Params,
    Yarn,
    chunked_cross_entropy,
    dense_apply,
    dense_init,
    embed_apply,
    embed_init,
    gelu_mlp_apply,
    rmsnorm_apply,
    rmsnorm_init,
    tree_map,
)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | xlstm | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 => d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    mlp_kind: str = "swiglu"       # swiglu | gelu
    attn_block: int = 512          # blockwise-attention KV tile
    loss_chunk: int = 128          # chunked-CE sequence tile
    remat: bool = True
    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_shared: int = 0
    moe_d_ff: int = 0
    moe_dense_first_n: int = 0     # leading layers with a dense FFN (deepseek)
    capacity_factor: float = 1.25
    moe_dense_fallback: bool = False
    # DeepSeek-V2's published routing; the defaults keep the capacity path.
    # The registry's deepseek-v2-lite-16b and its smoke preset leave these
    # three, mla_kv_norm and rope_yarn at their defaults: the tests hold them
    # against the JAX package's, which has none of the five (configs/
    # registry.py is a verbatim copy of its file); the published model is
    # h100bench/configs/deepseek-v2-lite-5l.json.
    moe_norm_topk: bool = True     # top-k weights renormalised to sum 1
    moe_aux_alpha: float = 0.0     # sequence-wise balance loss (``seq_aux``) weight
    moe_dropless: bool = False     # every choice computed: grouped products, no capacity
    # MLA
    mla_kv_lora: int = 0
    mla_qk_nope: int = 128
    mla_qk_rope: int = 64
    mla_v_head: int = 128
    mla_kv_norm: bool = False      # RMSNorm on the latent (``kv_a_layernorm``)
    rope_yarn: Yarn | None = None  # YaRN frequencies and softmax scale (``rope_scaling``)
    # SSM / hybrid
    ssm_state: int = 0
    ssm_expansion: int = 2
    ssm_heads: int = 0             # 0 => d_inner // 64
    ssm_groups: int = 1
    ssm_chunk: int = 128
    shared_attn_every: int = 0     # zamba2: shared block cadence
    ssm_head_dim: int = 0          # d_inner = ssm_heads * this (0 => d_model * ssm_expansion)
    ssm_conv: int = 0              # the published mixer: conv over x, B, C (its kernel), then
                                   # gate and RMSNorm a group (0 = no conv, norm all, then gate)
    # NemotronH (family "pattern"); the defaults keep every other config as it was,
    # and the registry (a verbatim copy of the JAX package's) has none of these
    block_pattern: str = ""        # one letter a block: M mamba2, E moe, * attention
    moe_score: str = "softmax"     # | "sigmoid": scores, a correction bias (a buffer:
                                   # layers.BUFFERS) for the choice alone
    moe_scaling: float = 1.0       # routed_scaling_factor on the top-k weights
    moe_act: str = "swiglu"        # | "relu2": down(relu(up(x))^2), routed and shared
    moe_d_ff_shared: int = 0       # a shared expert's width (0 => moe_d_ff)
    moe_router_experts: int = 0    # the router's experts, of which moe_experts are held
    moe_expert_first: int = 0      # the first held expert
    # xLSTM
    slstm_every: int = 0           # 1 sLSTM per this many blocks (0 = none)
    xlstm_pf: float = 2.0
    # enc-dec
    enc_layers: int = 0
    # frontend stubs
    frontend: str | None = None    # audio_stub | vision_stub
    frontend_tokens: int = 0       # vision: patch tokens prepended

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def d_inner(self) -> int:
        if self.ssm_head_dim:
            return self.ssm_heads * self.ssm_head_dim
        return self.d_model * self.ssm_expansion

    @property
    def n_ssm_heads(self) -> int:
        return self.ssm_heads or self.d_inner // 64

    def param_count(self) -> int:
        """Approximate parameter count N (embeddings included)."""
        d, v = self.d_model, self.vocab
        total = 2 * v * d  # embed + unembed
        if self.family in ("dense", "moe"):
            per = self._attn_params() + self._ffn_params()
            total += self.n_layers * per
            if self.moe_dense_first_n:
                total += self.moe_dense_first_n * (
                    3 * d * self.d_ff - self._ffn_params_moe()
                )
        elif self.family == "hybrid":
            total += self.n_layers * self._mamba_params()
            total += self._shared_block_params()
        elif self.family == "pattern":
            total += sum(self._block_params(kind, self.moe_experts)
                         for kind in self.block_pattern)
        elif self.family == "xlstm":
            di = int(d * self.xlstm_pf)
            n_s = self.n_layers // self.slstm_every if self.slstm_every else 0
            n_m = self.n_layers - n_s
            total += n_m * (2 * d * di + 3 * di * di + di * d)
            total += n_s * (4 * d * d + 4 * d * (d // max(self.n_heads, 1)) + 2 * d * int(d * 4 / 3) + int(d * 4 / 3) * d)
        elif self.family == "encdec":
            enc = self.enc_layers * (self._attn_params() + 2 * d * self.d_ff)
            dec = self.n_layers * (2 * self._attn_params() + 2 * d * self.d_ff)
            total += enc + dec
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k + shared experts only)."""
        if not self.moe_experts:
            return self.param_count()
        d, v = self.d_model, self.vocab
        if self.family == "pattern":
            return 2 * v * d + sum(self._block_params(kind, self.moe_top_k)
                                   for kind in self.block_pattern)
        total = 2 * v * d
        per = self._attn_params() + (
            (self.moe_top_k + self.moe_shared) * 3 * d * self.moe_d_ff
            + d * self.moe_experts
        )
        total += self.n_layers * per
        return total

    def _attn_params(self) -> int:
        d = self.d_model
        if self.mla_kv_lora:
            return (
                d * self.n_heads * (self.mla_qk_nope + self.mla_qk_rope)
                + d * (self.mla_kv_lora + self.mla_qk_rope)
                + self.mla_kv_lora * self.n_heads * (self.mla_qk_nope + self.mla_v_head)
                + self.n_heads * self.mla_v_head * d
                + (self.mla_kv_lora if self.mla_kv_norm else 0)
            )
        return d * self.head_dim * (2 * self.n_heads + 2 * self.n_kv_heads)

    def _ffn_params(self) -> int:
        if self.moe_experts:
            return self._ffn_params_moe()
        mult = 3 if self.mlp_kind == "swiglu" else 2
        return mult * self.d_model * self.d_ff

    def _ffn_params_moe(self) -> int:
        d = self.d_model
        return (
            self.moe_experts * 3 * d * self.moe_d_ff
            + self.moe_shared * 3 * d * self.moe_d_ff
            + d * self.moe_experts
        )

    def _mamba_params(self) -> int:
        d, di = self.d_model, self.d_inner
        return d * (2 * di + 2 * self.ssm_groups * self.ssm_state + self.n_ssm_heads) + di * d

    def _block_params(self, kind: str, experts: int) -> int:
        """A pattern block's matrices, ``experts`` routed experts counted in
        an ``E`` block (norms, biases and the SSM's per-head vectors are left
        out, as the other families leave them)."""
        d = self.d_model
        if kind == "M":
            conv = self.ssm_conv * (self.d_inner + 2 * self.ssm_groups * self.ssm_state)
            return self._mamba_params() + conv
        if kind == "*":
            return self._attn_params()
        mult = 3 if self.moe_act == "swiglu" else 2
        shared = self.moe_shared * (self.moe_d_ff_shared or self.moe_d_ff)
        return mult * d * (experts * self.moe_d_ff + shared) + d * (
            self.moe_router_experts or self.moe_experts)

    def _shared_block_params(self) -> int:
        d2 = 2 * self.d_model
        return d2 * d2 * 4 + 2 * d2 * self.d_ff + self.d_ff * d2


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, seed: int = 0,
                device: str | torch.device = DEFAULT_DEVICE,
                generator: torch.Generator | None = None) -> Params:
    """Seeded params of ``cfg`` on ``device``, fp32 master weights.  A
    ``generator`` given is used as it is (its ``device`` places the
    tensors; ``launch.steps.params_struct`` passes one that reads ``meta``)."""
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator(device=dev)
    gen.manual_seed(seed)
    p: Params = {
        "embed": embed_init(gen, cfg.vocab, cfg.d_model),
        "ln_f": rmsnorm_init(cfg.d_model, device=dev),
        "unembed": dense_init(gen, cfg.d_model, cfg.vocab, scale=1.0 / math.sqrt(cfg.d_model)),
    }
    if cfg.family in ("dense", "moe"):
        n_scan = cfg.n_layers - cfg.moe_dense_first_n
        p["layers"] = tf.stacked_init(gen, n_scan, lambda g: tf.decoder_layer_init(g, cfg))
        if cfg.moe_dense_first_n:
            dense_cfg = dataclasses.replace(cfg, moe_experts=0)
            p["first_layers"] = [tf.decoder_layer_init(gen, dense_cfg)
                                 for _ in range(cfg.moe_dense_first_n)]
    elif cfg.family == "hybrid":
        groups = cfg.n_layers // cfg.shared_attn_every
        per_group = cfg.shared_attn_every
        flat = tf.stacked_init(gen, groups * per_group, lambda g: m2.mamba2_init(
            g, cfg.d_model, cfg.d_inner, cfg.n_ssm_heads, cfg.ssm_state, cfg.ssm_groups))
        p["groups"] = tree_map(lambda a: a.reshape(groups, per_group, *a.shape[1:]), flat)
        p["group_norms"] = {"scale": torch.ones((groups, per_group, cfg.d_model),
                                                dtype=torch.float32, device=dev)}
        p["shared"] = _shared_block_init(gen, cfg)
    elif cfg.family == "xlstm":
        # block kinds are derived from cfg (_xlstm_kinds), not stored in the tree
        p["blocks"] = []
        for kind in _xlstm_kinds(cfg):
            if kind == "m":
                block = xl.mlstm_init(gen, cfg.d_model, cfg.n_heads, cfg.xlstm_pf)
            else:
                block = xl.slstm_init(gen, cfg.d_model, cfg.n_heads)
            p["blocks"].append({"ln": rmsnorm_init(cfg.d_model, device=dev), "p": block})
    elif cfg.family == "pattern":
        p["blocks"] = [{"norm": rmsnorm_init(cfg.d_model, device=dev),
                        "mixer": _mixer_init(gen, cfg, kind)} for kind in _pattern_kinds(cfg)]
    elif cfg.family == "encdec":
        p["enc_layers"] = tf.stacked_init(gen, cfg.enc_layers,
                                          lambda g: tf.encoder_layer_init(g, cfg))
        p["dec_layers"] = tf.stacked_init(gen, cfg.n_layers,
                                          lambda g: tf.cross_decoder_layer_init(g, cfg))
        p["ln_enc"] = rmsnorm_init(cfg.d_model, device=dev)
    else:
        raise ValueError(cfg.family)
    if cfg.frontend == "vision_stub":
        p["patch_proj"] = dense_init(gen, cfg.d_model, cfg.d_model)
    return p


def _xlstm_kinds(cfg: ModelConfig) -> list[str]:
    if not cfg.slstm_every:
        return ["m"] * cfg.n_layers
    return ["s" if (i + 1) % cfg.slstm_every == 0 else "m" for i in range(cfg.n_layers)]


def _pattern_kinds(cfg: ModelConfig) -> str:
    """The pattern family's block letters, one a layer."""
    if len(cfg.block_pattern) != cfg.n_layers or set(cfg.block_pattern) - set("ME*"):
        raise ValueError(f"block_pattern {cfg.block_pattern!r}: {cfg.n_layers} letters of "
                         "M, E and * expected")
    return cfg.block_pattern


def _mixer_init(gen: torch.Generator, cfg: ModelConfig, kind: str) -> Params:
    if kind == "M":
        return m2.mamba2_init(gen, cfg.d_model, cfg.d_inner, cfg.n_ssm_heads, cfg.ssm_state,
                              cfg.ssm_groups, conv_kernel=cfg.ssm_conv)
    if kind == "*":
        return attn_mod.gqa_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                                 qkv_bias=cfg.qkv_bias)
    return moe_mod.moe_init(gen, cfg.d_model, cfg.moe_d_ff, cfg.moe_experts,
                            n_shared=cfg.moe_shared, d_ff_shared=cfg.moe_d_ff_shared or None,
                            act=cfg.moe_act, router_experts=cfg.moe_router_experts,
                            score=cfg.moe_score)


#: the fields that only one device's training and prefill take
_ONE_DEVICE_FIELDS = ("block_pattern", "ssm_head_dim", "ssm_conv", "moe_score", "moe_scaling",
                      "moe_act", "moe_d_ff_shared", "moe_router_experts", "moe_expert_first")


def refuse_one_device_fields(cfg: ModelConfig, what: str) -> None:
    """Raise ``NotImplementedError`` naming the fields of ``cfg`` that ``what``
    does not take: the pattern family's and its mixers' (decode needs a
    convolution state beside the SSM state and the KV cache; a mesh, their
    shardings)."""
    defaults = {f.name: f.default for f in dataclasses.fields(ModelConfig)}
    fields = [f"ModelConfig.{name}" for name in _ONE_DEVICE_FIELDS
              if getattr(cfg, name) != defaults[name]]
    if fields:
        raise NotImplementedError(f"{what} does not take {', '.join(fields)}")


def _shared_block_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Zamba2 shared transformer block over concat(h, embed) (2*d_model)."""
    d2 = 2 * cfg.d_model
    return {
        "ln1": rmsnorm_init(d2, device=gen.device),
        "attn": attn_mod.gqa_init(gen, d2, cfg.n_heads, cfg.n_kv_heads, d2 // cfg.n_heads),
        "down": dense_init(gen, d2, cfg.d_model, scale=1.0 / math.sqrt(d2)),
        "ln2": rmsnorm_init(cfg.d_model, device=gen.device),
        "mlp": {
            "gate": dense_init(gen, cfg.d_model, cfg.d_ff),
            "up": dense_init(gen, cfg.d_model, cfg.d_ff),
            "down": dense_init(gen, cfg.d_ff, cfg.d_model, scale=1.0 / math.sqrt(cfg.d_ff)),
        },
    }


# ---------------------------------------------------------------------------
# forward (training and prefill)
# ---------------------------------------------------------------------------


def _embed_inputs(params, cfg: ModelConfig, batch, resid=None) -> torch.Tensor:
    """The input embeddings; on a mesh, this rank's slice of the sequence
    (the whole rows are embedded, then cut)."""
    x = embed_apply(tf.whole_layer(params["embed"], resid), batch["tokens"])
    if cfg.frontend == "vision_stub":
        patches = dense_apply(tf.whole_layer(params["patch_proj"], resid), batch["patch_embeds"])
        x = torch.cat([patches.to(x.dtype), x], dim=1)
    sp = spmd.context(resid)
    return x if sp is None else sp.slice_seq(x)


def forward(params: Params, cfg: ModelConfig, batch: dict, ep_spec=None, resid=None,
            attn_specs=None) -> torch.Tensor:
    """Token/frontend inputs -> final hidden states (B, S, d); on a mesh,
    this rank's rows and slice of the sequence."""
    if cfg.family == "encdec":
        return _forward_encdec(params, cfg, batch, resid=resid, attn_specs=attn_specs)
    x = _embed_inputs(params, cfg, batch, resid)
    if cfg.family in ("dense", "moe"):
        dense_cfg = dataclasses.replace(cfg, moe_experts=0)
        for lp in params.get("first_layers", []):
            x = tf.decoder_layer_apply(lp, x, dense_cfg, resid=resid)
        x = tf.scan_stack(params["layers"], x,
                          lambda lp, h: tf.decoder_layer_apply(
                              lp, h, cfg, ep_spec=ep_spec, attn_specs=attn_specs, resid=resid),
                          remat=cfg.remat, constraint=resid)
    elif cfg.family == "hybrid":
        x = _forward_hybrid(params, cfg, x, resid=resid, attn_specs=attn_specs)
    elif cfg.family == "pattern":
        if resid is not None:
            refuse_one_device_fields(cfg, "a forward on a mesh")
        x = _forward_pattern(params, cfg, x)
    elif cfg.family == "xlstm":
        sp = spmd.context(resid)

        def on_whole_rows(fn):
            # no hint in the reference: the scans run on the whole sequence
            return fn if sp is None else (
                lambda p, h: sp.whole_sequence(lambda hh: fn(sp.gather(p), hh), h))

        mlstm = tf.remat_if(cfg.remat, on_whole_rows(lambda p, h: xl.mlstm_apply(
            p, h, cfg.n_heads, cfg.xlstm_pf, cfg.ssm_chunk)))
        slstm = tf.remat_if(cfg.remat, on_whole_rows(
            lambda p, h: xl.slstm_apply(p, h, cfg.n_heads)))
        for kind, blk in zip(_xlstm_kinds(cfg), params["blocks"]):
            h = rmsnorm_apply(tf.whole_layer(blk["ln"], resid), x, cfg.norm_eps)
            x = x + (mlstm if kind == "m" else slstm)(blk["p"], h)
    else:
        raise ValueError(cfg.family)
    return rmsnorm_apply(tf.whole_layer(params["ln_f"], resid), x, cfg.norm_eps)


def _shared_mlp(shared: Params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    hn = rmsnorm_apply(shared["ln2"], h, cfg.norm_eps)
    g = dense_apply(shared["mlp"]["gate"], hn)
    u = dense_apply(shared["mlp"]["up"], hn)
    return h + dense_apply(shared["mlp"]["down"], F.silu(g) * u)


def _forward_hybrid(params, cfg: ModelConfig, x: torch.Tensor, resid=None,
                    attn_specs=None) -> torch.Tensor:
    attn_specs = attn_specs or {}
    emb = x  # original embeddings feed every shared-block invocation
    d2 = 2 * cfg.d_model

    def mamba_layer(lp, h):
        norm_p, m_p = tf.whole_layer(lp, resid)
        hn = rmsnorm_apply(norm_p, h, cfg.norm_eps)
        return h + m2.mamba2_apply(m_p, hn, cfg.d_inner, cfg.n_ssm_heads, cfg.ssm_state,
                                   cfg.ssm_groups, chunk=cfg.ssm_chunk,
                                   h_spec=attn_specs.get("ssm_h"), resid=resid)

    def shared_block(h):
        shared = tf.whole_layer(params["shared"], resid)
        cb = torch.cat([h, emb], dim=-1)
        a = attn_mod.gqa_apply(shared["attn"], rmsnorm_apply(shared["ln1"], cb, cfg.norm_eps),
                               cfg.n_heads, cfg.n_kv_heads, d2 // cfg.n_heads,
                               rope_theta=cfg.rope_theta, block=cfg.attn_block,
                               q_spec=attn_specs.get("q"), kv_spec=attn_specs.get("kv"),
                               resid=resid)
        return _shared_mlp(shared, h + dense_apply(shared["down"], a), cfg)

    mamba_layer = tf.remat_if(cfg.remat, mamba_layer)
    shared_block = tf.remat_if(cfg.remat, shared_block)
    per_group = cfg.shared_attn_every
    h = x
    # the (groups, per_group) layers in order, one unbind per leaf
    layers = tf.unstack_on((params["group_norms"], params["groups"]), resid, axes=2)
    for i, lp in enumerate(layers):
        h = mamba_layer(lp, h)
        if (i + 1) % per_group == 0:
            h = shared_block(h)
    return h


def _forward_pattern(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The blocks in order, each h + mixer(RMSNorm(h)) under remat."""

    def mamba(mixer, h):
        return m2.mamba2_apply(mixer, h, cfg.d_inner, cfg.n_ssm_heads, cfg.ssm_state,
                               cfg.ssm_groups, chunk=cfg.ssm_chunk, norm_eps=cfg.norm_eps)

    def experts(mixer, h):
        return moe_mod.moe_apply(mixer, h, cfg.moe_experts, cfg.moe_top_k,
                                 capacity_factor=cfg.capacity_factor,
                                 **moe_mod.routing_options(cfg))

    def attention(mixer, h):
        return attn_mod.gqa_apply(mixer, h, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                                  rope_theta=cfg.rope_theta, block=cfg.attn_block)

    mixers = {"M": mamba, "E": experts, "*": attention}

    def block(kind):
        def one(blk, h):
            return h + mixers[kind](blk["mixer"], rmsnorm_apply(blk["norm"], h, cfg.norm_eps))
        return tf.remat_if(cfg.remat, one)

    blocks = {kind: block(kind) for kind in "ME*"}
    for kind, blk in zip(_pattern_kinds(cfg), params["blocks"]):
        x = blocks[kind](blk, x)
    return x


def _sinusoid(s: int, d: int, device) -> torch.Tensor:
    pos = torch.arange(s, device=device)[:, None].float()
    i = torch.arange(d // 2, device=device)[None, :].float()
    ang = pos / torch.pow(10000.0, 2 * i / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def encode(params, cfg: ModelConfig, frames: torch.Tensor, resid=None,
           attn_specs=None) -> torch.Tensor:
    """Whisper's encoder over stub frame embeddings (B, S_enc, d) -> (B, S_enc, d);
    on a mesh, this rank's slice of the encoder sequence."""
    frames = frames.to(torch.bfloat16)
    enc = frames + _sinusoid(frames.shape[1], cfg.d_model, frames.device).to(torch.bfloat16)
    sp = spmd.context(resid)
    if sp is not None:
        enc = sp.slice_seq(enc)
    enc = tf.scan_stack(params["enc_layers"], enc,
                        lambda lp, h: tf.encoder_layer_apply(lp, h, cfg, attn_specs=attn_specs,
                                                             resid=resid),
                        remat=cfg.remat, constraint=resid)
    return rmsnorm_apply(tf.whole_layer(params["ln_enc"], resid), enc, cfg.norm_eps)


def _forward_encdec(params, cfg: ModelConfig, batch, resid=None, attn_specs=None) -> torch.Tensor:
    enc = encode(params, cfg, batch["frames"], resid, attn_specs)
    x = embed_apply(tf.whole_layer(params["embed"], resid), batch["tokens"])
    sp = spmd.context(resid)
    if sp is not None:
        x = sp.slice_seq(x)
    x = tf.scan_stack(params["dec_layers"], x,
                      lambda lp, h: tf.cross_decoder_layer_apply(lp, h, enc, cfg,
                                                                 attn_specs=attn_specs,
                                                                 resid=resid),
                      remat=cfg.remat, constraint=resid)
    return rmsnorm_apply(tf.whole_layer(params["ln_f"], resid), x, cfg.norm_eps)


def loss_fn(params: Params, cfg: ModelConfig, batch: dict, ep_spec=None, resid=None,
            attn_specs=None) -> torch.Tensor:
    """Mean next-token CE of ``forward``'s hidden states.  On a mesh, this
    rank's share: its positions' CE summed over the whole batch's count, so
    the shares over the ranks that split the tokens add up to the mean."""
    hidden = forward(params, cfg, batch, ep_spec=ep_spec, resid=resid, attn_specs=attn_specs)
    labels = batch["labels"]
    sp = spmd.context(resid)
    if sp is None:
        if cfg.frontend == "vision_stub":
            # loss over text positions only (patch prefix is unsupervised)
            hidden = hidden[:, cfg.frontend_tokens:, :]
        return chunked_cross_entropy(hidden, params["unembed"]["w"], labels,
                                     chunk=cfg.loss_chunk)
    b, sl, _ = hidden.shape
    lead = cfg.frontend_tokens if cfg.frontend == "vision_stub" else 0
    start = sp.seq_offset(sl)
    first = min(max(lead - start, 0), sl)        # this slice's first text row
    hidden = hidden[:, first:]
    labels = labels[:, start + first - lead:start + sl - lead]
    count = sp.whole_batch(b) * (sp.whole_len(sl) - lead)
    unembed = tf.whole_layer(params["unembed"], resid)["w"]
    if hidden.shape[1] == 0:
        # no text in this slice: a zero share that still reaches every
        # parameter, so this rank's backward runs the others' collectives
        return (hidden.float() * 0).sum() + (unembed.float() * 0).sum()
    return chunked_cross_entropy(hidden, unembed, labels, chunk=cfg.loss_chunk, count=count)


# ---------------------------------------------------------------------------
# decode (serving)
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device: str | torch.device = DEFAULT_DEVICE):
    dev = resolve_device(device)
    refuse_one_device_fields(cfg, "the decode cache")

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    if cfg.family in ("dense", "moe"):
        n_scan = cfg.n_layers - cfg.moe_dense_first_n

        def one(*lead):
            if cfg.mla_kv_lora:
                return {"c": zeros(*lead, batch, max_len, cfg.mla_kv_lora),
                        "kr": zeros(*lead, batch, max_len, cfg.mla_qk_rope)}
            return {"k": zeros(*lead, batch, max_len, cfg.n_kv_heads, cfg.head_dim),
                    "v": zeros(*lead, batch, max_len, cfg.n_kv_heads, cfg.head_dim)}

        cache = {"scan": one(n_scan)}
        if cfg.moe_dense_first_n:
            cache["first"] = [one() for _ in range(cfg.moe_dense_first_n)]
        return cache
    if cfg.family == "hybrid":
        groups = cfg.n_layers // cfg.shared_attn_every
        hd = cfg.d_inner // cfg.n_ssm_heads
        d2 = 2 * cfg.d_model
        return {
            "ssm": zeros(groups, cfg.shared_attn_every, batch, cfg.n_ssm_heads, hd,
                         cfg.ssm_state, dt=torch.float32),
            "shared_k": zeros(groups, batch, max_len, cfg.n_kv_heads, d2 // cfg.n_heads),
            "shared_v": zeros(groups, batch, max_len, cfg.n_kv_heads, d2 // cfg.n_heads),
        }
    if cfg.family == "xlstm":
        di = int(cfg.d_model * cfg.xlstm_pf)
        hd = di // cfg.n_heads
        cache = []
        for kind in _xlstm_kinds(cfg):
            if kind == "m":
                cache.append((zeros(batch, cfg.n_heads, hd, hd, dt=torch.float32),
                              zeros(batch, cfg.n_heads, hd, dt=torch.float32),
                              torch.full((batch, cfg.n_heads), xl.M_INIT,
                                         dtype=torch.float32, device=dev)))
            else:
                cache.append(xl.slstm_init_state(batch, cfg.d_model, dev))
        return cache
    if cfg.family == "encdec":
        def one():
            return {"k": zeros(cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim),
                    "v": zeros(cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)}

        # cross K/V over the encoder output, filled at prefill
        return {"self": one(), "cross": one(), "enc_len": zeros(dt=torch.int32)}
    raise ValueError(cfg.family)


def decode_step(params: Params, cfg: ModelConfig, cache, batch: dict,
                resid=None) -> tuple[torch.Tensor, Any]:
    """One-token decode: batch = {"tokens": (B, 1), "cur_len": int or 0-d}.

    Returns fp32 logits (B, 1, vocab) and the cache, updated in place.  On
    a mesh (``resid``: the sharded decode's batch sharding, whose context
    has the params bound) ``params`` and ``cache`` are this rank's shards
    and ``tokens`` its rows: each layer's weights are gathered whole where
    they are used, the caches written and attended where they lie, and the
    logits are this rank's rows."""
    refuse_one_device_fields(cfg, "decode_step")
    tokens = batch["tokens"]
    x = embed_apply(tf.whole_layer(params["embed"], resid), tokens)
    cur_len = torch.as_tensor(batch["cur_len"], dtype=torch.int64, device=x.device)
    if cfg.family in ("dense", "moe"):
        dense_cfg = dataclasses.replace(cfg, moe_experts=0)
        for lp, cl in zip(params.get("first_layers", []), cache.get("first", [])):
            x, _ = tf.decoder_layer_decode(lp, x, cl, cur_len, dense_cfg, resid)
        x, _ = tf.scan_stack_decode(
            params["layers"], x, cache["scan"], cur_len,
            lambda lp, h, cl, t: tf.decoder_layer_decode(lp, h, cl, t, cfg, resid),
            constraint=resid)
    elif cfg.family == "hybrid":
        x = _decode_hybrid(params, cfg, cache, x, cur_len, resid)
    elif cfg.family == "xlstm":
        x = _decode_xlstm(params, cfg, cache, x, resid)
    elif cfg.family == "encdec":
        x = _decode_encdec(params, cfg, cache, x, cur_len, resid)
    else:
        raise ValueError(cfg.family)
    x = rmsnorm_apply(tf.whole_layer(params["ln_f"], resid), x, cfg.norm_eps)
    logits = dense_apply(tf.whole_layer(params["unembed"], resid), x).float()
    return logits, cache


def _decode_xlstm(params, cfg: ModelConfig, cache, x, resid=None):
    """The blocks' one-step recurrences.  On a mesh each block's state (a
    few MB a row) is gathered whole over model, stepped by the one-device
    code, and this rank's slice written back into its shards: ``cache_specs``
    splits an mLSTM block's C, n and m along different dims."""
    sp = spmd.context(resid)
    di = int(cfg.d_model * cfg.xlstm_pf)
    hd = di // cfg.n_heads
    for i, (kind, blk) in enumerate(zip(_xlstm_kinds(cfg), params["blocks"])):
        blk = tf.whole_layer(blk, resid)
        h = rmsnorm_apply(blk["ln"], x, cfg.norm_eps)
        state, dims = cache[i], None
        if sp is not None:
            wholes = (((cfg.n_heads, hd, hd), (cfg.n_heads, hd), (cfg.n_heads,)) if kind == "m"
                      else ((cfg.d_model,),) * 4)
            state, dims = zip(*(sp.whole_state(s, w) for s, w in zip(cache[i], wholes)))
        if kind == "m":
            y, new = xl.mlstm_decode(blk["p"], h, tuple(state), cfg.n_heads, cfg.xlstm_pf)
        else:
            y, new = xl.slstm_decode(blk["p"], h, tuple(state), cfg.n_heads)
        if sp is None:
            cache[i] = new
        else:
            for shard, t, dim in zip(cache[i], new, dims):
                sp.keep_state(shard, t, dim)
        x = x + y
    return x


def _decode_hybrid(params, cfg: ModelConfig, cache, x, cur_len, resid=None):
    """Mamba2 layers and the shared attention block, one token.  On a mesh
    a layer's SSM state is gathered whole over model, stepped, and this
    rank's slice written back (as :func:`_decode_xlstm`); the shared block's
    K/V caches are attended where they lie."""
    sp = spmd.context(resid)
    emb = x
    shared = tf.whole_layer(params["shared"], resid)
    d2 = 2 * cfg.d_model
    groups, per_group = cache["ssm"].shape[:2]
    hd = cfg.d_inner // cfg.n_ssm_heads
    layers = tf.unstack_on((params["group_norms"], params["groups"]), resid, axes=2)
    for g in range(groups):
        for i in range(per_group):
            norm_p, m_p = tf.whole_layer(layers[g * per_group + i], resid)
            hn = rmsnorm_apply(norm_p, x, cfg.norm_eps)
            shard = cache["ssm"][g, i]
            state, dim = shard, None
            if sp is not None:
                state, dim = sp.whole_state(shard, (cfg.n_ssm_heads, hd, cfg.ssm_state))
            y, state = m2.mamba2_decode(m_p, hn, state, cfg.d_inner, cfg.n_ssm_heads,
                                        cfg.ssm_state, cfg.ssm_groups)
            if sp is None:
                shard.copy_(state)
            else:
                sp.keep_state(shard, state, dim)
            x = x + y
        cb = torch.cat([x, emb], dim=-1)
        hn = rmsnorm_apply(shared["ln1"], cb, cfg.norm_eps)
        a, _, _ = attn_mod.gqa_decode(shared["attn"], hn, cache["shared_k"][g],
                                      cache["shared_v"][g], cur_len, cfg.n_heads,
                                      cfg.n_kv_heads, d2 // cfg.n_heads,
                                      rope_theta=cfg.rope_theta, resid=resid)
        x = _shared_mlp(shared, x + dense_apply(shared["down"], a), cfg)
    return x


def _decode_encdec(params, cfg: ModelConfig, cache, x, cur_len, resid=None):
    layers = tf.unstack_on(params["dec_layers"], resid)
    for i, lp in enumerate(layers):
        lp = tf.whole_layer(lp, resid)
        hn = rmsnorm_apply(lp["ln1"], x, cfg.norm_eps)
        a, _, _ = attn_mod.gqa_decode(lp["self"], hn, cache["self"]["k"][i],
                                      cache["self"]["v"][i], cur_len, cfg.n_heads,
                                      cfg.n_kv_heads, cfg.head_dim, rope_theta=cfg.rope_theta,
                                      resid=resid)
        x = x + a
        hn = rmsnorm_apply(lp["ln2"], x, cfg.norm_eps)
        # cross attention against the (static) encoder K/V cache, grouped
        x = x + attn_mod.cross_decode(lp["cross"], hn, cache["cross"]["k"][i],
                                      cache["cross"]["v"][i], cache["enc_len"], cfg.n_heads,
                                      cfg.n_kv_heads, cfg.head_dim, resid=resid)
        hn = rmsnorm_apply(lp["ln3"], x, cfg.norm_eps)
        x = x + gelu_mlp_apply(lp["mlp"], hn)
    return x
