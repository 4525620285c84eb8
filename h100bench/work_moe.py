"""The yardstick of a DeepSeek-V2 configuration (MLA, a leading dense
layer, routed and shared experts): parameters, the model FLOPs of a train
step and the routed experts' products, counted from the configuration's
published keys.  Nothing here reads what the program computes."""

from __future__ import annotations


def mla_params(c: dict) -> int:
    """One MLA block: q, the latent and RoPE key, the latent's norm, the
    key and value up-projections, the output."""
    d, h, lora = c["hidden_size"], c["num_attention_heads"], c["kv_lora_rank"]
    nope, rope, v = c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"]
    return (d * h * (nope + rope) + d * (lora + rope) + lora
            + lora * h * (nope + v) + h * v * d)


def _moe_layers(c: dict) -> int:
    return c["num_hidden_layers"] - c["first_k_dense_replace"]


def _layers(c: dict, experts: int) -> int:
    """Every layer's parameters, ``experts`` routed experts counted in each
    expert layer."""
    d, eff = c["hidden_size"], c["moe_intermediate_size"]
    dense = mla_params(c) + 3 * d * c["intermediate_size"] + 2 * d
    moe = (mla_params(c) + 3 * d * eff * (experts + c["n_shared_experts"])
           + d * c["n_routed_experts"] + 2 * d)
    return c["first_k_dense_replace"] * dense + _moe_layers(c) * moe


def param_count(c: dict) -> int:
    """Every parameter held: embedding and head, the final norm, layers."""
    d = c["hidden_size"]
    return 2 * c["vocab_size"] * d + d + _layers(c, c["n_routed_experts"])


def active_param_count(c: dict) -> int:
    """The parameters a token meets: the routed experts it is sent to."""
    d = c["hidden_size"]
    return 2 * c["vocab_size"] * d + d + _layers(c, c["num_experts_per_tok"])


def train_flops(c: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one train step: 6 x active params x tokens, plus causal
    attention (forward S^2/2 score products at the q/k head dim and value
    products at the value head dim, x3 with the backward).  Recomputation
    is not counted."""
    head = c["qk_nope_head_dim"] + c["qk_rope_head_dim"] + c["v_head_dim"]
    attn = 3 * batch * c["num_attention_heads"] * seq * seq * head * c["num_hidden_layers"]
    return 6.0 * active_param_count(c) * batch * seq + attn


def expert_flops(c: dict, batch: int, seq: int) -> float:
    """The routed experts' products of one train step as a remat step runs
    them: three products of 2 x choices x d x ff a pass, four passes (the
    forward, its recomputation, and a backward of twice the forward's)."""
    choices = batch * seq * c["num_experts_per_tok"]
    one = 3 * 2 * choices * c["hidden_size"] * c["moe_intermediate_size"]
    return 4.0 * one * _moe_layers(c)
