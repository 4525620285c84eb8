"""The yardstick of a NemotronH configuration (Mamba-2, MoE and attention
blocks by ``hybrid_override_pattern``): parameters, the model FLOPs of a
train step, the held experts' products and the chunked SSD scan's, counted
from the configuration's published keys and its share of the experts
(``expert_parallel``).  Nothing here reads what the program computes."""

from __future__ import annotations


def kinds(c: dict) -> str:
    return c["hybrid_override_pattern"][:c["num_hidden_layers"]]


def router_experts(c: dict) -> int:
    """The experts the router scores: all that the model has."""
    return c["n_routed_experts"]


def held_experts(c: dict) -> int:
    """The experts this chip holds: the router's over the chips that share
    a layer."""
    return c["n_routed_experts"] // c.get("expert_parallel", {"chips": 1})["chips"]


def mamba_params(c: dict) -> int:
    """One Mamba-2 mixer: in_proj, the convolution's taps and bias, A_log,
    D and dt_bias, the gated norm's weight, out_proj."""
    d, h = c["hidden_size"], c["mamba_num_heads"]
    di = h * c["mamba_head_dim"]
    conv = di + 2 * c["n_groups"] * c["ssm_state_size"]
    return d * (di + conv + h) + conv * (c["conv_kernel"] + 1) + 3 * h + di + di * d


def attn_params(c: dict) -> int:
    d, hd = c["hidden_size"], c["head_dim"]
    return 2 * d * hd * (c["num_attention_heads"] + c["num_key_value_heads"])


def moe_params(c: dict, experts: float, bias: bool = True) -> float:
    """One MoE mixer with ``experts`` routed experts counted: the router (and
    with ``bias`` its correction bias), the relu^2 experts' two matrices,
    the shared expert."""
    d, routed = c["hidden_size"], router_experts(c)
    shared = c["moe_shared_expert_intermediate_size"] * c["n_shared_experts"]
    return (d * routed + (routed if bias else 0)
            + 2 * d * (experts * c["moe_intermediate_size"] + shared))


def _blocks(c: dict, experts: float, bias: bool) -> float:
    """Every block's parameters and its norm, ``experts`` routed experts a
    MoE block."""
    size = {"M": mamba_params(c), "*": attn_params(c), "E": moe_params(c, experts, bias)}
    return sum(size[k] + c["hidden_size"] for k in kinds(c))


def param_count(c: dict) -> int:
    """Every parameter held, the correction biases included: embedding and
    head, the final norm, the blocks with their held experts."""
    d = c["hidden_size"]
    return int(2 * c["vocab_size"] * d + d + _blocks(c, held_experts(c), True))


def active_param_count(c: dict) -> float:
    """The trained parameters a token meets on this chip: the held experts
    it is sent to on average, K x held / routed of them."""
    d = c["hidden_size"]
    share = c["num_experts_per_tok"] * held_experts(c) / router_experts(c)
    return 2 * c["vocab_size"] * d + d + _blocks(c, share, False)


def ssd_pass_flops(c: dict, batch: int, seq: int) -> float:
    """One pass of the chunked SSD over every Mamba block, the work it needs:
    a chunk of Q positions counts 2 (Q^2 N / (2 H / G) + Q^2 P / 2 + 2 Q N P)
    a head and a row: the C.B scores over the causal half once for each
    group of B and C (shared by its H / G heads), their causal product with
    x, the state's update and its read."""
    q, n, p = c["chunk_size"], c["ssm_state_size"], c["mamba_head_dim"]
    heads_a_group = c["mamba_num_heads"] / c["n_groups"]
    chunk = 2 * (q * q * n / (2 * heads_a_group) + q * q * p / 2 + 2 * q * n * p)
    return float(batch * c["mamba_num_heads"] * (seq // q) * chunk * kinds(c).count("M"))


def ssd_flops(c: dict, batch: int, seq: int) -> float:
    """The scan's FLOPs as a remat step runs it: four passes (forward, its
    recomputation, a backward of twice the forward's)."""
    return 4 * ssd_pass_flops(c, batch, seq)


def train_flops(c: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one train step: 6 x active params x tokens, plus causal
    attention (forward S^2/2 score and value products at the head dim, x3
    with the backward) and the scan (a forward pass, x3).  Recomputation is
    not counted."""
    attn = 3 * batch * c["num_attention_heads"] * seq * seq * 2 * c["head_dim"] * (
        kinds(c).count("*"))
    return 6.0 * active_param_count(c) * batch * seq + attn + 3 * ssd_pass_flops(c, batch, seq)


def expert_flops(c: dict, batch: int, seq: int) -> float:
    """The held experts' products of one train step as a remat step runs
    them: two products of 2 x choices x d x ff a pass over the choices that
    land on this chip's experts (K x held / routed a token, counted from the
    shapes and not from the routing), four passes."""
    choices = batch * seq * c["num_experts_per_tok"] * held_experts(c) / router_experts(c)
    one = 2 * 2 * choices * c["hidden_size"] * c["moe_intermediate_size"]
    return 4.0 * one * kinds(c).count("E")
