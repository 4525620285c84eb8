"""The yardstick: the work a cell needs, counted from the configuration's
shapes in the precision the configuration states, and the card's published
peaks.  Nothing here reads what the program happens to compute or move, so a
program that drops a cast moves the time and not the count.

Configurations use their published keys (``hidden_size``,
``num_attention_heads``, ...) of a ``llama`` decoder: GQA and SwiGLU.
"""

from __future__ import annotations

#: NVIDIA H100 SXM data sheet, dense: bf16 tensor-core FLOP/s and HBM3 bytes/s
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def _attn_params(c: dict) -> int:
    d = c["hidden_size"]
    h = c["num_attention_heads"]
    return d * (d // h) * (2 * h + 2 * c["num_key_value_heads"])


def embedding_params(c: dict) -> int:
    return 2 * c["vocab_size"] * c["hidden_size"]


def param_count(c: dict) -> int:
    """Every parameter: embedding and head, attention, MLPs, norms."""
    d = c["hidden_size"]
    layer = _attn_params(c) + 3 * d * c["intermediate_size"] + 2 * d
    return embedding_params(c) + d + c["num_hidden_layers"] * layer


def train_flops(c: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one train step: 6 x params x tokens, plus causal
    attention (forward S^2/2 score and value products a head, x3 with the
    backward).  Recomputation is not counted."""
    hd = c["hidden_size"] // c["num_attention_heads"]
    attn = 3 * batch * c["num_attention_heads"] * seq * seq * 2 * hd * c["num_hidden_layers"]
    return 6.0 * param_count(c) * batch * seq + attn


def gf_matmul_bytes(n: int, k: int, stripes: int, length: int) -> int:
    """A GF(2^8) product of (n, k) coefficients and (stripes, k, length)
    bytes: the data read once and the (stripes, n, length) result written
    once."""
    return stripes * (k + n) * length
