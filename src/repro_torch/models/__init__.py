"""Model building blocks of the port: the shared layers and attention.

Only what this slice has: ``layers`` (dense, norms, MLPs, embedding,
rotary embeddings, chunked cross-entropy), ``attention`` (blockwise
attention with its recomputing backward, GQA and MLA apply/decode) and
``convert`` (params carried across from ``repro`` as numpy).  The
reference's full model stack (transformer, MoE, Mamba2, xLSTM) is not
ported yet.
"""

from repro_torch.models.attention import (
    blockwise_attention,
    gqa_apply,
    gqa_decode,
    gqa_init,
    mla_apply,
    mla_decode,
    mla_init,
)
from repro_torch.models.convert import params_from_numpy, params_to_numpy
