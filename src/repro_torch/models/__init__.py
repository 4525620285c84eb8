"""Model zoo for the assigned architectures (PyTorch port of ``repro.models``).

``model`` (the config dataclass and the family-dispatched init, forward,
loss, cache and decode), ``transformer`` (decoder, encoder and
cross-decoder layers and their stacks), ``moe``, ``mamba2``, ``xlstm``,
``attention`` (blockwise attention, GQA and MLA apply/decode; prefill
self-attention on the flash kernel on a GPU), ``layers`` and ``convert``
(params and caches carried across from ``repro`` as numpy).
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
from repro_torch.models.model import (
    ModelConfig,
    decode_step,
    forward,
    init_cache,
    init_params,
    loss_fn,
)
