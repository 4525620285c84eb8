"""The 10 assigned architectures, exact configs from public literature.

Each entry: full ModelConfig + a reduced same-family smoke config (run on
CPU in tests) + the shape cells it participates in.
"""

from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models.model import ModelConfig

_STD_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
_LONG_SHAPES = _STD_SHAPES + ("long_500k",)


ARCHS: dict[str, ArchConfig] = {}


def _reg(arch: ArchConfig) -> ArchConfig:
    ARCHS[arch.name] = arch
    return arch


# -- whisper-base [audio] enc-dec, conv frontend stubbed ----------------------
_reg(
    ArchConfig(
        model=ModelConfig(
            name="whisper-base",
            family="encdec",
            n_layers=6,
            enc_layers=6,
            d_model=512,
            n_heads=8,
            n_kv_heads=8,
            d_ff=2048,
            vocab=51865,
            mlp_kind="gelu",
        ),
        smoke=ModelConfig(
            name="whisper-smoke", family="encdec", n_layers=2, enc_layers=2,
            d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=256,
            mlp_kind="gelu", loss_chunk=16, attn_block=16,
        ),
        source="arXiv:2212.04356",
    )
)

# -- llava-next-mistral-7b [vlm]: mistral backbone + anyres patch stub --------
_reg(
    ArchConfig(
        model=ModelConfig(
            name="llava-next-mistral-7b",
            family="dense",
            n_layers=32,
            d_model=4096,
            n_heads=32,
            n_kv_heads=8,
            d_ff=14336,
            vocab=32000,
            frontend="vision_stub",
            frontend_tokens=2880,   # anyres: base 576 + 4 tiles x 576
            loss_chunk=64,          # must divide the 1216 text positions
        ),
        smoke=ModelConfig(
            name="llava-smoke", family="dense", n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
            frontend="vision_stub", frontend_tokens=16, loss_chunk=16,
            attn_block=16,
        ),
        source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
    )
)

# -- zamba2-2.7b [hybrid]: mamba2 backbone + shared attention block -----------
_reg(
    ArchConfig(
        model=ModelConfig(
            name="zamba2-2.7b",
            family="hybrid",
            n_layers=54,
            d_model=2560,
            n_heads=32,
            n_kv_heads=32,
            d_ff=10240,
            vocab=32000,
            ssm_state=64,
            ssm_expansion=2,
            ssm_groups=1,
            shared_attn_every=6,
        ),
        smoke=ModelConfig(
            name="zamba2-smoke", family="hybrid", n_layers=4, d_model=64,
            n_heads=4, n_kv_heads=4, d_ff=128, vocab=256, ssm_state=16,
            ssm_expansion=2, ssm_groups=1, shared_attn_every=2,
            ssm_chunk=16, loss_chunk=16, attn_block=16,
        ),
        shapes=_LONG_SHAPES,
        skip_notes=(),
        source="arXiv:2411.15242",
    )
)

# -- yi-9b [dense] -------------------------------------------------------------
_reg(
    ArchConfig(
        model=ModelConfig(
            name="yi-9b", family="dense", n_layers=48, d_model=4096,
            n_heads=32, n_kv_heads=4, d_ff=11008, vocab=64000,
        ),
        smoke=ModelConfig(
            name="yi-smoke", family="dense", n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=2, d_ff=128, vocab=256, loss_chunk=16,
            attn_block=16,
        ),
        source="arXiv:2403.04652",
    )
)

# -- minitron-8b [dense]: pruned nemotron, 256 K vocab -------------------------
_reg(
    ArchConfig(
        model=ModelConfig(
            name="minitron-8b", family="dense", n_layers=32, d_model=4096,
            n_heads=32, n_kv_heads=8, d_ff=16384, vocab=256000,
            loss_chunk=64,          # 256 K vocab: smaller CE tiles
        ),
        smoke=ModelConfig(
            name="minitron-smoke", family="dense", n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=2, d_ff=128, vocab=512, loss_chunk=16,
            attn_block=16,
        ),
        source="arXiv:2407.14679",
    )
)

# -- qwen1.5-4b [dense]: QKV bias ----------------------------------------------
_reg(
    ArchConfig(
        model=ModelConfig(
            name="qwen1.5-4b", family="dense", n_layers=40, d_model=2560,
            n_heads=20, n_kv_heads=20, d_ff=6912, vocab=151936,
            qkv_bias=True, loss_chunk=64,
        ),
        smoke=ModelConfig(
            name="qwen-smoke", family="dense", n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=4, d_ff=128, vocab=256, qkv_bias=True,
            loss_chunk=16, attn_block=16,
        ),
        source="hf:Qwen/Qwen1.5-4B",
    )
)

# -- starcoder2-7b [dense]: GQA + RoPE, GELU MLP -------------------------------
_reg(
    ArchConfig(
        model=ModelConfig(
            name="starcoder2-7b", family="dense", n_layers=32, d_model=4608,
            n_heads=36, n_kv_heads=4, d_ff=18432, vocab=49152,
            mlp_kind="gelu", qkv_bias=True,
        ),
        smoke=ModelConfig(
            name="starcoder2-smoke", family="dense", n_layers=2, d_model=72,
            n_heads=4, n_kv_heads=2, d_ff=144, vocab=256, mlp_kind="gelu",
            qkv_bias=True, loss_chunk=16, attn_block=16,
        ),
        source="arXiv:2402.19173",
    )
)

# -- xlstm-125m [ssm]: sLSTM + mLSTM blocks ------------------------------------
_reg(
    ArchConfig(
        model=ModelConfig(
            name="xlstm-125m", family="xlstm", n_layers=12, d_model=768,
            n_heads=4, n_kv_heads=4, d_ff=0, vocab=50304, slstm_every=8,
        ),
        smoke=ModelConfig(
            name="xlstm-smoke", family="xlstm", n_layers=4, d_model=64,
            n_heads=4, n_kv_heads=4, d_ff=0, vocab=256, slstm_every=4,
            ssm_chunk=16, loss_chunk=16,
        ),
        shapes=_LONG_SHAPES,
        skip_notes=(),
        source="arXiv:2405.04517",
    )
)

# -- deepseek-v2-lite-16b [moe]: MLA + 2 shared + 64 routed top-6 --------------
_reg(
    ArchConfig(
        model=ModelConfig(
            name="deepseek-v2-lite-16b", family="moe", n_layers=27,
            d_model=2048, n_heads=16, n_kv_heads=16, d_ff=10944,
            vocab=102400, moe_experts=64, moe_top_k=6, moe_shared=2,
            moe_d_ff=1408, moe_dense_first_n=1, mla_kv_lora=512,
            mla_qk_nope=128, mla_qk_rope=64, mla_v_head=128, loss_chunk=64,
        ),
        smoke=ModelConfig(
            name="dsv2-smoke", family="moe", n_layers=3, d_model=64,
            n_heads=4, n_kv_heads=4, d_ff=128, vocab=256, moe_experts=4,
            moe_top_k=2, moe_shared=1, moe_d_ff=64, moe_dense_first_n=1,
            mla_kv_lora=32, mla_qk_nope=16, mla_qk_rope=8, mla_v_head=16,
            loss_chunk=16, attn_block=16,
        ),
        source="arXiv:2405.04434",
    )
)

# -- dbrx-132b [moe]: 16 experts top-4 ------------------------------------------
_reg(
    ArchConfig(
        model=ModelConfig(
            name="dbrx-132b", family="moe", n_layers=40, d_model=6144,
            n_heads=48, n_kv_heads=8, d_ff=0, vocab=100352, moe_experts=16,
            moe_top_k=4, moe_d_ff=10752, loss_chunk=64,
        ),
        smoke=ModelConfig(
            name="dbrx-smoke", family="moe", n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=2, d_ff=0, vocab=256, moe_experts=4,
            moe_top_k=2, moe_d_ff=64, loss_chunk=16, attn_block=16,
        ),
        source="hf:databricks/dbrx-base",
    )
)


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def arch_names() -> list[str]:
    return list(ARCHS)


def cells() -> list[tuple[str, str]]:
    """All runnable (arch, shape) cells."""
    out = []
    for name, arch in ARCHS.items():
        for shape in arch.shapes:
            out.append((name, shape))
    return out
