"""Flash attention forward: the online-softmax attention of the training path.

Wrapper of the hand-written CUDA kernel in ``csrc/flash_attention.cu``,
with its plain PyTorch version beside it:

  ======================  =====================================================
  wrapper                 replaces (Pallas TPU kernel)
  ======================  =====================================================
  flash_attention_fwd     src/repro/kernels/flash_attention.py:flash_attention_fwd
  ======================  =====================================================

q (B,Sq,H,D), k (B,Skv,Hkv,D), v (B,Skv,Hkv,Dv), bf16 or fp32 -> (B,Sq,H,Dv)
in q's dtype: grouped-query heads (kv head = h // rep, never repeated in
memory), causal or not (query row i at position ``q_offset + i`` of the
keys, as a context-parallel rank's slice of the rows), fp32 accumulation, q upcast to fp32 before the
scaling and p rounded to v's dtype before P.V, as the TPU kernel computes
it.  (``models.attention.blockwise_attention`` scales q in q's dtype
instead; in bf16 the two differ by that rounding.)

Bound: operations (about S/4 to S/2 flops per byte in bf16).  Two bodies,
chosen by dtype (see the source's header).  bf16 runs on the tensor cores:
one block per (b, h, 128-row q tile) with a TMA producer warpgroup and two
wgmma consumer warpgroups, walking ``KV_TILE`` = 128-key tiles; TMA reads
the (B,S,H,D) layout through strides, and needs every base address and
stride 16-byte aligned, so the wrapper copies an operand that is not (see
:func:`needs_copy`).  fp32 stays on fp32 FMAs on the CUDA cores (the tensor
cores have no exact fp32), walking ``FP32_KV_TILE`` = 64-key tiles.  The
plain version walks the tiles of the body that the dtype selects
(:func:`kv_tile`).  The TPU tile arguments ``bq``/``bk`` are not carried
over: the kernel picks its own tiles.

A wrapper given CPU tensors computes the plain version; given CUDA tensors
it launches the kernel on the current stream or raises.  Either way it is
forward only, as the TPU kernel is, and raises when an operand needs a
gradient.  ``flash_attention_fwd.launches`` counts its launches, and
``flash_attention_fwd.offset_launches`` those of them with ``q_offset > 0``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

#: the (D, Dv) head-dim pairs the kernel takes: every pair of 64, 80, 128, 192
#: with 64, 80, 128 (the supported architectures' self-attention: whisper 64,
#: yi and most 128, deepseek-v2 MLA 192/128), and zamba2's shared block
#: (d_model 2 x 2560 over 32 heads: 160/160)
HEAD_DIMS = tuple((d, dv) for d in (64, 80, 128, 192) for dv in (64, 80, 128)) + ((160, 160),)
#: keys per KV tile of the bf16 (tensor-core) body, tc::kBK in the source
KV_TILE = 128
#: keys per KV tile of the fp32 (SIMT) body, simt::kBK in the source
FP32_KV_TILE = 64

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PTR, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_SIGNATURES = {
    "flash_attention_fwd": [_PTR, _PTR, _PTR, _PTR, _INT, *[_I64] * 17, _INT, _PTR],
    "flash_attention_tc_smem_bytes": [_I64, _I64],
}


def kv_tile(dtype: torch.dtype) -> int:
    """Keys per KV tile of the kernel body that runs for ``dtype``."""
    return FP32_KV_TILE if dtype == torch.float32 else KV_TILE


def needs_copy(t: torch.Tensor) -> bool:
    """Whether the wrapper hands the kernel a contiguous copy of operand ``t``.

    Both bodies need unit stride in the head dim.  The bf16 body reads by
    TMA, which takes only 16-byte aligned base addresses and 16-byte
    multiples as strides: a (B,S,H) stride that is not, on a dim longer
    than 1, or a base that is not, means a copy (a contiguous bf16 tensor
    of a supported head dim always passes).
    """
    if t.stride(-1) != 1:
        return True
    if t.dtype != torch.bfloat16:
        return False
    size = t.element_size()
    return t.data_ptr() % 16 != 0 or any(
        n > 1 and (st <= 0 or st * size % 16) for n, st in zip(t.shape[:3], t.stride()[:3]))


def _lib() -> ctypes.CDLL:
    return _build.load("flash_attention", _SIGNATURES)


def tc_smem_bytes(d: int, dv: int) -> int:
    """Dynamic shared memory of one block of the bf16 body at head dims
    (d, dv), as the library computes it (builds the library)."""
    return int(_lib().flash_attention_tc_smem_bytes(d, dv))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_offset: int = 0) -> None:
    """Raise on operands the kernel does not take."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"expected (B,S,H,D) operands, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"expected bfloat16 or float32, got {q.dtype}")
    b, _, h, d = q.shape
    hkv, dv = k.shape[2], v.shape[3]
    if k.shape[0] != b or v.shape[:3] != k.shape[:3] or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v {tuple(v.shape)} "
                         "must share B (and k, v their length and heads; q, k their head dim)")
    if q_offset < 0:
        raise ValueError(f"q_offset {q_offset} is negative")
    if hkv < 1 or h % hkv:
        raise ValueError(f"{h} query heads are not a multiple of {hkv} kv heads")
    if (d, dv) not in HEAD_DIMS:
        raise ValueError(f"head dims (D, Dv) = ({d}, {dv}) not in {HEAD_DIMS}")
    if not q.device == k.device == v.device:
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")


def flash_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """The TPU kernel's function in plain PyTorch, rounded as the kernel body
    that q's dtype selects rounds it, for any head dims.

    ``blockwise_attention``'s online-softmax loop over the body's own KV
    tiles (:func:`kv_tile`): the running max is then the kernel's after
    every tile, so each p rounds to v's dtype as the kernel rounds it.  The
    scores are taken as the body takes them: fp32 q scaled first, then fp32
    products (the SIMT body); bf16 q . k with fp32 sums, on the card on the
    tensor cores as the kernel's wgmma, then scaled in fp32 (the tensor-core
    body).  The two then differ only in the order of fp32 sums.  Queries
    sit at positions ``q_offset + i`` against all of k/v.  The score block
    stays (B, Sq, H, tile) however long the keys are.
    """
    from repro_torch.models.attention import _flash_fwd_scan, _group_q

    b, s, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    tile = kv_tile(q.dtype)
    if q.dtype == torch.float32:
        out, _ = _flash_fwd_scan(_group_q(q * scale, k.shape[2]), k, v, causal, tile, q_offset)
    else:
        out, _ = _flash_fwd_scan(_group_q(q, k.shape[2]), k, v, causal, tile, q_offset, scale)
    return out.reshape(b, s, h, v.shape[3]).to(q.dtype)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """q (B,Sq,H,D), k (B,Skv,Hkv,D), v (B,Skv,Hkv,Dv) -> (B,Sq,H,Dv) in q's
    dtype, query row i at position ``q_offset + i``.

    Forward only, like the TPU kernel: the call raises when autograd would
    need a gradient through it (use ``blockwise_attention`` to train).  On
    the card, an operand the kernel cannot read where it lies (see
    :func:`needs_copy`: a head dim of non-unit stride; in bf16 a base
    address or a (B,S,H) stride that is not a multiple of 16 bytes) is
    first copied to a fresh contiguous tensor.
    """
    q_offset = int(q_offset)
    _check(q, k, v, q_offset)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention_fwd has no backward; call it under "
                           "torch.no_grad() or use models.attention.blockwise_attention")
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal, q_offset)
    b, s, h, _ = q.shape
    out = torch.empty((b, s, h, v.shape[3]), dtype=q.dtype, device=q.device)
    if out.numel():
        q, k, v = (t.clone(memory_format=torch.contiguous_format) if needs_copy(t) else t
                   for t in (q, k, v))
        lib = _lib()
        with _build.on_device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            rc = lib.flash_attention_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype],
                b, s, k.shape[1], q_offset, h, k.shape[2], q.shape[3], v.shape[3],
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], int(causal), stream)
        _build.check(lib, rc, "flash_attention_fwd")
        flash_attention_fwd.launches += 1
        flash_attention_fwd.offset_launches += q_offset > 0
    return out


flash_attention_fwd.launches = 0
flash_attention_fwd.offset_launches = 0

#: every kernel wrapper of this module, for launch accounting
KERNELS = (flash_attention_fwd,)
