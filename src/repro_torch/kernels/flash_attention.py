"""Flash attention: the online-softmax attention forward, and the kernel
pair that trains on it.

Wrappers of the hand-written CUDA kernels in ``csrc/flash_attention.cu``
and ``csrc/flash_attention_bwd.cu``, each with its plain PyTorch version
beside it:

  =======================  ====================================================
  wrapper                  replaces (Pallas TPU kernel)
  =======================  ====================================================
  flash_attention_fwd      src/repro/kernels/flash_attention.py:flash_attention_fwd
  flash_attention_fwd_lse  the same kernel, also writing each row's log-sum-exp
  flash_attention_bwd      none: the TPU kernel is forward only, and the
                           reference trains on blockwise attention's custom_vjp
  =======================  ====================================================

q (B,Sq,H,D), k (B,Skv,Hkv,D), v (B,Skv,Hkv,Dv), bf16 or fp32 -> (B,Sq,H,Dv)
in q's dtype: grouped-query heads (kv head = h // rep, never repeated in
memory), causal or not (query row i at position ``q_offset + i`` of the
keys, as a context-parallel rank's slice of the rows), fp32 accumulation, q upcast to fp32 before the
scaling and p rounded to v's dtype before P.V, as the TPU kernel computes
it.  (The layers' plain route, ``models.attention``, scales q in q's
dtype instead; in bf16 the two differ by that rounding.)

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

The plain versions are the online-softmax loop :func:`_flash_fwd_scan` and
the plain training backward :func:`flash_attention_bwd_plain`, which the
layers' plain route (``models.attention``) runs too, at its own block.
Which route a layer's call takes is decided in ``models.attention``; this
module imports nothing above the kernels.

A wrapper given CPU tensors computes the plain version; given CUDA tensors
it launches the kernel on the current stream or raises.  Either way
``flash_attention_fwd`` is forward only, as the TPU kernel is, and raises
when an operand needs a gradient.  ``flash_attention_fwd.launches`` counts
its launches, and ``flash_attention_fwd.offset_launches`` those of them with
``q_offset > 0``.

The training pair (bf16 operands of head dims :data:`BWD_HEAD_DIMS`):
:func:`flash_attention_fwd_lse` launches the bf16 body and also returns lse
(B, H, :func:`lse_rows`) in fp32, the residual from which
:func:`flash_attention_bwd` recomputes P; the backward returns (dq, dk, dv)
in bf16 with P and dS held at fp32 precision (three-term bf16 splits on the
tensor cores, see the source's header) and no atomics, so a rerun gives the
same bits.  Each keeps its own ``launches``.
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
#: the (D, Dv) head-dim pairs the backward kernel takes (bf16 only): yi's
#: and most GQA models' 128/128, and deepseek-v2 MLA's 192/128
BWD_HEAD_DIMS = ((128, 128), (192, 128))
#: rows of the lse and delta buffers are padded to a multiple of this
#: (kLsePad in flash_attention_bwd.cu)
LSE_PAD = 64
#: the score of a masked key
NEG_INF = -1e30

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PTR, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_SIGNATURES = {
    "flash_attention_fwd": [_PTR, _PTR, _PTR, _PTR, _PTR, _I64, _INT, *[_I64] * 17, _INT, _PTR],
    "flash_attention_tc_smem_bytes": [_I64, _I64],
}
_BWD_SIGNATURES = {"flash_attention_bwd": [*[_PTR] * 12, *[_I64] * 9, _PTR, _INT, _PTR]}


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


def _bwd_lib() -> ctypes.CDLL:
    return _build.load("flash_attention_bwd", _BWD_SIGNATURES)


def lse_rows(sq: int) -> int:
    """Rows of the (B, H, rows) lse buffer for ``sq`` query rows: ``sq``
    rounded up to a multiple of :data:`LSE_PAD`."""
    return -(-sq // LSE_PAD) * LSE_PAD


def tc_smem_bytes(d: int, dv: int) -> int:
    """Dynamic shared memory of one block of the bf16 body at head dims
    (d, dv), as the library computes it (builds the library)."""
    return int(_lib().flash_attention_tc_smem_bytes(d, dv))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_offset: int = 0,
           pair: bool = False) -> None:
    """Raise on operands the forward kernel does not take, or with ``pair``
    the kernel pair (bf16 only, head dims :data:`BWD_HEAD_DIMS`)."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"expected (B,S,H,D) operands, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dtype not in _DTYPES or (pair and q.dtype != torch.bfloat16):
        raise TypeError(f"expected {'bfloat16' if pair else 'bfloat16 or float32'}, "
                        f"got {q.dtype}")
    b, _, h, d = q.shape
    hkv, dv = k.shape[2], v.shape[3]
    if k.shape[0] != b or v.shape[:3] != k.shape[:3] or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v {tuple(v.shape)} "
                         "must share B (and k, v their length and heads; q, k their head dim)")
    if q_offset < 0:
        raise ValueError(f"q_offset {q_offset} is negative")
    if hkv < 1 or h % hkv:
        raise ValueError(f"{h} query heads are not a multiple of {hkv} kv heads")
    dims = BWD_HEAD_DIMS if pair else HEAD_DIMS
    if (d, dv) not in dims:
        raise ValueError(f"head dims (D, Dv) = ({d}, {dv}) not in {dims}")
    if not q.device == k.device == v.device:
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")


# ---------------------------------------------------------------------------
# The plain versions: the online-softmax loop and the training backward.
# ---------------------------------------------------------------------------


def _group_q(q: torch.Tensor, hkv: int) -> torch.Tensor:
    """(B, S, H, D) -> (B, S, Hkv, rep, D): grouped heads, no KV repeat."""
    b, s, h, d = q.shape
    return q.reshape(b, s, hkv, h // hkv, d)


def _causal_mask(start: int, width: int, sq: int, q_offset: int, device) -> torch.Tensor:
    """(Sq, width) bool: key position start + j is visible to query row i."""
    q_pos = q_offset + torch.arange(sq, device=device)
    kv_pos = start + torch.arange(width, device=device)
    return kv_pos[None, :] <= q_pos[:, None]


def _product_f32(qg, kc):
    """Scores (B, Sq, Hkv, R, Sk) in fp32 of qg (B, Sq, Hkv, R, D) and kc
    (B, Sk, Hkv, D) taken in their own dtype: on the card, a bf16 pair as
    the tensor cores take it (bf16 products, fp32 sums), which is how the
    flash kernel's wgmma rounds; otherwise exact products summed in fp32."""
    if qg.dtype == torch.bfloat16 and qg.is_cuda:
        b, sq, g, r, d = qg.shape
        a = qg.permute(0, 2, 3, 1, 4).reshape(b * g, r * sq, d)
        bt = kc.permute(0, 2, 3, 1).reshape(b * g, d, kc.shape[1])
        out = torch.bmm(a, bt, out_dtype=torch.float32)
        return out.reshape(b, g, r, sq, -1).permute(0, 3, 1, 2, 4)
    return torch.einsum("bqgrd,bkgd->bqgrk", qg.float(), kc.float())


def _flash_fwd_scan(qg, k, v, causal, block, q_offset, scale=None):
    """Online-softmax forward over KV blocks with grouped GQA heads.

    qg: (B, Sq, Hkv, R, D) pre-scaled, or, given ``scale``, unscaled, the
    scale then multiplying each fp32 score (see ``_product_f32``); k/v:
    (B, Skv, Hkv, D[v]).  A Python
    loop over blocks takes the place of ``lax.scan``; the last block is
    sliced short instead of padded (padded keys add exactly 0).  With a
    causal mask, the query rows that see none of a block skip it (it would
    add exactly 0 to them), and the loop ends once no row sees a block.
    Returns (out f32 (B,Sq,Hkv,R,Dv), lse (B,Sq,Hkv,R)).
    """
    b, sq, hkv, rep, _ = qg.shape
    dv = v.shape[-1]
    q32 = qg.float()
    acc = torch.zeros((b, sq, hkv, rep, dv), dtype=torch.float32, device=qg.device)
    m = torch.full((b, sq, hkv, rep), NEG_INF, dtype=torch.float32, device=qg.device)
    l = torch.zeros((b, sq, hkv, rep), dtype=torch.float32, device=qg.device)
    for start in range(0, k.shape[1], block):
        # query row i sees key start only if start <= q_offset + i
        rows = min(max(start - q_offset, 0), sq) if causal else 0
        if rows == sq:
            break
        kc = k[:, start:start + block]
        vc = v[:, start:start + block]
        if scale is None:
            scores = torch.einsum("bqgrd,bkgd->bqgrk", q32[:, rows:], kc.float())
        else:
            scores = _product_f32(qg[:, rows:], kc) * scale
        if causal:
            mask = _causal_mask(start, kc.shape[1], sq - rows, q_offset + rows, qg.device)
            scores = scores.masked_fill(~mask[None, :, None, None, :], NEG_INF)
        m_new = torch.maximum(m[:, rows:], scores.amax(dim=-1))
        p = torch.exp(scores - m_new[..., None])
        alpha = torch.exp(m[:, rows:] - m_new)
        l_new = l[:, rows:] * alpha + p.sum(dim=-1)
        acc_new = acc[:, rows:] * alpha[..., None] + torch.einsum(
            "bqgrk,bkgd->bqgrd", p.to(vc.dtype).float(), vc.float()
        )
        # out of place, so autograd through the loop stays valid
        if rows:
            m_new = torch.cat([m[:, :rows], m_new], dim=1)
            l_new = torch.cat([l[:, :rows], l_new], dim=1)
            acc_new = torch.cat([acc[:, :rows], acc_new], dim=1)
        m, l, acc = m_new, l_new, acc_new
    l = torch.clamp_min(l, 1e-30)
    return acc / l[..., None], m + torch.log(l)


def _to_kernel_lse(lse: torch.Tensor) -> torch.Tensor:
    """lse (B, Sq, H) -> the kernels' (B, H, lse_rows(Sq)), rows past Sq 0."""
    b, s, h = lse.shape
    out = torch.zeros((b, h, lse_rows(s)), dtype=torch.float32, device=lse.device)
    out[..., :s] = lse.permute(0, 2, 1)
    return out


def flash_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              causal: bool = True, q_offset: int = 0):
    """The TPU kernel's function in plain PyTorch, rounded as the kernel body
    that q's dtype selects rounds it, for any head dims: (out, lse) as
    :func:`flash_attention_fwd_lse` returns them.

    :func:`_flash_fwd_scan` over the body's own KV tiles (:func:`kv_tile`):
    the running max is then the kernel's after every tile, so each p rounds
    to v's dtype as the kernel rounds it.  The scores are taken as the body
    takes them: fp32 q scaled first, then fp32 products (the SIMT body);
    bf16 q . k with fp32 sums, on the card on the tensor cores as the
    kernel's wgmma, then scaled in fp32 (the tensor-core body).  The two
    then differ only in the order of fp32 sums.  Queries sit at positions
    ``q_offset + i`` against all of k/v.  The score block stays (B, Sq, H,
    tile) however long the keys are.
    """
    b, s, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    tile = kv_tile(q.dtype)
    if q.dtype == torch.float32:
        out, lse = _flash_fwd_scan(_group_q(q * scale, k.shape[2]), k, v, causal, tile, q_offset)
    else:
        out, lse = _flash_fwd_scan(_group_q(q, k.shape[2]), k, v, causal, tile, q_offset, scale)
    return out.reshape(b, s, h, v.shape[3]).to(q.dtype), _to_kernel_lse(lse.reshape(b, s, h))


def _row_dot(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """The softmax backward's correction term, ``rowsum(dout * out)``."""
    return (out * dout).sum(dim=-1)


def flash_attention_bwd_plain(q, k, v, out, dout, lse, causal: bool = True, q_offset: int = 0,
                              block: int = KV_TILE):
    """The plain training backward, from (q, k, v, out) and lse in the
    kernels' (B, H, lse_rows(Sq)) layout: block scores recomputed in fp32
    over KV blocks of ``block`` keys (the backward kernel's tile unless
    given), P and dS in fp32.  Returns (dq, dk, dv) in the operands' dtypes."""
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    lse = lse[..., :sq].permute(0, 2, 1).reshape(b, sq, hkv, h // hkv)
    block = min(block, k.shape[1])
    scale = 1.0 / math.sqrt(d)
    qg = _group_q(q, hkv).float() * scale
    og = _group_q(out, hkv).float()
    dog = _group_q(dout, hkv).float()
    delta = _row_dot(og, dog)                       # D_i = rowsum(dout * out)
    dq = torch.zeros_like(qg)
    dks, dvs = [], []
    for start in range(0, k.shape[1], block):
        kc32 = k[:, start:start + block].float()
        vc32 = v[:, start:start + block].float()
        scores = torch.einsum("bqgrd,bkgd->bqgrk", qg, kc32)
        p = torch.exp(scores - lse[..., None])
        if causal:
            mask = _causal_mask(start, kc32.shape[1], sq, q_offset, q.device)
            p = p.masked_fill(~mask[None, :, None, None, :], 0.0)
        dvs.append(torch.einsum("bqgrk,bqgrd->bkgd", p, dog))
        dp = torch.einsum("bqgrd,bkgd->bqgrk", dog, vc32)
        ds = p * (dp - delta[..., None])            # (B,Sq,Hkv,R,block)
        # scores = (q*scale)@k  =>  dq = scale * ds@k;  dk = ds^T @ (q*scale)
        dq += torch.einsum("bqgrk,bkgd->bqgrd", ds, kc32) * scale
        dks.append(torch.einsum("bqgrk,bqgrd->bkgd", ds, qg))
    return (
        dq.reshape(b, sq, h, d).to(q.dtype),
        torch.cat(dks, dim=1).to(k.dtype),
        torch.cat(dvs, dim=1).to(v.dtype),
    )


# ---------------------------------------------------------------------------
# The kernels' wrappers.
# ---------------------------------------------------------------------------


def _launch_fwd(q, k, v, causal: bool, q_offset: int, lse: torch.Tensor | None) -> torch.Tensor:
    """The forward kernel on the current stream; writes ``lse`` when given."""
    b, s, h, _ = q.shape
    out = torch.empty((b, s, h, v.shape[3]), dtype=q.dtype, device=q.device)
    if out.numel():
        q, k, v = (t.clone(memory_format=torch.contiguous_format) if needs_copy(t) else t
                   for t in (q, k, v))
        lib = _lib()
        with _build.on_device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            rc = lib.flash_attention_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(), 0 if lse is None else lse.shape[-1],
                _DTYPES[q.dtype], b, s, k.shape[1], q_offset, h, k.shape[2], q.shape[3],
                v.shape[3], *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], int(causal),
                stream)
        _build.check(lib, rc, "flash_attention_fwd")
    return out


def _refuse_autograd(name: str, *tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} has no backward; call it under torch.no_grad() or use "
                           "the layers' attention (models.attention), which trains")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """q (B,Sq,H,D), k (B,Skv,Hkv,D), v (B,Skv,Hkv,Dv) -> (B,Sq,H,Dv) in q's
    dtype, query row i at position ``q_offset + i``.

    Forward only, like the TPU kernel: the call raises when autograd would
    need a gradient through it.  On the card, an operand the kernel cannot
    read where it lies (see :func:`needs_copy`: a head dim of non-unit
    stride; in bf16 a base address or a (B,S,H) stride that is not a
    multiple of 16 bytes) is first copied to a fresh contiguous tensor.
    """
    q_offset = int(q_offset)
    _check(q, k, v, q_offset)
    _refuse_autograd("flash_attention_fwd", q, k, v)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal, q_offset)[0]
    out = _launch_fwd(q, k, v, causal, q_offset, None)
    if out.numel():
        flash_attention_fwd.launches += 1
        flash_attention_fwd.offset_launches += q_offset > 0
    return out


flash_attention_fwd.launches = 0
flash_attention_fwd.offset_launches = 0


def flash_attention_fwd_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            causal: bool = True, q_offset: int = 0):
    """The forward of the training pair: (out, lse), out as
    :func:`flash_attention_fwd` gives it (the same kernel, so the same bits)
    and lse (B, H, lse_rows(Sq)) fp32, row i of head h at ``lse[b, h, i]``
    (rows past Sq 0).  bf16 operands of the head dims
    :data:`BWD_HEAD_DIMS`; forward only itself (``_BlockwiseAttention``
    calls it with autograd off and pairs it with :func:`flash_attention_bwd`).
    """
    q_offset = int(q_offset)
    _check(q, k, v, q_offset, pair=True)
    _refuse_autograd("flash_attention_fwd_lse", q, k, v)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal, q_offset)
    b, s, h, _ = q.shape
    lse = torch.empty((b, h, lse_rows(s)), dtype=torch.float32, device=q.device)
    lse[..., s:].zero_()            # the padding rows, as the plain version leaves them
    out = _launch_fwd(q, k, v, causal, q_offset, lse)
    if out.numel():
        flash_attention_fwd_lse.launches += 1
    return out, lse


flash_attention_fwd_lse.launches = 0


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                        dout: torch.Tensor, lse: torch.Tensor, causal: bool = True,
                        q_offset: int = 0):
    """Gradients (dq, dk, dv), bf16, of the attention whose forward
    :func:`flash_attention_fwd_lse` gave ``out`` and ``lse`` on the same q,
    k, v, ``causal`` and ``q_offset``, for the output's gradient ``dout``
    (B, Sq, H, Dv).  Deterministic: the same inputs give the same bits."""
    q_offset = int(q_offset)
    _check(q, k, v, q_offset, pair=True)
    b, s, h, d = q.shape
    skv, hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != (b, s, h, dv) or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} on {t.device}: expected "
                             f"{(b, s, h, dv)} {q.dtype} on {q.device}")
    if lse.shape != (b, h, lse_rows(s)) or lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(f"lse {tuple(lse.shape)} {lse.dtype}: expected "
                         f"{(b, h, lse_rows(s))} float32 on {q.device}")
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, dout, lse, causal, q_offset)
    grad_q = torch.empty_like(q, memory_format=torch.contiguous_format)
    grad_k = torch.empty((b, skv, hkv, d), dtype=q.dtype, device=q.device)
    grad_v = torch.empty((b, skv, hkv, dv), dtype=q.dtype, device=q.device)
    if not (grad_q.numel() and grad_k.numel()):
        return grad_q.zero_(), grad_k.zero_(), grad_v.zero_()
    q, k, v, out, dout = (t.clone(memory_format=torch.contiguous_format) if needs_copy(t) else t
                          for t in (q, k, v, out, dout))
    lse = lse.contiguous()
    dk_part = torch.empty((b, skv, h, d), dtype=torch.float32, device=q.device)
    dv_part = torch.empty((b, skv, h, dv), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    strides = (ctypes.c_int64 * 15)(*(st for t in (q, k, v, out, dout) for st in t.stride()[:3]))
    lib = _bwd_lib()
    with _build.on_device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), grad_q.data_ptr(), grad_k.data_ptr(), grad_v.data_ptr(),
            dk_part.data_ptr(), dv_part.data_ptr(), delta.data_ptr(), b, s, skv, q_offset, h,
            hkv, d, dv, lse.shape[-1], strides, int(causal), stream)
    _build.check(lib, rc, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return grad_q, grad_k, grad_v


flash_attention_bwd.launches = 0

#: every kernel wrapper of this module, for launch accounting
KERNELS = (flash_attention_fwd, flash_attention_fwd_lse, flash_attention_bwd)
