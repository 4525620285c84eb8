// Online-softmax attention forward (flash attention) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:
//   flash_attention_fwd  <- flash_attention_fwd (_flash_kernel)
//
// Computes, for q (B,Sq,H,D), k (B,Skv,Hkv,D), v (B,Skv,Hkv,Dv), bf16 or fp32:
//   out[b,i,h,:] = softmax_j(scale * q[b,i,h,:] . k[b,j,h/rep,:]) . v[b,j,h/rep,:]
// with rep = H / Hkv (grouped-query heads, KV never repeated in memory), an
// optional causal mask (j <= i + q_offset: query row i sits at position
// q_offset + i of the keys, as a context-parallel rank's slice of the rows
// does), fp32 accumulation, the scale applied in fp32, and p rounded to v's
// dtype before P.V (the row sum l taken from the unrounded p), all as the
// TPU kernel does.  The output has q's dtype and is (B,Sq,H,Dv), contiguous.
// The bf16 body can also write each row's log-sum-exp, lse = m + log(l)
// in fp32 (m the row's max scaled score), to an fp32 (B,H,lse_stride)
// buffer: the residual from which flash_attention_bwd.cu recomputes P.
//
// Bound on this card: operations.  A causal pass does B*H*S*(S+1)/2 * 2*(D+Dv)
// flops over (B*S*(H*D + Hkv*(D+Dv)) + B*S*H*Dv) * sizeof(T) bytes, between
// S/4 (H = Hkv) and S/2 (large rep) flops per byte in bf16: above the H100's
// ridge point (~295 flops/byte in bf16) at every sequence length the models
// run.  So the products must run on the tensor cores.
//
// Two bodies, chosen by dtype in the C entry point (no fallback from one to
// the other):
//
// bf16, the tensor-core body (namespace tc):
//  * One block of 384 threads per (b, h, 128-row q tile), on a 1-D grid
//    ordered so that the heaviest causal q tiles of every (b, h) come first
//    (neighbouring blocks then share their KV heads' tiles in L2).  The
//    block walks 128-key KV tiles in ascending order (the plain version's
//    order, so the running max, and with it every rounded p, is the same);
//    with a causal mask it stops at the tile holding key q0 + q_offset + 127
//    (the diagonal tile at q_offset 0).  A q tile's work grows with its
//    index at any offset, so the heaviest-first order stands.
//  * Warp specialisation: warpgroup 0 is the producer (setmaxnreg 24), whose
//    one thread loads Q once and K/V tiles into a ring of 2 stages by TMA,
//    with full (TMA bytes) and empty (256 consumer-thread arrivals)
//    mbarriers per stage.  Warpgroups 1 and 2 are consumers (setmaxnreg
//    240), each owning 64 q rows: S = Q.K^T by wgmma m64n128k16 with Q and
//    K K-major in shared memory; scale, mask (only on the tiles that cross
//    the diagonal and the tile holding Skv), online softmax in fp32 registers; p rounded to
//    bf16 in registers, where the accumulator fragment of S is already the
//    A fragment of P.V; O += P.V by wgmma m64n{Dv}k16 with V read MN-major
//    from its row-major tile (the transpose-B bit, no transpose pass).
//    A consumer issues tile t's Q.K^T and tile t-1's P.V together and runs
//    tile t's softmax while the tensor cores do that P.V (the arithmetic,
//    and so every bit of the output, is that of doing them in turn).
//  * The (B,S,H,D) layout is read through strides by 4-D tensor maps (one
//    per operand and column chunk) encoded on the host per call: rows at or
//    past Sq (Skv) load as zeros, keys at or past Skv score -1e30.  A row
//    that sees none of a tile's keys scores all of them -1e30, which leaves
//    its max, sum and output bit for bit as they were (the plain version
//    skips that tile for that row).  Rows are cut in
//    64-column chunks with the 128-byte swizzle and, for a width of 80 or
//    160, one or two 16-column chunks with the 32-byte swizzle.  TMA needs
//    16-byte aligned base addresses and strides; the Python wrapper copies
//    other operands.
//  * Shared memory: Q 128 x D, 2 stages of K 128 x D and V 128 x Dv, bf16:
//    208 KiB at D = 192, Dv = 128 and 201 KiB at D = Dv = 160 (zamba2's
//    shared block), of the 227 KiB a block may opt into.
//
// fp32, the SIMT body (namespace simt): the tensor cores have no exact fp32
// (TF32 keeps 10 mantissa bits), so fp32 FMAs on the CUDA cores:
//  * One block of 256 threads per (b, h, 64-row q tile), on a 1-D grid,
//    the heaviest causal tiles first, looping over 64-key KV tiles.
//  * Tiles are staged in shared memory as fp32 (q pre-scaled); the K and V
//    tiles share one buffer.  Each thread owns a 4x4 patch of the 64x64
//    score tile (rows 4*ty+i, key columns tx+16*j) and the same 4 rows of
//    the output (columns tx+16*j): fp32 FMAs over float4 shared reads,
//    row max and row sum over the 16 lanes of a half-warp by shuffles.
//  * The largest set (D=192, Dv=128) takes 115 KiB of shared memory.
//
// Every launch opts in to its shared memory first, and the host function
// returns cudaGetLastError() of the launch.

#include <algorithm>
#include <type_traits>
#include <cmath>
#include <cuda.h>
#include <cuda_bf16.h>

#include "bytes.cuh"
#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------------------
// bf16: the tensor-core body
// ---------------------------------------------------------------------------------------

namespace tc {

constexpr int kThreads = 384;    // producer warpgroup + 2 consumer warpgroups
constexpr int kBQ = 128;         // query rows per block, 64 per consumer
constexpr int kBK = 128;         // keys per KV tile
constexpr int kStages = 2;       // K/V ring
constexpr int kWideBytes = kBK * 128;   // a 64-column chunk of 128 rows (128B swizzle)
constexpr int kNarrowBytes = kBK * 32;  // a 16-column chunk of 128 rows (32B swizzle)
static_assert(kBQ == kBK, "a q tile and a KV tile have the same rows");

// A 128-row tile of W bf16 columns in shared memory: W / 64 chunks of 64
// columns, then (W % 64) / 16 chunks of 16.
template <int W> struct Tile {
  static constexpr int kWide = W / 64;
  static constexpr int kNarrow = (W % 64) / 16;
  static constexpr uint32_t kBytes = kWide * kWideBytes + kNarrow * kNarrowBytes;
  static_assert(W % 16 == 0 && kNarrow <= 2, "widths are 64a + 16b with b <= 2");
};

// TMA the 128 rows row0.. of one head into a Tile<W> at `dst`
template <int W>
__device__ __forceinline__ void load_tile(uint32_t dst, const Maps& m, const Perm& p,
                                          uint32_t bar, int head, int row0, int batch) {
  const int c1 = pick(p, 1, head, row0, batch), c2 = pick(p, 2, head, row0, batch),
            c3 = pick(p, 3, head, row0, batch);
#pragma unroll
  for (int i = 0; i < Tile<W>::kWide; ++i)
    tma_load_4d(dst + i * kWideBytes, &m.wide, bar, 64 * i, c1, c2, c3);
#pragma unroll
  for (int j = 0; j < Tile<W>::kNarrow; ++j)
    tma_load_4d(dst + Tile<W>::kWide * kWideBytes + j * kNarrowBytes, &m.narrow, bar,
                64 * Tile<W>::kWide + 16 * j, c1, c2, c3);
}

// K-major descriptor of k16 step ks of a Tile<W>, starting `row` rows in
template <int W>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int ks, int row) {
  if (ks < 4 * Tile<W>::kWide)
    return smem_desc(tile + (ks / 4) * kWideBytes + row * 128 + (ks % 4) * 32, 16, 1024,
                     kSwizzle128);
  // past the wide chunks, k16 step ks is the whole of narrow chunk ks - 4 * kWide
  return smem_desc(tile + Tile<W>::kWide * kWideBytes + (ks - 4 * Tile<W>::kWide) * kNarrowBytes +
                       row * 32,
                   16, 256, kSwizzle32);
}

template <int D, int DV>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tc(const __grid_constant__ Maps mq, const __grid_constant__ Maps mk,
             const __grid_constant__ Maps mv, Perm pq, Perm pk, Perm pv,
             __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int64_t lse_stride,
             int Sq, int Skv, int q_offset, int H, int rep, int nq, int bh_count, float scale,
             int causal) {
  using TQ = Tile<D>;
  using TV = Tile<DV>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzle atoms: 1 KiB
  const uint32_t sQ = base;
  const uint32_t sK = sQ + TQ::kBytes;
  const uint32_t sV = sK + kStages * TQ::kBytes;
  const uint32_t bars = sV + kStages * TV::kBytes;
  const uint32_t full_q = bars, full_k = bars + 8, full_v = bars + 24, empty = bars + 40;

  const int bid = blockIdx.x;
  const int bh = bid % bh_count;
  const int qt = nq - 1 - bid / bh_count;     // heaviest causal q tiles first
  const int h = bh % H, b = bh / H;
  const int q0 = qt * kBQ;
  const int nk = (Skv + kBK - 1) / kBK;
  const int last = causal ? min(nk - 1, (q0 + q_offset + kBQ - 1) / kBK) : nk - 1;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full_k + 8 * st, 1);
      mbar_init(full_v + 8 * st, 1);
      mbar_init(empty + 8 * st, 2 * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread keeps the ring full
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      const int hk = h / rep;
      mbar_expect_tx(full_q, TQ::kBytes);
      load_tile<D>(sQ, mq, pq, full_q, h, q0, b);
      for (int t = 0; t <= last; ++t) {
        const int st = t % kStages;
        if (t >= kStages) mbar_wait(empty + 8 * st, ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(full_k + 8 * st, TQ::kBytes);
        load_tile<D>(sK + st * TQ::kBytes, mk, pk, full_k + 8 * st, hk, t * kBK, b);
        mbar_expect_tx(full_v + 8 * st, TV::kBytes);
        load_tile<DV>(sV + st * TV::kBytes, mv, pv, full_v + 8 * st, hk, t * kBK, b);
      }
    }
  } else {
    // consumer c: q rows q0 + 64c .. q0 + 64c + 63
    setmaxnreg_inc<240>();
    const int c = wg - 1;
    const int tid = threadIdx.x % 128;
    const int row0 = q0 + 64 * c + 16 * (tid / 32) + (tid % 32) / 4;   // and row0 + 8
    const int col0 = 2 * (tid % 4);
    float s[64];                  // scores, then p: 64 rows x 128 keys over the warpgroup
    float acc[DV / 2];            // output: 64 rows x DV
    uint32_t p[32];               // p in bf16 pairs: the A fragments of P.V
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.f;

    // S = Q_c . K^T of tile t, issued and committed (not waited for)
    const auto issue_qk = [&](int t) {
      const int st = t % kStages;
      mbar_wait(full_k + 8 * st, (t / kStages) & 1);
      fence_regs<64>(s);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_ss_n128(s, kmajor_desc<D>(sQ, ks, 64 * c),
                      kmajor_desc<D>(sK + st * TQ::kBytes, ks, 0), ks > 0);
      wgmma_commit();
    };
    // O += P . V of tile t, issued and committed (not waited for)
    const auto issue_pv = [&](int t) {
      const int st = t % kStages;
      const uint32_t tv = sV + st * TV::kBytes;
      mbar_wait(full_v + 8 * st, (t / kStages) & 1);
      fence_regs<DV / 2>(acc);
      fence_regs<32>(p);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        if constexpr (TV::kWide > 0) {
          const uint64_t dv = smem_desc(tv + kk * 16 * 128, kWideBytes, 1024, kSwizzle128);
          if constexpr (TV::kWide == 2) wgmma_rs_n128(acc, p + 4 * kk, dv);
          else wgmma_rs_n64(acc, p + 4 * kk, dv);
        }
#pragma unroll
        for (int j = 0; j < TV::kNarrow; ++j) {
          const uint64_t dv = smem_desc(tv + TV::kWide * kWideBytes + j * kNarrowBytes +
                                            kk * 16 * 32,
                                        16, 256, kSwizzle32);
          wgmma_rs_n16(acc + 32 * TV::kWide + 8 * j, p + 4 * kk, dv);
        }
      }
      wgmma_commit();
    };
    // the online softmax of tile t's scores in s: p (unrounded) into s, the
    // new max and row sum, and each row's rescaling factor into alpha
    const auto softmax = [&](int t, float* alpha) {
      const int k0 = t * kBK;
      // scale in fp32; mask keys past Skv and, on a tile crossing the diagonal,
      // keys after the row's position
      const bool edge = k0 + kBK > Skv || (causal && k0 + kBK - 1 > q0 + q_offset);
#pragma unroll
      for (int e = 0; e < 64; ++e) {
        float x = s[e] * scale;
        if (edge) {
          const int key = k0 + 8 * (e / 4) + col0 + (e % 2);
          const int row = row0 + 8 * ((e / 2) % 2);
          if (key >= Skv || (causal && key > row + q_offset)) x = kNegInf;
        }
        s[e] = x;
      }
      // the 4 lanes of a quad share a row
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < 16; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[i], mx);
        alpha[i] = expf(m[i] - m_new);
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const float e = expf(s[4 * j + 2 * i + cc] - m_new);
            s[4 * j + 2 * i + cc] = e;
            rs += e;
          }
        rs += __shfl_xor_sync(0xffffffffu, rs, 1);
        rs += __shfl_xor_sync(0xffffffffu, rs, 2);
        l[i] = l[i] * alpha[i] + rs;
        m[i] = m_new;
      }
    };
    // once the last P.V is done: rescale O, and round p to bf16 pairs
    const auto rescale_and_pack = [&](const float* alpha) {
#pragma unroll
      for (int j = 0; j < DV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[4 * j + e] *= alpha[e / 2];
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const __nv_bfloat162 pair = __floats2bfloat162_rn(s[2 * r], s[2 * r + 1]);
        p[r] = *reinterpret_cast<const uint32_t*>(&pair);
      }
    };

    // Tile t's softmax runs while the tensor cores do tile t-1's P.V.
    float alpha[2];
    mbar_wait(full_q, 0);
    issue_qk(0);
    wgmma_wait<0>();
    fence_regs<64>(s);
    softmax(0, alpha);
    rescale_and_pack(alpha);
    for (int t = 1; t <= last; ++t) {
      issue_qk(t);
      issue_pv(t - 1);
      wgmma_wait<1>();                        // S of tile t is in
      fence_regs<64>(s);
      softmax(t, alpha);
      wgmma_wait<0>();                        // P.V of tile t-1 is done
      fence_regs<DV / 2>(acc);
      fence_regs<32>(p);
      mbar_arrive(empty + 8 * ((t - 1) % kStages));   // this thread is done with the stage
      rescale_and_pack(alpha);
    }
    issue_pv(last);
    wgmma_wait<0>();
    fence_regs<DV / 2>(acc);
    fence_regs<32>(p);
    mbar_arrive(empty + 8 * (last % kStages));

    // out = acc / max(l, 1e-30) in fp32, rounded to bf16, and lse = m + log(max(l, 1e-30))
    // by one lane of the quad; rows at or past Sq are not stored
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      if (row >= Sq) continue;
      const float ll = fmaxf(l[i], 1e-30f);
      if (lse != nullptr && tid % 4 == 0) lse[int64_t(bh) * lse_stride + row] = m[i] + logf(ll);
      __nv_bfloat16* orow = o + ((int64_t(b) * Sq + row) * H + h) * DV + col0;
#pragma unroll
      for (int j = 0; j < DV / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2 * i] / ll, acc[4 * j + 2 * i + 1] / ll);
    }
  }
}

// dynamic shared memory of a block: alignment slack, Q, the K/V ring, 7 mbarriers
template <int D, int DV> constexpr size_t smem_bytes() {
  return 1024 + (1 + kStages) * Tile<D>::kBytes + kStages * Tile<DV>::kBytes + 64;
}

// the shape of one call: q (B,Sq,H,D), k/v (B,Skv,Hkv,D/Dv), q rows at q_offset
struct Shape {
  int64_t B, Sq, Skv, H, Hkv, q_offset;
};

template <int D, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse,
                   int64_t lse_stride, const Shape& sh, const int64_t* st, bool causal,
                   cudaStream_t stream) {
  const int64_t B = sh.B, H = sh.H, Hkv = sh.Hkv;
  const int64_t nq = (sh.Sq + kBQ - 1) / kBQ;
  const int64_t blocks = B * H * nq;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  Maps mq, mk, mv;
  Perm pq, pk, pv;
  if (!encode({q, D, H, sh.Sq, B, st[0], st[1], st[2]}, kBK, &mq, &pq) ||
      !encode({k, D, Hkv, sh.Skv, B, st[3], st[4], st[5]}, kBK, &mk, &pk) ||
      !encode({v, DV, Hkv, sh.Skv, B, st[6], st[7], st[8]}, kBK, &mv, &pv))
    return cudaErrorInvalidValue;      // no driver entry point, or a map TMA refuses
  const size_t smem = smem_bytes<D, DV>();
  auto kernel = flash_fwd_tc<D, DV>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const float scale = float(1.0 / std::sqrt(double(D)));
  kernel<<<unsigned(blocks), kThreads, smem, stream>>>(
      mq, mk, mv, pq, pk, pv, static_cast<__nv_bfloat16*>(o), lse, lse_stride, int(sh.Sq),
      int(sh.Skv), int(sh.q_offset), int(H), int(H / Hkv), int(nq), int(B * H), scale,
      causal ? 1 : 0);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_dv(const void* q, const void* k, const void* v, void* o, float* lse,
                        int64_t lse_stride, const Shape& sh, int64_t DV, const int64_t* st,
                        bool causal, cudaStream_t stream) {
  switch (DV) {
    case 64: return launch<D, 64>(q, k, v, o, lse, lse_stride, sh, st, causal, stream);
    case 80: return launch<D, 80>(q, k, v, o, lse, lse_stride, sh, st, causal, stream);
    case 128: return launch<D, 128>(q, k, v, o, lse, lse_stride, sh, st, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, float* lse,
                     int64_t lse_stride, const Shape& sh, int64_t D, int64_t DV,
                     const int64_t* st, bool causal, cudaStream_t stream) {
  switch (D) {
    case 64: return dispatch_dv<64>(q, k, v, o, lse, lse_stride, sh, DV, st, causal, stream);
    case 80: return dispatch_dv<80>(q, k, v, o, lse, lse_stride, sh, DV, st, causal, stream);
    case 128: return dispatch_dv<128>(q, k, v, o, lse, lse_stride, sh, DV, st, causal, stream);
    case 160:   // zamba2's shared block: (160, 160) only
      if (DV != 160) return cudaErrorInvalidValue;
      return launch<160, 160>(q, k, v, o, lse, lse_stride, sh, st, causal, stream);
    case 192: return dispatch_dv<192>(q, k, v, o, lse, lse_stride, sh, DV, st, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

// ---------------------------------------------------------------------------------------
// fp32: the SIMT body
// ---------------------------------------------------------------------------------------

namespace simt {

constexpr int kThreads = 256;
constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // key rows per KV tile
constexpr int kPad = 4;          // floats of padding per shared row (float4-aligned)

__device__ __forceinline__ float lane(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// dst[r * ld + c] = scale * src[(s0 + r) * row_stride + c] for the 64
// rows r of a tile and the `width` columns c; rows at or past S (the
// operand's own length) are zero.
__device__ void load_tile(float* dst, int ld, const float* __restrict__ src, int64_t row_stride,
                          int s0, int S, int width, float scale) {
  const int total = kBK * width;
  for (int e = threadIdx.x; e < total; e += kThreads) {
    const int r = e / width;
    const int c = e - r * width;
    float x = 0.f;
    if (s0 + r < S) x = src[int64_t(s0 + r) * row_stride + c] * scale;
    dst[r * ld + c] = x;
  }
}

template <int DV>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int Sq, int Skv,
                 int q_offset, int H, int Hkv, int D, int nq,
                 int64_t q_sb, int64_t q_ss, int64_t q_sh,
                 int64_t k_sb, int64_t k_ss, int64_t k_sh,
                 int64_t v_sb, int64_t v_ss, int64_t v_sh,
                 float scale, bool causal) {
  constexpr int NJ = DV / 16;    // output columns per thread
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ldq = D + kPad;
  const int ldkv = max(D, DV) + kPad;
  constexpr int ldp = kBK + kPad;
  float* sQ = smem;                       // kBQ x ldq, q * scale
  float* sKV = sQ + kBQ * ldq;            // kBK x ldkv, K then V of one tile
  float* sP = sKV + kBK * ldkv;           // kBQ x ldp, p

  const int64_t bid = blockIdx.x;
  const int qt = nq - 1 - int(bid % nq);  // heaviest causal tiles first
  const int64_t bh = bid / nq;
  const int h = int(bh % H);
  const int64_t b = bh / H;
  const int hk = h / (H / Hkv);
  const int q0 = qt * kBQ;

  const int tx = threadIdx.x & 15;        // key / output columns tx + 16*j
  const int ty = threadIdx.x >> 4;        // query rows 4*ty + i

  const float* qh = q + b * q_sb + int64_t(h) * q_sh;
  const float* kh = k + b * k_sb + int64_t(hk) * k_sh;
  const float* vh = v + b * v_sb + int64_t(hk) * v_sh;
  load_tile(sQ, ldq, qh, q_ss, q0, Sq, D, scale);

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  const int nk = (Skv + kBK - 1) / kBK;
  const int last = causal ? min(nk - 1, (q0 + q_offset + kBQ - 1) / kBK) : nk - 1;
  for (int kt = 0; kt <= last; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                      // the last tile's P.V is done with sKV, sP
    load_tile(sKV, ldkv, kh, k_ss, k0, Skv, D, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; d += 4) {
      float4 a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(sQ + (4 * ty + i) * ldq + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        c[j] = *reinterpret_cast<const float4*>(sKV + (tx + 16 * j) * ldkv + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, c[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, c[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, c[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, c[j].w, s[i][j]);
        }
    }

    // keys at or past Skv, and with a causal mask keys after the query's
    // position (q_offset + its row), score -1e30
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        if (kp >= Skv || (causal && kp > q0 + 4 * ty + i + q_offset)) s[i][j] = kNegInf;
      }

    // online softmax; the 16 lanes sharing a row are one half-warp, and the
    // xor butterflies leave every lane with the same bits
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        sP[(4 * ty + i) * ldp + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + rs;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();                      // every thread is done reading K
    load_tile(sKV, ldkv, vh, v_ss, k0, Skv, DV, 1.f);
    __syncthreads();

    for (int kk = 0; kk < kBK; kk += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p4[i] = *reinterpret_cast<const float4*>(sP + (4 * ty + i) * ldp + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vrow = sKV + (kk + u) * ldkv + tx;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float vv = vrow[16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(lane(p4[i], u), vv, acc[i][j]);
        }
      }
    }
  }

  const int64_t o_ss = int64_t(H) * DV;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + 4 * ty + i;
    if (qp >= Sq) continue;
    const float ll = fmaxf(l[i], 1e-30f);
    float* orow = o + (b * Sq + qp) * o_ss + int64_t(h) * DV;
#pragma unroll
    for (int j = 0; j < NJ; ++j) orow[tx + 16 * j] = acc[i][j] / ll;
  }
}

template <int DV>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, const tc::Shape& sh,
                   int64_t D, const int64_t* strides, bool causal, cudaStream_t stream) {
  const int64_t B = sh.B, H = sh.H, Hkv = sh.Hkv;
  const int64_t nq = (sh.Sq + kBQ - 1) / kBQ;
  const int64_t blocks = B * H * nq;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  const int64_t ldq = D + kPad, ldkv = (D > DV ? D : DV) + kPad, ldp = kBK + kPad;
  const size_t smem = size_t(kBQ * ldq + kBK * ldkv + kBQ * ldp) * sizeof(float);
  auto kernel = flash_fwd_kernel<DV>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const float scale = float(1.0 / std::sqrt(double(D)));
  kernel<<<unsigned(blocks), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), int(sh.Sq), int(sh.Skv), int(sh.q_offset), int(H), int(Hkv),
      int(D), int(nq),
      strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
      strides[6], strides[7], strides[8], scale, causal);
  return cudaGetLastError();
}


cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, const tc::Shape& sh,
                     int64_t D, int64_t DV, const int64_t* strides, bool causal,
                     cudaStream_t stream) {
  switch (DV) {
    case 64: return launch<64>(q, k, v, o, sh, D, strides, causal, stream);
    case 80: return launch<80>(q, k, v, o, sh, D, strides, causal, stream);
    case 128: return launch<128>(q, k, v, o, sh, D, strides, causal, stream);
    case 160: return launch<160>(q, k, v, o, sh, D, strides, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace simt

}  // namespace

// q (B,Sq,H,D), k (B,Skv,Hkv,D), v (B,Skv,Hkv,Dv) with element strides
// {q,k,v}_s{b,s,h} and unit stride in the last dim -> o (B,Sq,H,Dv),
// contiguous; query row i at position q_offset + i.  dtype: 0 = fp32 (the
// SIMT body), 1 = bf16 (the tensor-core body; base addresses and strides
// 16-byte aligned).  With `lse` not null (bf16 only), row i of head h of
// batch b writes its log-sum-exp to lse[(b * H + h) * lse_stride + i],
// lse_stride >= Sq.  The caller checks shapes, H % Hkv == 0, (D, Dv) in
// {64, 80, 128, 192} x {64, 80, 128} or (160, 160), B, Sq, Skv >= 1 and
// q_offset >= 0.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   float* lse, int64_t lse_stride, int dtype, int64_t B,
                                   int64_t Sq, int64_t Skv, int64_t q_offset, int64_t H,
                                   int64_t Hkv, int64_t D, int64_t DV, int64_t q_sb,
                                   int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss,
                                   int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
                                   int causal, void* stream) {
  if (D % 16 != 0 || D < 16 || D > 192 || Sq > 0x7fffffff || Skv > 0x7fffffff ||
      q_offset < 0 || Sq + q_offset > 0x7fffffff || H % Hkv != 0 ||
      (lse != nullptr && (dtype != 1 || lse_stride < Sq)))
    return int(cudaErrorInvalidValue);
  const int64_t strides[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  const tc::Shape sh{B, Sq, Skv, H, Hkv, q_offset};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return int(simt::dispatch(q, k, v, o, sh, D, DV, strides, causal != 0, st));
  if (dtype == 1)
    return int(tc::dispatch(q, k, v, o, lse, lse_stride, sh, D, DV, strides, causal != 0, st));
  return int(cudaErrorInvalidValue);
}

// Bytes of dynamic shared memory a block of the tensor-core body takes at
// (D, DV), or 0 for a pair it does not take.
extern "C" int64_t flash_attention_tc_smem_bytes(int64_t D, int64_t DV) {
  int64_t bytes = 0;
  const auto pick = [&](auto d) {
    constexpr int kD = decltype(d)::value;
    if (DV == 64) bytes = int64_t(tc::smem_bytes<kD, 64>());
    if (DV == 80) bytes = int64_t(tc::smem_bytes<kD, 80>());
    if (DV == 128) bytes = int64_t(tc::smem_bytes<kD, 128>());
  };
  if (D == 64) pick(std::integral_constant<int, 64>{});
  if (D == 80) pick(std::integral_constant<int, 80>{});
  if (D == 128) pick(std::integral_constant<int, 128>{});
  if (D == 192) pick(std::integral_constant<int, 192>{});
  if (D == 160 && DV == 160) bytes = int64_t(tc::smem_bytes<160, 160>());
  return bytes;
}
