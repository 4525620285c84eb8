// Attention backward (flash attention's gradients) for Hopper (sm_90a).
//
// Replaces no TPU kernel: the Pallas flash kernel (src/repro/kernels/
// flash_attention.py) is forward only, and the reference trains on the jnp
// custom_vjp of blockwise attention (src/repro/models/attention.py).  It
// is the backward of the port's training attention (models/attention.py
// _BlockwiseAttention on bf16 CUDA tensors), whose forward is the bf16 body
// of flash_attention.cu writing each row's log-sum-exp.
//
// For q (B,Sq,H,D), k (B,Skv,Hkv,D), v (B,Skv,Hkv,Dv), bf16, (D, Dv) =
// (128, 128) (yi and most GQA models) or (192, 128) (DeepSeek-V2's MLA:
// 128 + 64 rotary dims for q and k), rep = H / Hkv, the forward's out and
// lse, and dout (B,Sq,H,Dv), with query row i at position q_offset + i and
// the optional causal mask (key j <= q_offset + i):
//   S = scale * Q.K^T           (bf16 products, fp32 sums, then the scale
//                                1/sqrt(D) in fp32, rounded before lse is
//                                taken off, as the forward rounds it: a row's
//                                largest score gives exp(0) = 1 exactly, not
//                                an FMA's residue)
//   P = exp(S - lse)            (fp32; 0 where masked)
//   dP = dO.V^T                 (bf16 products, fp32 sums)
//   delta = rowsum(dO * O)      (fp32)
//   dS = P * (dP - delta)       (fp32)
//   dV = P^T.dO,  dK = scale * dS^T.Q,  dQ = scale * dS.K
// summed over every query row (and, for dK and dV, every query head of the
// KV head), rounded to bf16 once at the end.  That is the arithmetic of the
// plain version (models/attention.py _attention_bwd_plain), which holds P
// and dS in fp32: the three products with an fp32 operand take P and dS as
// three bf16 terms each, hi + mid + lo (hi = bf16(x), mid = bf16(x - hi),
// lo = bf16(x - hi - mid): 24 significant bits, x to within 2^-27 |x|),
// every term exact against a bf16 operand and all summed in the fp32
// accumulators.  So the two differ only in the order of fp32 sums.
//
// Bound on this card: tensor-core operations.  With the splits, a visible
// (query row, key) pair costs 8D + 5Dv bf16 products of depth 1 over the
// two kernels below (S, of depth D, and dP, of depth Dv, in each; 3 terms
// for each of dV (Dv wide), dK and dQ (D wide)): 13 x 128 at yi's widths,
// 2,176 at MLA's, twice that in flops, against q, k, v, out and dO read
// once: for yi-9b's causal S = 4096 layer (32 query heads over 4), 0.89
// TFLOP against 0.11 GB, far above the ridge point (~295 flops a byte in
// bf16).  What the design does about it: every product is a wgmma with its
// B operand (and the A operand of S and dP) in shared memory, fed by TMA;
// pairs the causal mask empties are skipped whole; a consumer warpgroup's
// fp32 elementwise work (exp, the splits) runs while the other's products
// do.
//
// Deterministic: no atomics.  dK and dV come from one kernel that walks
// the query tiles for a fixed key tile; dQ from another that walks the key
// tiles for a fixed query tile; each query head's share of dK and dV goes
// to an fp32 buffer, and a third kernel sums the rep shares of a KV head in
// head order.  Every sum has a fixed order, so a rerun gives the same bits.
//
// One algorithm for both head dims; the tiles are functions of (D, Dv),
// set by the registers a consumer thread holds (at most 240 after
// setmaxnreg) and the shared memory a block may opt into (227 KiB).
//
// The kernels of one call, in stream order:
//  * flash_bwd_delta: delta for every row, a warp a row (0 on the rows
//    between Sq and the padded stride).
//  * flash_bwd_dkdv: one block of 384 threads per (b, h, 128-key tile), on
//    a 1-D grid with the key tiles that see the most query rows first.
//    Warpgroup 0 is the producer (setmaxnreg 24): its one thread loads the K
//    and V tiles once and the (Q, dO) tiles of kBQ rows into a ring by TMA.
//    Warpgroups 1 and 2 are consumers (setmaxnreg 240), each owning 64 keys:
//    S^T = K.Q^T and dP^T = V.dO^T by wgmma m64n{kBQ}k16 from shared memory,
//    P^T and dS^T in fp32 registers, whose accumulator fragments are the A
//    fragments of dV += P^T.dO and dK += dS^T.Q (wgmma m64n{Dv}k16 and
//    m64n{D}k16, B read MN-major from the row-major tiles).  A consumer
//    thread holds dK and dV (D/2 + Dv/2 fp32) and S^T and dP^T (kBQ/2 each):
//    kBQ is 64 with a ring of 2 stages at D = 128 (192 registers of
//    accumulators), 32 with a ring of 4 at D = 192 (the same 192).  Under
//    the causal mask the walk starts at the first query tile with a row at
//    or past the tile's first key, and a consumer skips a tile none of whose
//    rows sees its keys.
//  * flash_bwd_dq: one block per (b, h, 128-row query tile), the heaviest
//    causal tiles first.  The producer loads Q and dO once and (K, V) tiles
//    of 64 keys into a ring of 2, stopping at the tile holding the block's
//    last visible key; each consumer owns 64 rows: S = Q.K^T, dP = dO.V^T,
//    then dQ += dS.K with K read MN-major (m64n{D}k16; D/2 + 64 registers
//    of accumulators).
//  * flash_bwd_group_sum, twice: dK and dV of each KV head, rounded to bf16.
//
// Rows at or past Sq and keys at or past Skv load as zeros (TMA) and are
// masked out of P and dS; lse and delta are read from buffers padded to a
// multiple of 64 rows.  Shared memory: 129 KiB a block in both kernels at
// D = 128, 161 KiB at D = 192, of the 227 KiB a block may opt into.  Every
// launch opts in first, and the host function returns cudaGetLastError()
// of the launches.

#include <cmath>
#include <cuda.h>
#include <cuda_bf16.h>

#include "bytes.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 384;    // producer warpgroup + 2 consumer warpgroups
constexpr int kLsePad = 64;      // lse and delta rows are padded to this multiple

// A tile of R rows x W bf16 columns in shared memory: W / 64 chunks of 64
// columns, each R rows of 128 bytes (the 128-byte swizzle).
template <int R, int W> struct Tile {
  static_assert(W % 64 == 0, "widths are whole 64-column chunks");
  static constexpr int kChunks = W / 64;
  static constexpr uint32_t kChunkBytes = R * 128;
  static constexpr uint32_t kBytes = kChunks * kChunkBytes;
};

// TMA the R rows row0.. of one head into a Tile<R, W> at `dst`
template <int R, int W>
__device__ __forceinline__ void load_tile(uint32_t dst, const Maps& m, const Perm& p,
                                          uint32_t bar, int head, int row0, int batch) {
  const int c1 = pick(p, 1, head, row0, batch), c2 = pick(p, 2, head, row0, batch),
            c3 = pick(p, 3, head, row0, batch);
#pragma unroll
  for (int i = 0; i < Tile<R, W>::kChunks; ++i)
    tma_load_4d(dst + i * Tile<R, W>::kChunkBytes, &m.wide, bar, 64 * i, c1, c2, c3);
}

// K-major descriptor of k16 step ks of a tile of R rows, `row` rows in: the
// tile as a wgmma A operand (rows = M) or B operand (rows = N)
template <int R>
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int ks, int row) {
  return smem_desc(tile + (ks / 4) * (R * 128) + row * 128 + (ks % 4) * 32, 16, 1024,
                   kSwizzle128);
}

// MN-major descriptor of rows 16kk .. 16kk + 15 of a tile of R rows: the
// tile as a wgmma B operand with K = its rows and N = its columns
template <int R>
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int kk) {
  return smem_desc(tile + kk * 16 * 128, R * 128, 1024, kSwizzle128);
}

// d (64 x N) (+)= A . B^T, both K-major in shared memory
template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db, int accumulate) {
  static_assert(N == 32 || N == 64, "S and dP tiles are 32 or 64 wide");
  if constexpr (N == 64) wgmma_ss_n64(d, da, db, accumulate);
  else wgmma_ss_n32(d, da, db, accumulate);
}

// d (64 x N) += A (bf16 registers) . B (MN-major in shared memory)
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db) {
  static_assert(N == 128 || N == 192, "gradients are 128 or 192 wide");
  if constexpr (N == 128) wgmma_rs_n128(d, a, db);
  else wgmma_rs_n192(d, a, db);
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<const uint32_t*>(&x);
}

// The N fp32 values of an m64 accumulator fragment N / 2 columns wide as
// three bf16 terms, each in the A-fragment order of the k16 slices kk at
// 4kk (see hopper.cuh): x = hi + mid + lo, every subtraction exact.
template <int N>
__device__ __forceinline__ void split3(const float* x, uint32_t* hi, uint32_t* mid, uint32_t* lo) {
#pragma unroll
  for (int r = 0; r < N / 2; ++r) {
    const float a = x[2 * r], b = x[2 * r + 1];
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    const float a1 = a - __low2float(h), b1 = b - __high2float(h);
    const __nv_bfloat162 m = __floats2bfloat162_rn(a1, b1);
    const float a2 = a1 - __low2float(m), b2 = b1 - __high2float(m);
    hi[r] = bits(h);
    mid[r] = bits(m);
    lo[r] = bits(__floats2bfloat162_rn(a2, b2));
  }
}

// acc (64 x N, fp32) += A . B over the K / 16 k16 slices of a K-deep
// product, A the three terms in `a` (hi, mid, lo: K / 4 registers each), B
// the first K rows of a tile of R rows, MN-major
template <int R, int N, int K>
__device__ __forceinline__ void product3(float* acc, const uint32_t* a, uint32_t tile) {
#pragma unroll
  for (int term = 0; term < 3; ++term)
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk)
      wgmma_rs<N>(acc, a + (K / 4) * term + 4 * kk, mnmajor<R>(tile, kk));
}

// ---------------------------------------------------------------------------------------
// delta = rowsum(dO * O)
// ---------------------------------------------------------------------------------------

// One warp per row r of the (B, H, stride) buffer: r = (b * H + h) * stride + i;
// lane l takes columns 4l .. 4l + 3 of each 128.
template <int DV>
__global__ void __launch_bounds__(256)
flash_bwd_delta(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
                float* __restrict__ delta, int64_t rows, int64_t stride, int Sq, int H,
                int64_t o_sb, int64_t o_ss, int64_t o_sh, int64_t d_sb, int64_t d_ss,
                int64_t d_sh) {
  static_assert(DV % 128 == 0, "a warp reads 128 columns at a time");
  const int64_t r = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  const int64_t i = r % stride, bh = r / stride;
  const int64_t h = bh % H, b = bh / H;
  float acc = 0.f;
  if (i < Sq) {
#pragma unroll
    for (int c = 0; c < DV / 128; ++c) {
      const int col = 128 * c + 4 * lane;
      const uint2 x = *reinterpret_cast<const uint2*>(o + b * o_sb + i * o_ss + h * o_sh + col);
      const uint2 y =
          *reinterpret_cast<const uint2*>(dout + b * d_sb + i * d_ss + h * d_sh + col);
      const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&x);
      const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        acc = fmaf(__low2float(xp[j]), __low2float(yp[j]), acc);
        acc = fmaf(__high2float(xp[j]), __high2float(yp[j]), acc);
      }
    }
  }
#pragma unroll
  for (int off = 16; off; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[r] = acc;
}

// ---------------------------------------------------------------------------------------
// dK, dV: a block per (b, h, key tile)
// ---------------------------------------------------------------------------------------

namespace dkdv {

constexpr int kBK = 128;         // keys per block, 64 per consumer

// Query rows a step: a consumer thread holds dK and dV (D/2 + DV/2 fp32) and
// S^T and dP^T (kBQ/2 each) in at most 192 registers, which leaves room
// within 240 for the split terms and addresses: 64 at D = DV = 128, 32 at
// D = 192, DV = 128.
__host__ __device__ constexpr int query_rows(int d, int dv) {
  return (d + dv) / 2 + 64 <= 192 ? 64 : 32;
}
// stages of the (Q, dO) ring: 128 query rows in flight whatever the step
__host__ __device__ constexpr int stages(int d, int dv) { return 128 / query_rows(d, dv); }

template <int D, int DV> constexpr size_t smem_bytes() {
  constexpr int bq = query_rows(D, DV), st = stages(D, DV);
  constexpr size_t bars = (8 + 16 * st + 63) / 64 * 64;   // full_kv, full and empty a stage
  return 1024 + Tile<kBK, D>::kBytes + Tile<kBK, DV>::kBytes +
         st * (Tile<bq, D>::kBytes + Tile<bq, DV>::kBytes) + bars;
}

template <int D, int DV>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv(const __grid_constant__ Maps mq, const __grid_constant__ Maps mk,
               const __grid_constant__ Maps mv, const __grid_constant__ Maps mo, Perm pq,
               Perm pk, Perm pv, Perm po, const float* __restrict__ lse,
               const float* __restrict__ delta, int64_t row_stride, float* __restrict__ dk,
               float* __restrict__ dv, int Sq, int Skv, int q_offset, int H, int rep,
               int bh_count, float scale, int causal) {
  constexpr int kBQ = query_rows(D, DV);   // query rows per step
  constexpr int kStages = stages(D, DV);
  using TK = Tile<kBK, D>;
  using TV = Tile<kBK, DV>;
  using TQ = Tile<kBQ, D>;
  using TO = Tile<kBQ, DV>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzle atoms: 1 KiB
  const uint32_t sK = base, sV = sK + TK::kBytes;
  const uint32_t sQ = sV + TV::kBytes;                           // kStages tiles
  const uint32_t sO = sQ + kStages * TQ::kBytes;                 // kStages tiles of dO
  const uint32_t bars = sO + kStages * TO::kBytes;
  const uint32_t full_kv = bars, full = bars + 8, empty = bars + 8 + 8 * kStages;

  const int bid = blockIdx.x;
  const int bh = bid % bh_count;
  const int k0 = (bid / bh_count) * kBK;        // the key tiles most rows see first
  const int h = bh % H, b = bh / H;
  const int nq = (Sq + kBQ - 1) / kBQ;
  // with a causal mask, the first query tile holding a row at or past key k0
  const int first = causal ? max(0, (k0 - q_offset) / kBQ) : 0;

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, 2 * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0 && first < nq) {
      const int hk = h / rep;
      mbar_expect_tx(full_kv, TK::kBytes + TV::kBytes);
      load_tile<kBK, D>(sK, mk, pk, full_kv, hk, k0, b);
      load_tile<kBK, DV>(sV, mv, pv, full_kv, hk, k0, b);
      for (int t = first, i = 0; t < nq; ++t, ++i) {
        const int st = i % kStages;
        if (i >= kStages) mbar_wait(empty + 8 * st, ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * st, TQ::kBytes + TO::kBytes);
        load_tile<kBQ, D>(sQ + st * TQ::kBytes, mq, pq, full + 8 * st, h, t * kBQ, b);
        load_tile<kBQ, DV>(sO + st * TO::kBytes, mo, po, full + 8 * st, h, t * kBQ, b);
      }
    }
  } else {
    // consumer c: keys k0 + 64c .. k0 + 64c + 63
    setmaxnreg_inc<240>();
    const int c = wg - 1;
    const int tid = threadIdx.x % 128;
    const int kc = k0 + 64 * c;
    const int key0 = kc + 16 * (tid / 32) + (tid % 32) / 4;   // and key0 + 8
    const int col0 = 2 * (tid % 4);
    float dk_acc[D / 2], dv_acc[DV / 2];   // 64 keys x D and x DV over the warpgroup
    float s[kBQ / 2], dp[kBQ / 2];         // S^T then P^T, dP^T then dS^T: 64 keys x kBQ rows
    uint32_t a[3 * kBQ / 4];               // three bf16 terms of P^T or dS^T, as A fragments
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) dv_acc[i] = 0.f;
    const float* lse_bh = lse + int64_t(bh) * row_stride;
    const float* delta_bh = delta + int64_t(bh) * row_stride;
    if (first < nq) mbar_wait(full_kv, 0);

    for (int t = first, i = 0; t < nq; ++t, ++i) {
      const int st = i % kStages;
      const uint32_t tq = sQ + st * TQ::kBytes, to = sO + st * TO::kBytes;
      const int q0 = t * kBQ;
      mbar_wait(full + 8 * st, (i / kStages) & 1);
      if (causal && kc > q0 + kBQ - 1 + q_offset) {   // no row of the tile sees these keys
        mbar_arrive(empty + 8 * st);
        continue;
      }
      fence_regs<kBQ / 2>(s);
      fence_regs<kBQ / 2>(dp);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_ss<kBQ>(s, kmajor<kBK>(sK, ks, 64 * c), kmajor<kBQ>(tq, ks, 0), ks > 0);
#pragma unroll
      for (int ks = 0; ks < DV / 16; ++ks)
        wgmma_ss<kBQ>(dp, kmajor<kBK>(sV, ks, 64 * c), kmajor<kBQ>(to, ks, 0), ks > 0);
      wgmma_commit();
      // the thread's kBQ/4 rows q0 + 8j + col0 + {0, 1}: their lse and delta
      float2 ls[kBQ / 8], dl[kBQ / 8];
#pragma unroll
      for (int j = 0; j < kBQ / 8; ++j) {
        ls[j] = __ldg(reinterpret_cast<const float2*>(lse_bh + q0 + 8 * j + col0));
        dl[j] = __ldg(reinterpret_cast<const float2*>(delta_bh + q0 + 8 * j + col0));
      }
      wgmma_wait<0>();
      fence_regs<kBQ / 2>(s);
      fence_regs<kBQ / 2>(dp);

      // P^T = exp(scale S^T - lse), dS^T = P^T (dP^T - delta), 0 where masked: rows past
      // Sq, keys past Skv and, on a tile crossing the diagonal, keys after the row
      const bool edge = q0 + kBQ > Sq || k0 + kBK > Skv ||
                        (causal && kc + 63 > q0 + q_offset);
#pragma unroll
      for (int e = 0; e < kBQ / 2; ++e) {
        const int j = e / 4, cc = e % 2;
        const float p = expf(__fmul_rn(s[e], scale) - (cc ? ls[j].y : ls[j].x));
        float pe = p, ds = p * (dp[e] - (cc ? dl[j].y : dl[j].x));
        if (edge) {
          const int key = key0 + 8 * ((e / 2) % 2);
          const int row = q0 + 8 * j + col0 + cc;
          const bool keep = row < Sq && key < Skv && (!causal || key <= row + q_offset);
          pe = keep ? pe : 0.f;
          ds = keep ? ds : 0.f;
        }
        s[e] = pe;
        dp[e] = ds;
      }

      // dV += P^T . dO, then dK += dS^T . Q, each in three terms
      constexpr int kTerm = kBQ / 4;                 // registers of one term
      split3<kBQ / 2>(s, a, a + kTerm, a + 2 * kTerm);
      fence_regs<3 * kTerm>(a);
      fence_regs<DV / 2>(dv_acc);
      wgmma_fence();
      product3<kBQ, DV, kBQ>(dv_acc, a, to);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<DV / 2>(dv_acc);
      fence_regs<3 * kTerm>(a);
      split3<kBQ / 2>(dp, a, a + kTerm, a + 2 * kTerm);
      fence_regs<3 * kTerm>(a);
      fence_regs<D / 2>(dk_acc);
      wgmma_fence();
      product3<kBQ, D, kBQ>(dk_acc, a, tq);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<D / 2>(dk_acc);
      fence_regs<3 * kTerm>(a);
      mbar_arrive(empty + 8 * st);    // this thread is done with the stage
    }

    // this query head's share of dK (times scale) and dV, in fp32; keys past Skv not stored
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = key0 + 8 * i;
      if (key >= Skv) continue;
      const int64_t row = (int64_t(b) * Skv + key) * H + h;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(dk + row * D + col0 + 8 * j) =
            make_float2(dk_acc[4 * j + 2 * i] * scale, dk_acc[4 * j + 2 * i + 1] * scale);
#pragma unroll
      for (int j = 0; j < DV / 8; ++j)
        *reinterpret_cast<float2*>(dv + row * DV + col0 + 8 * j) =
            make_float2(dv_acc[4 * j + 2 * i], dv_acc[4 * j + 2 * i + 1]);
    }
  }
}

}  // namespace dkdv

// ---------------------------------------------------------------------------------------
// dQ: a block per (b, h, query tile)
// ---------------------------------------------------------------------------------------

namespace dq {

constexpr int kBQ = 128;         // query rows per block, 64 per consumer
constexpr int kBK = 64;          // keys per step
constexpr int kStages = 2;       // the ring of (K, V) tiles

template <int D, int DV> constexpr size_t smem_bytes() {
  return 1024 + Tile<kBQ, D>::kBytes + Tile<kBQ, DV>::kBytes +
         kStages * (Tile<kBK, D>::kBytes + Tile<kBK, DV>::kBytes) + 64;
}

template <int D, int DV>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq(const __grid_constant__ Maps mq, const __grid_constant__ Maps mk,
             const __grid_constant__ Maps mv, const __grid_constant__ Maps mo, Perm pq, Perm pk,
             Perm pv, Perm po, const float* __restrict__ lse, const float* __restrict__ delta,
             int64_t row_stride, __nv_bfloat16* __restrict__ dq, int Sq, int Skv, int q_offset,
             int H, int rep, int nq, int bh_count, float scale, int causal) {
  using TQ = Tile<kBQ, D>;
  using TO = Tile<kBQ, DV>;
  using TK = Tile<kBK, D>;
  using TV = Tile<kBK, DV>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sO = sQ + TQ::kBytes;
  const uint32_t sK = sO + TO::kBytes;                           // kStages tiles
  const uint32_t sV = sK + kStages * TK::kBytes;                 // kStages tiles
  const uint32_t bars = sV + kStages * TV::kBytes;
  const uint32_t full_q = bars, full = bars + 8, empty = bars + 8 + 8 * kStages;

  const int bid = blockIdx.x;
  const int bh = bid % bh_count;
  const int q0 = (nq - 1 - bid / bh_count) * kBQ;   // heaviest causal q tiles first
  const int h = bh % H, b = bh / H;
  const int nk = (Skv + kBK - 1) / kBK;
  const int last = causal ? min(nk - 1, (q0 + q_offset + kBQ - 1) / kBK) : nk - 1;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, 2 * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      const int hk = h / rep;
      mbar_expect_tx(full_q, TQ::kBytes + TO::kBytes);
      load_tile<kBQ, D>(sQ, mq, pq, full_q, h, q0, b);
      load_tile<kBQ, DV>(sO, mo, po, full_q, h, q0, b);
      for (int t = 0; t <= last; ++t) {
        const int st = t % kStages;
        if (t >= kStages) mbar_wait(empty + 8 * st, ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * st, TK::kBytes + TV::kBytes);
        load_tile<kBK, D>(sK + st * TK::kBytes, mk, pk, full + 8 * st, hk, t * kBK, b);
        load_tile<kBK, DV>(sV + st * TV::kBytes, mv, pv, full + 8 * st, hk, t * kBK, b);
      }
    }
  } else {
    // consumer c: rows q0 + 64c .. q0 + 64c + 63
    setmaxnreg_inc<240>();
    const int c = wg - 1;
    const int tid = threadIdx.x % 128;
    const int qc = q0 + 64 * c;
    const int row0 = qc + 16 * (tid / 32) + (tid % 32) / 4;   // and row0 + 8
    const int col0 = 2 * (tid % 4);
    float acc[D / 2];               // dQ: 64 rows x D over the warpgroup
    float s[32], dp[32];            // S then P, dP then dS: 64 rows x 64 keys
    uint32_t a[48];                 // three bf16 terms of dS, as A fragments
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    // the rows' lse and delta (rows past Sq: 0, which leaves their P finite)
    float ls[2], dl[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      const int64_t at = int64_t(bh) * row_stride + row;
      ls[i] = row < Sq ? lse[at] : 0.f;
      dl[i] = row < Sq ? delta[at] : 0.f;
    }
    mbar_wait(full_q, 0);

    for (int t = 0; t <= last; ++t) {
      const int st = t % kStages;
      const uint32_t tk = sK + st * TK::kBytes, tv = sV + st * TV::kBytes;
      const int k0 = t * kBK;
      mbar_wait(full + 8 * st, (t / kStages) & 1);
      if (causal && k0 > qc + 63 + q_offset) {    // no row of this consumer sees the tile
        mbar_arrive(empty + 8 * st);
        continue;
      }
      fence_regs<32>(s);
      fence_regs<32>(dp);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_ss<kBK>(s, kmajor<kBQ>(sQ, ks, 64 * c), kmajor<kBK>(tk, ks, 0), ks > 0);
#pragma unroll
      for (int ks = 0; ks < DV / 16; ++ks)
        wgmma_ss<kBK>(dp, kmajor<kBQ>(sO, ks, 64 * c), kmajor<kBK>(tv, ks, 0), ks > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<32>(s);
      fence_regs<32>(dp);

      // dS = exp(scale S - lse) (dP - delta), 0 for keys past Skv and, on a tile
      // crossing the diagonal, keys after the row
      const bool edge = k0 + kBK > Skv || (causal && k0 + kBK - 1 > qc + q_offset);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int i = (e / 2) % 2;
        const float p = expf(__fmul_rn(s[e], scale) - ls[i]);
        float ds = p * (dp[e] - dl[i]);
        if (edge) {
          const int key = k0 + 8 * (e / 4) + col0 + (e % 2);
          const bool keep = key < Skv && (!causal || key <= row0 + 8 * i + q_offset);
          ds = keep ? ds : 0.f;
        }
        dp[e] = ds;
      }

      // dQ += dS . K in three terms
      split3<32>(dp, a, a + 16, a + 32);
      fence_regs<48>(a);
      fence_regs<D / 2>(acc);
      wgmma_fence();
      product3<kBK, D, kBK>(acc, a, tk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<D / 2>(acc);
      fence_regs<48>(a);
      mbar_arrive(empty + 8 * st);
    }

    // dq = scale * acc, rounded to bf16; rows at or past Sq are not stored
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      if (row >= Sq) continue;
      __nv_bfloat16* out = dq + ((int64_t(b) * Sq + row) * H + h) * D + col0;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2 * i] * scale, acc[4 * j + 2 * i + 1] * scale);
    }
  }
}

}  // namespace dq

// ---------------------------------------------------------------------------------------
// dK, dV of a KV head: its query heads' shares summed in head order
// ---------------------------------------------------------------------------------------

// out[r, :] = bf16(sum over j < rep of part[r * rep + j, :]) for the n rows r
// of out (B * Skv * Hkv rows of W), four columns a thread.
template <int W>
__global__ void __launch_bounds__(256)
flash_bwd_group_sum(const float* __restrict__ part, __nv_bfloat16* __restrict__ out, int64_t n,
                    int rep) {
  const int64_t e = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  if (e >= n * W) return;
  const int64_t r = e / W, col = e % W;
  float4 sum = __ldg(reinterpret_cast<const float4*>(part + r * rep * W + col));
  for (int j = 1; j < rep; ++j) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(part + (r * rep + j) * W + col));
    sum.x += x.x;
    sum.y += x.y;
    sum.z += x.z;
    sum.w += x.w;
  }
  __nv_bfloat162 pair[2] = {__floats2bfloat162_rn(sum.x, sum.y),
                            __floats2bfloat162_rn(sum.z, sum.w)};
  *reinterpret_cast<uint2*>(out + e) = *reinterpret_cast<const uint2*>(pair);
}

template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
}

// the launches of one call at head dims (D, DV); see flash_attention_bwd
template <int D, int DV>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, void* dq, void* dk, void* dv, float* dk_part, float* dv_part,
           float* delta, int64_t B, int64_t Sq, int64_t Skv, int64_t q_offset, int64_t H,
           int64_t Hkv, int64_t row_stride, const int64_t* st, int causal, cudaStream_t s) {
  constexpr int bq_dkdv = dkdv::query_rows(D, DV);
  const int64_t nq_dq = (Sq + dq::kBQ - 1) / dq::kBQ;
  const int64_t nk_dkdv = (Skv + dkdv::kBK - 1) / dkdv::kBK;
  if (B * H * nq_dq > 0x7fffffff || B * H * nk_dkdv > 0x7fffffff)
    return int(cudaErrorInvalidConfiguration);
  const float scale = float(1.0 / std::sqrt(double(D)));
  const int rep = int(H / Hkv);

  // TMA maps: q and dout by the dK, dV kernel's query steps and the dQ
  // kernel's 128-row tiles, k and v by 128-row (dK, dV) and 64-row (dQ) tiles
  const Operand oq{q, D, H, Sq, B, st[0], st[1], st[2]};
  const Operand ok{k, D, Hkv, Skv, B, st[3], st[4], st[5]};
  const Operand ov{v, DV, Hkv, Skv, B, st[6], st[7], st[8]};
  const Operand odo{dout, DV, H, Sq, B, st[12], st[13], st[14]};
  Maps q_step, q128, k128, k64, v128, v64, o_step, o128;
  Perm pq, pk, pv, po;
  if (!encode(oq, bq_dkdv, &q_step, &pq) || !encode(oq, dq::kBQ, &q128, &pq) ||
      !encode(ok, dkdv::kBK, &k128, &pk) || !encode(ok, dq::kBK, &k64, &pk) ||
      !encode(ov, dkdv::kBK, &v128, &pv) || !encode(ov, dq::kBK, &v64, &pv) ||
      !encode(odo, bq_dkdv, &o_step, &po) || !encode(odo, dq::kBQ, &o128, &po))
    return int(cudaErrorInvalidValue);   // no driver entry point, or a map TMA refuses

  const int64_t rows = B * H * row_stride;
  flash_bwd_delta<DV><<<unsigned((rows * 32 + 255) / 256), 256, 0, s>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout), delta, rows,
      row_stride, int(Sq), int(H), st[9], st[10], st[11], st[12], st[13], st[14]);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);

  constexpr size_t dkdv_smem = dkdv::smem_bytes<D, DV>();
  if ((err = opt_in(dkdv::flash_bwd_dkdv<D, DV>, dkdv_smem)) != cudaSuccess) return int(err);
  dkdv::flash_bwd_dkdv<D, DV><<<unsigned(B * H * nk_dkdv), kThreads, dkdv_smem, s>>>(
      q_step, k128, v128, o_step, pq, pk, pv, po, lse, delta, row_stride, dk_part, dv_part,
      int(Sq), int(Skv), int(q_offset), int(H), rep, int(B * H), scale, causal ? 1 : 0);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);

  constexpr size_t dq_smem = dq::smem_bytes<D, DV>();
  if ((err = opt_in(dq::flash_bwd_dq<D, DV>, dq_smem)) != cudaSuccess) return int(err);
  dq::flash_bwd_dq<D, DV><<<unsigned(B * H * nq_dq), kThreads, dq_smem, s>>>(
      q128, k64, v64, o128, pq, pk, pv, po, lse, delta, row_stride,
      static_cast<__nv_bfloat16*>(dq), int(Sq), int(Skv), int(q_offset), int(H), rep,
      int(nq_dq), int(B * H), scale, causal ? 1 : 0);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);

  const int64_t kv_rows = B * Skv * Hkv;
  flash_bwd_group_sum<D><<<unsigned((kv_rows * (D / 4) + 255) / 256), 256, 0, s>>>(
      dk_part, static_cast<__nv_bfloat16*>(dk), kv_rows, rep);
  flash_bwd_group_sum<DV><<<unsigned((kv_rows * (DV / 4) + 255) / 256), 256, 0, s>>>(
      dv_part, static_cast<__nv_bfloat16*>(dv), kv_rows, rep);
  return int(cudaGetLastError());
}

}  // namespace

// Gradients of attention for q (B,Sq,H,D), k (B,Skv,Hkv,D) and v
// (B,Skv,Hkv,DV), bf16, (D, DV) = (128, 128) or (192, 128), from the
// forward's out (B,Sq,H,DV) and lse (B,H,row_stride) fp32 and dout
// (B,Sq,H,DV), query row i at position q_offset + i.  Element strides (b, s,
// h) of q, k, v, out, dout in `st` (15; unit stride in the last dim, base
// addresses and strides 16-byte aligned).  Writes dq (B,Sq,H,D), dk
// (B,Skv,Hkv,D) and dv (B,Skv,Hkv,DV) bf16, contiguous; scratch: dk_part
// (B,Skv,H,D) and dv_part (B,Skv,H,DV) fp32, delta (B,H,row_stride) fp32.
// row_stride is Sq rounded up to a multiple of 64.  The caller checks
// shapes, H % Hkv == 0, B, Sq, Skv >= 1 and q_offset >= 0.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const float* lse, void* dq, void* dk,
                                   void* dv, float* dk_part, float* dv_part, float* delta,
                                   int64_t B, int64_t Sq, int64_t Skv, int64_t q_offset,
                                   int64_t H, int64_t Hkv, int64_t D, int64_t DV,
                                   int64_t row_stride, const int64_t* st, int causal,
                                   void* stream) {
  if ((D != 128 && D != 192) || DV != 128 || H % Hkv != 0 || Sq > 0x7fffffff ||
      Skv > 0x7fffffff || q_offset < 0 || Sq + q_offset > 0x7fffffff ||
      row_stride % kLsePad != 0 || row_stride < Sq)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return launch<128, 128>(q, k, v, o, dout, lse, dq, dk, dv, dk_part, dv_part, delta, B, Sq,
                            Skv, q_offset, H, Hkv, row_stride, st, causal, s);
  return launch<192, 128>(q, k, v, o, dout, lse, dq, dk, dv, dk_part, dv_part, delta, B, Sq, Skv,
                          q_offset, H, Hkv, row_stride, st, causal, s);
}
