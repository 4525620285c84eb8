// Online-softmax attention forward (flash attention) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:
//   flash_attention_fwd  <- flash_attention_fwd (_flash_kernel)
//
// Computes, for q (B,S,H,D), k (B,S,Hkv,D), v (B,S,Hkv,Dv), bf16 or fp32:
//   out[b,i,h,:] = softmax_j(scale * q[b,i,h,:] . k[b,j,h/rep,:]) . v[b,j,h/rep,:]
// with rep = H / Hkv (grouped-query heads, KV never repeated in memory), an
// optional causal mask (j <= i), fp32 accumulation, q upcast to fp32 before
// the scaling, and p rounded to v's dtype before P.V, all as the TPU kernel
// does.  The output has q's dtype and is (B,S,H,Dv), contiguous.
//
// Bound on this card: operations.  A causal pass does B*H*S*(S+1)/2 * 2*(D+Dv)
// flops over (B*S*(H*D + Hkv*(D+Dv)) + B*S*H*Dv) * sizeof(T) bytes, between
// S/4 (H = Hkv) and S/2 (large rep) flops per byte in bf16: above the H100's
// ridge point (~295 flops/byte in bf16) at every sequence length the models
// run.
//
// Design (a simple kernel that is right first; tensor cores come later):
//  * One block of 256 threads per (b, h, 64-row q tile), on a 1-D grid
//    (no index on gridDim.y/z, which cap at 65535), the heaviest causal
//    tiles first.  A loop over 64-row KV tiles inside the block takes the
//    place of the TPU's sequential kv grid axis, so (m, l, acc) live in
//    registers for the block's whole life; with a causal mask the loop
//    stops at the diagonal tile (the TPU kernel's fully masked tiles add
//    exactly 0).
//  * The q, k, v tensors are read in their (B,S,H,D) layout through
//    strides (64-bit offsets), with no transpose and no padding pass: rows
//    at or past S load as zeros, masked keys score -1e30, and q rows at or
//    past S are not stored.
//  * Tiles are staged in shared memory as fp32 (q pre-scaled); the K and V
//    tiles share one buffer.  Each thread owns a 4x4 patch of the 64x64
//    score tile (rows 4*ty+i, key columns tx+16*j) and the same 4 rows of
//    the output (columns tx+16*j): fp32 FMAs over float4 shared reads,
//    row max and row sum over the 16 lanes of a half-warp by shuffles.
//  * The largest set (D=192, Dv=128) takes 115 KiB of shared memory, above
//    the 48 KiB default, so every launch opts in first and the host
//    function returns cudaGetLastError() of the launch.

#include <cmath>
#include <cuda_bf16.h>

#include "bytes.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // key rows per KV tile
constexpr int kPad = 4;          // floats of padding per shared row (float4-aligned)
constexpr float kNegInf = -1e30f;

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float lane(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// dst[r * ld + c] = scale * src[(s0 + r) * row_stride + c] in fp32 for the 64
// rows r of a tile and the `width` columns c; rows at or past S are zero.
template <typename T>
__device__ void load_tile(float* dst, int ld, const T* __restrict__ src, int64_t row_stride,
                          int s0, int S, int width, float scale) {
  const int total = kBK * width;
  for (int e = threadIdx.x; e < total; e += kThreads) {
    const int r = e / width;
    const int c = e - r * width;
    float x = 0.f;
    if (s0 + r < S) x = to_f32<T>(src[int64_t(s0 + r) * row_stride + c]) * scale;
    dst[r * ld + c] = x;
  }
}

template <typename T, int DV>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int S, int H, int Hkv, int D, int nq,
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
  float* sP = sKV + kBK * ldkv;           // kBQ x ldp, p in v's precision

  const int64_t bid = blockIdx.x;
  const int qt = nq - 1 - int(bid % nq);  // heaviest causal tiles first
  const int64_t bh = bid / nq;
  const int h = int(bh % H);
  const int64_t b = bh / H;
  const int hk = h / (H / Hkv);
  const int q0 = qt * kBQ;

  const int tx = threadIdx.x & 15;        // key / output columns tx + 16*j
  const int ty = threadIdx.x >> 4;        // query rows 4*ty + i

  const T* qh = q + b * q_sb + int64_t(h) * q_sh;
  const T* kh = k + b * k_sb + int64_t(hk) * k_sh;
  const T* vh = v + b * v_sb + int64_t(hk) * v_sh;
  load_tile<T>(sQ, ldq, qh, q_ss, q0, S, D, scale);

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  const int nk = (S + kBK - 1) / kBK;
  const int last = causal ? min(nk - 1, (q0 + kBQ - 1) / kBK) : nk - 1;
  for (int kt = 0; kt <= last; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                      // the last tile's P.V is done with sKV, sP
    load_tile<T>(sKV, ldkv, kh, k_ss, k0, S, D, 1.f);
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

    // keys at or past S, and with a causal mask keys after the query, score -1e30
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        if (kp >= S || (causal && kp > q0 + 4 * ty + i)) s[i][j] = kNegInf;
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
        sP[(4 * ty + i) * ldp + tx + 16 * j] = to_f32<T>(from_f32<T>(p));
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
    load_tile<T>(sKV, ldkv, vh, v_ss, k0, S, DV, 1.f);
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
    if (qp >= S) continue;
    const float ll = fmaxf(l[i], 1e-30f);
    T* orow = o + (b * S + qp) * o_ss + int64_t(h) * DV;
#pragma unroll
    for (int j = 0; j < NJ; ++j) orow[tx + 16 * j] = from_f32<T>(acc[i][j] / ll);
  }
}

template <typename T, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int64_t B, int64_t S,
                   int64_t H, int64_t Hkv, int64_t D, const int64_t* strides, bool causal,
                   cudaStream_t stream) {
  const int64_t nq = (S + kBQ - 1) / kBQ;
  const int64_t blocks = B * H * nq;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  const int64_t ldq = D + kPad, ldkv = (D > DV ? D : DV) + kPad, ldp = kBK + kPad;
  const size_t smem = size_t(kBQ * ldq + kBK * ldkv + kBQ * ldp) * sizeof(float);
  auto kernel = flash_fwd_kernel<T, DV>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const float scale = float(1.0 / std::sqrt(double(D)));
  kernel<<<unsigned(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), int(S), int(H), int(Hkv), int(D), int(nq),
      strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
      strides[6], strides[7], strides[8], scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dv(const void* q, const void* k, const void* v, void* o, int64_t B,
                        int64_t S, int64_t H, int64_t Hkv, int64_t D, int64_t DV,
                        const int64_t* strides, bool causal, cudaStream_t stream) {
  switch (DV) {
    case 64: return launch<T, 64>(q, k, v, o, B, S, H, Hkv, D, strides, causal, stream);
    case 80: return launch<T, 80>(q, k, v, o, B, S, H, Hkv, D, strides, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, S, H, Hkv, D, strides, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B,S,H,D), k (B,S,Hkv,D), v (B,S,Hkv,Dv) with element strides
// {q,k,v}_s{b,s,h} and unit stride in the last dim -> o (B,S,H,Dv),
// contiguous.  dtype: 0 = fp32, 1 = bf16 (all four tensors).  The caller
// checks shapes, H % Hkv == 0, D in {64, 80, 128, 192}, Dv in {64, 80, 128}
// and B, S >= 1.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int dtype, int64_t B, int64_t S, int64_t H, int64_t Hkv,
                                   int64_t D, int64_t DV, int64_t q_sb, int64_t q_ss,
                                   int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
                                   int64_t v_sb, int64_t v_ss, int64_t v_sh, int causal,
                                   void* stream) {
  if (D % 16 != 0 || D < 16 || D > 192 || S > 0x7fffffff || H % Hkv != 0)
    return int(cudaErrorInvalidValue);
  const int64_t strides[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return int(dispatch_dv<float>(q, k, v, o, B, S, H, Hkv, D, DV, strides, causal != 0, st));
  if (dtype == 1)
    return int(dispatch_dv<__nv_bfloat16>(q, k, v, o, B, S, H, Hkv, D, DV, strides,
                                          causal != 0, st));
  return int(cudaErrorInvalidValue);
}
