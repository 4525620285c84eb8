// AdamW for Hopper (sm_90a): the global gradient norm's sum of squares in
// one pass over the gradients, and the update of the params and both
// moments in one more.
//
// Replaces no Pallas kernel: the JAX package takes the norm and updates in
// jnp (src/repro/optim/adamw.py: global_norm, adamw_update), and XLA fuses
// the update there.  PyTorch's eager loop does not fuse: about 18
// elementwise kernels a leaf, each writing a leaf-sized fp32 temporary, some
// 180 bytes of device memory a value.
//
// Bound: device memory, 32 bytes a value: the norm reads g (4 B); the update
// reads g, p, m and v and writes p, m and v (28 B).  Nothing else touches
// device memory but the norm's partial sums, one double a block.
//
// Design:
// * One launch takes a table of up to kMaxLeaves leaves, passed by value in
//   the kernel's parameters (__grid_constant__: indexed in place, not
//   copied), so that no table is copied from the host each step.  A tree
//   with more leaves takes more launches.  One multi-leaf launch, not one a
//   leaf: a model's norms and biases are small leaves that would each take
//   a launch of a few blocks, and the large ones leave a partial last wave
//   apiece.
// * Each leaf is cut into tiles of kTile values; a block walks the tiles of
//   every leaf in turn (grid-stride), so the leaf is uniform in a block and
//   every warp reads 512 consecutive bytes of each operand a load.  A
//   thread issues kUnroll 16-byte loads of each operand before it computes,
//   so 4 x kUnroll x 16 bytes a thread are in flight; the grid is the
//   blocks the card holds at once.  Measured on an H100 (1.9 B values):
//   the update at 2.84 TB/s with kUnroll = 4 (117 registers), 2.77 with 2,
//   2.72 with 1, where a device-to-device copy moves 2.93; 512 threads a
//   block and evict-first cache hints changed nothing beyond that.
// * A leaf whose operands are not all 16-byte aligned, and the ragged end
//   of any leaf, take the same values one float at a time.
// * The update rounds where the plain loop (kernels/adamw.py:
//   adamw_step_plain) rounds, one fp32 operation at a time: round to
//   nearest by the intrinsics, never contracted into an FMA.  Given the
//   same norm it equals the loop bit for bit.  The scalars that depend on
//   the step (clip factor, bias corrections, learning rate) are 0-d device
//   tensors the caller computes once for both routes; the kernel reads them
//   on the card, so the step never waits on the host.
// * The norm's sum of squares: each thread sums the squares of a 16-byte
//   vector in fp32 and adds that to a double; each block writes its double
//   to its own slot (kNormBlocks a launch, a fixed grid), and one block
//   adds the slots in a fixed order into a 0-d double, whose root the
//   caller takes (a sharded step first adds the ranks' sums).  No atomics:
//   the same gradients give the same bits.

#include <cstdint>

#include <cuda_runtime.h>

#include "bytes.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int64_t kTile = int64_t(kThreads) * kUnroll * 4;
constexpr int kMaxLeaves = 64;
constexpr int kNormBlocks = 1024;

struct Leaves {
  float* p[kMaxLeaves];
  const float* g[kMaxLeaves];
  float* m[kMaxLeaves];
  float* v[kMaxLeaves];
  int64_t n[kMaxLeaves];     // values of the leaf
  int64_t end[kMaxLeaves];   // tiles of the leaf and every leaf before it
  uint64_t decay;            // bit i: leaf i takes weight decay (ndim >= 2)
  uint64_t wide;             // bit i: every operand of leaf i is 16-byte aligned
  int count;
};

struct Consts {
  float b1, one_minus_b1, b2, one_minus_b2, eps, weight_decay;
};

struct StepScalars {
  float clip, bc1, bc2, lr;
};

__device__ __forceinline__ float4 load4(const float* p, int64_t left, bool wide) {
  if (wide && left >= 4) return *reinterpret_cast<const float4*>(p);
  float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
  if (left > 0) x.x = p[0];
  if (left > 1) x.y = p[1];
  if (left > 2) x.z = p[2];
  if (left > 3) x.w = p[3];
  return x;
}

__device__ __forceinline__ void store4(float* p, float4 x, int64_t left, bool wide) {
  if (wide && left >= 4) {
    *reinterpret_cast<float4*>(p) = x;
    return;
  }
  if (left > 0) p[0] = x.x;
  if (left > 1) p[1] = x.y;
  if (left > 2) p[2] = x.z;
  if (left > 3) p[3] = x.w;
}

// One value, in the plain loop's order of operations and roundings.
__device__ __forceinline__ void adamw_value(float& p, float g, float& m, float& v, const Consts& k,
                                            const StepScalars& s, bool decay) {
  g = __fmul_rn(g, s.clip);
  m = __fadd_rn(__fmul_rn(m, k.b1), __fmul_rn(g, k.one_minus_b1));
  v = __fadd_rn(__fmul_rn(v, k.b2), __fmul_rn(__fmul_rn(g, k.one_minus_b2), g));
  float dir = __fdiv_rn(__fdiv_rn(m, s.bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.bc2)), k.eps));
  if (decay) dir = __fadd_rn(dir, __fmul_rn(k.weight_decay, p));
  p = __fsub_rn(p, __fmul_rn(s.lr, dir));
}

__device__ __forceinline__ void adamw_vec(float4& p, float4 g, float4& m, float4& v,
                                          const Consts& k, const StepScalars& s, bool decay) {
  adamw_value(p.x, g.x, m.x, v.x, k, s, decay);
  adamw_value(p.y, g.y, m.y, v.y, k, s, decay);
  adamw_value(p.z, g.z, m.z, v.z, k, s, decay);
  adamw_value(p.w, g.w, m.w, v.w, k, s, decay);
}

// A block's place in the walk: the leaf of its tile, the tile's first value
// in that leaf, and this thread's j-th vector there.
struct TileSpot {
  int leaf;
  int64_t base;       // first value of the tile in its leaf

  __device__ __forceinline__ void seek(const Leaves& t, int64_t tile) {
    while (tile >= t.end[leaf]) ++leaf;
    base = (tile - (leaf ? t.end[leaf - 1] : 0)) * kTile;
  }
  __device__ __forceinline__ int64_t at(int j) const {
    return base + (int64_t(j) * kThreads + threadIdx.x) * 4;
  }
};

__global__ void __launch_bounds__(kThreads)
adamw_update_kernel(const __grid_constant__ Leaves t, const Consts k, const float* clip,
                    const float* bc1, const float* bc2, const float* lr) {
  const StepScalars s{*clip, *bc1, *bc2, *lr};
  const int64_t total = t.end[t.count - 1];
  TileSpot spot{0, 0};
  for (int64_t tile = blockIdx.x; tile < total; tile += gridDim.x) {
    spot.seek(t, tile);
    const int i = spot.leaf;
    const int64_t n = t.n[i];
    const bool wide = (t.wide >> i) & 1, decay = (t.decay >> i) & 1;
    float4 p[kUnroll], g[kUnroll], m[kUnroll], v[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int64_t at = spot.at(j), left = n - at;
      g[j] = load4(t.g[i] + at, left, wide);
      p[j] = load4(t.p[i] + at, left, wide);
      m[j] = load4(t.m[i] + at, left, wide);
      v[j] = load4(t.v[i] + at, left, wide);
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int64_t at = spot.at(j), left = n - at;
      if (left <= 0) continue;
      adamw_vec(p[j], g[j], m[j], v[j], k, s, decay);
      store4(t.p[i] + at, p[j], left, wide);
      store4(t.m[i] + at, m[j], left, wide);
      store4(t.v[i] + at, v[j], left, wide);
    }
  }
}

__device__ __forceinline__ double block_sum(double x) {
  __shared__ double warps[kThreads / 32];
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x += __shfl_down_sync(0xffffffffu, x, d);
  if ((threadIdx.x & 31) == 0) warps[threadIdx.x >> 5] = x;
  __syncthreads();
  double total = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kThreads / 32; ++w) total += warps[w];
  return total;    // thread 0's is the block's sum
}

__device__ __forceinline__ float squares(float4 x) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x.x, x.x), __fmul_rn(x.y, x.y)),
                   __fadd_rn(__fmul_rn(x.z, x.z), __fmul_rn(x.w, x.w)));
}

// partials[b] = the sum of squares of the tiles block b walks (every block
// writes its slot, 0.0 where it walked none).
__global__ void __launch_bounds__(kThreads)
adamw_norm_kernel(const __grid_constant__ Leaves t, double* partials) {
  const int64_t total = t.end[t.count - 1];
  TileSpot spot{0, 0};
  double acc = 0.0;
  for (int64_t tile = blockIdx.x; tile < total; tile += gridDim.x) {
    spot.seek(t, tile);
    const int i = spot.leaf;
    const int64_t n = t.n[i];
    const bool wide = (t.wide >> i) & 1;
    float4 g[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int64_t at = spot.at(j);
      g[j] = load4(t.g[i] + at, n - at, wide);
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) acc += double(squares(g[j]));
  }
  const double sum = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = sum;
}

// out[0] = the sum of partials[0 .. count), in a fixed order; one block.
__global__ void __launch_bounds__(kThreads)
adamw_norm_final_kernel(const double* partials, int64_t count, double* out) {
  double acc = 0.0;
  for (int64_t i = threadIdx.x; i < count; i += kThreads) acc += partials[i];
  const double sum = block_sum(acc);
  if (threadIdx.x == 0) out[0] = sum;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// The table of leaves [first, first + count) of the caller's arrays.
Leaves table(float* const* p, const float* const* g, float* const* m, float* const* v,
             const int64_t* n, const uint8_t* decay, int64_t first, int count) {
  Leaves t{};
  int64_t tiles = 0;
  for (int i = 0; i < count; ++i) {
    const int64_t at = first + i;
    t.p[i] = p ? p[at] : nullptr;
    t.g[i] = g[at];
    t.m[i] = m ? m[at] : nullptr;
    t.v[i] = v ? v[at] : nullptr;
    t.n[i] = n[at];
    tiles += (n[at] + kTile - 1) / kTile;
    t.end[i] = tiles;
    if (decay && decay[at]) t.decay |= uint64_t(1) << i;
    const bool wide = aligned16(g[at]) && (!p || (aligned16(p[at]) && aligned16(m[at]) &&
                                                  aligned16(v[at])));
    if (wide) t.wide |= uint64_t(1) << i;
  }
  t.count = count;
  return t;
}

int launches_for(int64_t count) { return int((count + kMaxLeaves - 1) / kMaxLeaves); }

}  // namespace

// The doubles of scratch that adamw_sum_of_squares needs for `count` leaves.
extern "C" int adamw_norm_partials(int64_t count) {
  return launches_for(count) * kNormBlocks;
}

// out (a 0-d fp64 tensor) = the sum of the squares of `count` fp32 leaves
// g[i] of n[i] values (0.0 for none).  `partials`:
// adamw_norm_partials(count) doubles of scratch.
extern "C" int adamw_sum_of_squares(const void* const* g, const int64_t* n, int64_t count,
                                    void* partials, void* out, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  auto* slots = static_cast<double*>(partials);
  const auto* gs = reinterpret_cast<const float* const*>(g);
  const int launches = launches_for(count);
  for (int l = 0; l < launches; ++l) {
    const int64_t first = int64_t(l) * kMaxLeaves;
    const int in_this = int(count - first < kMaxLeaves ? count - first : kMaxLeaves);
    const Leaves t = table(nullptr, gs, nullptr, nullptr, n, nullptr, first, in_this);
    adamw_norm_kernel<<<kNormBlocks, kThreads, 0, st>>>(t, slots + int64_t(l) * kNormBlocks);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
  }
  adamw_norm_final_kernel<<<1, kThreads, 0, st>>>(slots, int64_t(launches) * kNormBlocks,
                                                  static_cast<double*>(out));
  return int(cudaGetLastError());
}

// In place, for each of `count` fp32 leaves of n[i] values: the AdamW
// update of p[i], m[i] and v[i] from g[i], with weight decay where
// decay[i].  clip, bc1, bc2 and lr: 0-d fp32 device tensors.
extern "C" int adamw_update(void* const* p, const void* const* g, void* const* m,
                            void* const* v, const int64_t* n, const uint8_t* decay,
                            int64_t count, const void* clip, const void* bc1, const void* bc2,
                            const void* lr, float b1, float one_minus_b1, float b2,
                            float one_minus_b2, float eps, float weight_decay, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const Consts k{b1, one_minus_b1, b2, one_minus_b2, eps, weight_decay};
  for (int64_t first = 0; first < count; first += kMaxLeaves) {
    const int in_this = int(count - first < kMaxLeaves ? count - first : kMaxLeaves);
    const Leaves t = table(reinterpret_cast<float* const*>(p),
                           reinterpret_cast<const float* const*>(g),
                           reinterpret_cast<float* const*>(m), reinterpret_cast<float* const*>(v),
                           n, decay, first, in_this);
    const int64_t tiles = t.end[in_this - 1];
    if (tiles == 0) continue;
    const int grid = resident_grid(adamw_update_kernel, tiles * kThreads, kThreads, 0);
    adamw_update_kernel<<<grid, kThreads, 0, st>>>(
        t, k, static_cast<const float*>(clip), static_cast<const float*>(bc1),
        static_cast<const float*>(bc2), static_cast<const float*>(lr));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
  }
  return 0;
}
