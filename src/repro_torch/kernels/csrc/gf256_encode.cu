// GF(2^8) matmul by constants on byte rows: RS encode, RS decode and the
// streaming-TriEC data-node scaling stage, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels in src/repro/kernels/gf256_encode.py:
//   gf_matmul_bytes_batched  <- gf_matmul_bitsliced_batched (and, launched
//                               with S = 1, gf_matmul_bitsliced)
//   gf_scale_bytes           <- gf_scale_bitsliced
//
// Bound: device memory.  The matmul reads S*k*L bytes and writes S*n*L; the
// scaling stage reads k*L and writes m*k*L.  There is no arithmetic unit
// that these byte products could saturate first.
//
// Design: per-coefficient product tables in shared memory, not bit-slicing.
// The TPU kernel works on bit-planes because a TPU has no byte gather; the
// reference packs and unpacks them around the kernel, three extra passes
// over memory.  Here each block builds tab[(t*k + j)*256 + x] = c[t][j] * x
// for the output rows t it owns, so a byte product is one shared-memory
// lookup, and the kernel reads bytes and writes bytes in a single pass.
// The bytes equal the bit-sliced result: both compute the same products in
// the field of the primitive polynomial 0x11d.  A block owns at most
// kMaxRows output rows, fewer when k is large, so the tables fit in shared
// memory for any k + m <= 256; a wider code re-reads its input once per
// row tile (grid.y).  Offsets are 64-bit, the stripe index lives in the
// grid-stride loop (never in gridDim.y/z), and the ragged row tail goes
// through the byte path of bytes.cuh.

#include "bytes.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 8;
constexpr int kBlocksPerSm = 8;
constexpr int kSmemDefault = 48 * 1024;

// Russian-peasant multiply in GF(2^8) mod x^8 + x^4 + x^3 + x^2 + 1.
__device__ __forceinline__ uint32_t gf_mul(uint32_t a, uint32_t b) {
  uint32_t r = 0;
  for (int i = 0; i < 8; ++i) {
    if (b & 1u) r ^= a;
    b >>= 1;
    a <<= 1;
    if (a & 0x100u) a ^= 0x11du;
  }
  return r;
}

// tab[e] = coeffs[e / 256] * (e % 256) for the rows*k coefficients that
// start at `coeffs` (row-major, so e / 256 == t*k + j).
__device__ void build_tables(uint8_t* tab, const uint8_t* __restrict__ coeffs, int rows, int k) {
  const int total = rows * k * 256;
  for (int e = threadIdx.x; e < total; e += blockDim.x)
    tab[e] = uint8_t(gf_mul(coeffs[e >> 8], uint32_t(e & 255)));
}

// The shared body: four byte products through one coefficient's table.
__device__ __forceinline__ uint32_t mul4(const uint8_t* t, uint32_t x) {
  return uint32_t(t[x & 255u]) | (uint32_t(t[(x >> 8) & 255u]) << 8) |
         (uint32_t(t[(x >> 16) & 255u]) << 16) | (uint32_t(t[x >> 24]) << 24);
}

// out[s, i, :] = XOR_j c[i, j] * data[s, j, :]
__global__ void __launch_bounds__(kThreads)
gf_matmul_kernel(const uint8_t* __restrict__ coeffs, const uint8_t* __restrict__ data,
                 uint8_t* __restrict__ out, int64_t S, int n, int k, int64_t L,
                 int rows_per_block, bool vec) {
  extern __shared__ uint8_t tab[];
  const int row0 = blockIdx.y * rows_per_block;
  const int rows = min(rows_per_block, n - row0);
  build_tables(tab, coeffs + int64_t(row0) * k, rows, k);
  __syncthreads();
  const int64_t words = (L + 3) >> 2;
  const int64_t items = S * words;
  for (int64_t it = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; it < items;
       it += int64_t(gridDim.x) * blockDim.x) {
    const int64_t s = it / words;
    const int64_t p = (it - s * words) << 2;
    const int nb = L - p < 4 ? int(L - p) : 4;
    const uint8_t* src = data + s * k * L + p;
    uint32_t acc[kMaxRows];
#pragma unroll
    for (int t = 0; t < kMaxRows; ++t) acc[t] = 0;
    for (int j = 0; j < k; ++j) {
      const uint32_t x = load4(src + int64_t(j) * L, nb, vec);
#pragma unroll
      for (int t = 0; t < kMaxRows; ++t)
        if (t < rows) acc[t] ^= mul4(tab + (t * k + j) * 256, x);
    }
    uint8_t* dst = out + (s * n + row0) * L + p;
#pragma unroll
    for (int t = 0; t < kMaxRows; ++t)
      if (t < rows) store4(dst + int64_t(t) * L, acc[t], nb, vec);
  }
}

// out[i, j, :] = c[i, j] * data[j, :]  (no fold over j)
__global__ void __launch_bounds__(kThreads)
gf_scale_kernel(const uint8_t* __restrict__ coeffs, const uint8_t* __restrict__ data,
                uint8_t* __restrict__ out, int m, int k, int64_t L, int rows_per_block,
                bool vec) {
  extern __shared__ uint8_t tab[];
  const int row0 = blockIdx.y * rows_per_block;
  const int rows = min(rows_per_block, m - row0);
  build_tables(tab, coeffs + int64_t(row0) * k, rows, k);
  __syncthreads();
  const int64_t words = (L + 3) >> 2;
  const int64_t items = int64_t(k) * words;
  for (int64_t it = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; it < items;
       it += int64_t(gridDim.x) * blockDim.x) {
    const int64_t j = it / words;
    const int64_t p = (it - j * words) << 2;
    const int nb = L - p < 4 ? int(L - p) : 4;
    const uint32_t x = load4(data + j * L + p, nb, vec);
#pragma unroll
    for (int t = 0; t < kMaxRows; ++t)
      if (t < rows)
        store4(out + ((int64_t(row0) + t) * k + j) * L + p,
               mul4(tab + (t * k + int(j)) * 256, x), nb, vec);
  }
}

// Output rows per block: all of them up to kMaxRows while their tables fit
// the default 48 KiB; at least one (k * 256 <= 64 KiB, opted in below).
int rows_per_block(int64_t n, int64_t k) {
  int64_t r = kSmemDefault / (k * 256);
  if (r < 1) r = 1;
  if (r > kMaxRows) r = kMaxRows;
  return int(r < n ? r : n);
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem <= size_t(kSmemDefault)) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
}

}  // namespace

// (n, k) coefficients x (S, k, L) bytes -> (S, n, L) bytes.  Contiguous
// rows; the caller checks S, n, L >= 1 and 1 <= k <= 256.
extern "C" int gf_matmul_bytes_batched(const void* coeffs, const void* data, void* out,
                                       int64_t S, int64_t n, int64_t k, int64_t L,
                                       void* stream) {
  const int rpb = rows_per_block(n, k);
  const size_t smem = size_t(rpb) * k * 256;
  cudaError_t err = prepare(gf_matmul_kernel, smem);
  if (err != cudaSuccess) return int(err);
  const bool vec = (L % 4 == 0) && aligned4(data) && aligned4(out);
  const dim3 grid(grid_blocks(S * ((L + 3) / 4), kThreads, kBlocksPerSm),
                  unsigned((n + rpb - 1) / rpb));
  gf_matmul_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(coeffs), static_cast<const uint8_t*>(data),
      static_cast<uint8_t*>(out), S, int(n), int(k), L, rpb, vec);
  return int(cudaGetLastError());
}

// (m, k) coefficients x (k, L) bytes -> (m, k, L) bytes.  Contiguous rows;
// the caller checks m, L >= 1 and 1 <= k <= 256.
extern "C" int gf_scale_bytes(const void* coeffs, const void* data, void* out, int64_t m,
                              int64_t k, int64_t L, void* stream) {
  const int rpb = rows_per_block(m, k);
  const size_t smem = size_t(rpb) * k * 256;
  cudaError_t err = prepare(gf_scale_kernel, smem);
  if (err != cudaSuccess) return int(err);
  const bool vec = (L % 4 == 0) && aligned4(data) && aligned4(out);
  const dim3 grid(grid_blocks(k * ((L + 3) / 4), kThreads, kBlocksPerSm),
                  unsigned((m + rpb - 1) / rpb));
  gf_scale_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(coeffs), static_cast<const uint8_t*>(data),
      static_cast<uint8_t*>(out), int(m), int(k), L, rpb, vec);
  return int(cudaGetLastError());
}
