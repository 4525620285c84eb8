// GF(2) matmul as an integer dot product: the "MXU" RS encode, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/gf256_encode.py:
//   gf_matmul_mxu  <- gf_matmul_mxu (_gf_mxu_kernel)
//
// Computes out = (bigmat @ bits) & 1 for an (8m, 8k) int8 bit-matrix and
// (8k, n) int8 bit columns, int32 accumulation, (8m, n) int8 out.  Row j*8+b
// of `bits` is bit b of data chunk j, column t is byte t of the stripe.
//
// Bound on this card: device memory.  It reads 8k*n + 8m*8k bytes and
// writes 8m*n; at RS(6,3) that is 72 bytes per column against 2*24*48 int8
// operations, 32 per byte, far below the ridge point (~590 int8 ops per
// byte at 1,979 TOP/s over 3.35 TB/s).
//
// Design: the scalar __dp4a form, not an mma.sync tile.  The work is so
// far below the ridge that the tensor cores would only wait on memory, and
// dp4a needs no fragment layouts.  Each block holds up to kMaxRows rows of
// the bit-matrix in shared memory as packed 4-byte words (one word = 4
// consecutive input bits of an output row).  A thread owns 4 consecutive
// columns: for every 4 input rows it reads one 32-bit word from each
// (neighbouring threads, neighbouring bytes), transposes the 4x4 bytes with
// __byte_perm into one word per column, and adds __dp4a(row word, column
// word) into an int32 accumulator per (output row, column).  It writes
// acc & 1 as int8, 4 columns as one word.  A ragged n goes through the byte
// path of bytes.cuh (no padding); a bit-matrix with more than kMaxRows rows
// tiles them over grid.y, re-reading `bits` once per tile.  Offsets are
// 64-bit and the column index lives in a grid-stride loop.

#include "bytes.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 24;     // RS(6,3)'s 8m = 24 output rows in one pass
constexpr int kBlocksPerSm = 4;

__global__ void __launch_bounds__(kThreads)
gf_mxu_kernel(const int8_t* __restrict__ bigmat, const int8_t* __restrict__ bits,
              int8_t* __restrict__ out, int em, int ek, int64_t n, int rows_per_block,
              bool vec) {
  extern __shared__ int32_t mat[];       // rows x (ek / 4) packed row words
  const int row0 = blockIdx.y * rows_per_block;
  const int rows = min(rows_per_block, em - row0);
  const int kw = ek >> 2;
  for (int e = threadIdx.x; e < rows * kw; e += blockDim.x) {
    const uint8_t* src = reinterpret_cast<const uint8_t*>(bigmat) +
                         int64_t(row0 + e / kw) * ek + (e % kw) * 4;
    mat[e] = int32_t(uint32_t(src[0]) | (uint32_t(src[1]) << 8) | (uint32_t(src[2]) << 16) |
                     (uint32_t(src[3]) << 24));
  }
  __syncthreads();

  const uint8_t* in = reinterpret_cast<const uint8_t*>(bits);
  const int64_t words = (n + 3) >> 2;
  for (int64_t w = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; w < words;
       w += int64_t(gridDim.x) * blockDim.x) {
    const int64_t p = w << 2;
    const int nb = n - p < 4 ? int(n - p) : 4;
    int32_t acc[kMaxRows][4];
#pragma unroll
    for (int t = 0; t < kMaxRows; ++t)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[t][c] = 0;
    for (int r = 0; r < ek; r += 4) {
      const uint32_t x0 = load4(in + int64_t(r) * n + p, nb, vec);
      const uint32_t x1 = load4(in + int64_t(r + 1) * n + p, nb, vec);
      const uint32_t x2 = load4(in + int64_t(r + 2) * n + p, nb, vec);
      const uint32_t x3 = load4(in + int64_t(r + 3) * n + p, nb, vec);
      // column c's word: byte i = bits[r + i][p + c]
      const uint32_t lo01 = __byte_perm(x0, x1, 0x5140), hi01 = __byte_perm(x0, x1, 0x7362);
      const uint32_t lo23 = __byte_perm(x2, x3, 0x5140), hi23 = __byte_perm(x2, x3, 0x7362);
      const int32_t col[4] = {int32_t(__byte_perm(lo01, lo23, 0x5410)),
                              int32_t(__byte_perm(lo01, lo23, 0x7632)),
                              int32_t(__byte_perm(hi01, hi23, 0x5410)),
                              int32_t(__byte_perm(hi01, hi23, 0x7632))};
#pragma unroll
      for (int t = 0; t < kMaxRows; ++t) {
        if (t < rows) {
          const int32_t a = mat[t * kw + (r >> 2)];
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[t][c] = __dp4a(a, col[c], acc[t][c]);
        }
      }
    }
    uint8_t* dst = reinterpret_cast<uint8_t*>(out) + int64_t(row0) * n + p;
#pragma unroll
    for (int t = 0; t < kMaxRows; ++t) {
      if (t < rows) {
        const uint32_t word = uint32_t(acc[t][0] & 1) | (uint32_t(acc[t][1] & 1) << 8) |
                              (uint32_t(acc[t][2] & 1) << 16) | (uint32_t(acc[t][3] & 1) << 24);
        store4(dst + int64_t(t) * n, word, nb, vec);
      }
    }
  }
}

}  // namespace

// (em, ek) int8 x (ek, n) int8 -> (em, n) int8, (bigmat @ bits) & 1.
// Contiguous rows; the caller checks em, n >= 1 and ek % 4 == 0 with
// 4 <= ek <= 2048.
extern "C" int gf_matmul_mxu(const void* bigmat, const void* bits, void* out, int64_t em,
                             int64_t ek, int64_t n, void* stream) {
  if (ek % 4 != 0 || ek < 4 || ek > 2048) return int(cudaErrorInvalidValue);
  const int rpb = int(em < kMaxRows ? em : kMaxRows);
  const size_t smem = size_t(rpb) * ek;   // <= 24 * 2048 = 48 KiB, the default
  const bool vec = (n % 4 == 0) && aligned4(bits) && aligned4(out);
  const dim3 grid(grid_blocks((n + 3) / 4, kThreads, kBlocksPerSm),
                  unsigned((em + rpb - 1) / rpb));
  gf_mxu_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(bigmat), static_cast<const int8_t*>(bits),
      static_cast<int8_t*>(out), int(em), int(ek), n, rpb, vec);
  return int(cudaGetLastError());
}
