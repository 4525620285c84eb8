// GF(2) matmul of bit rows: the "MXU" RS encode, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/gf256_encode.py:
//   gf_matmul_mxu  <- gf_matmul_mxu (_gf_mxu_kernel)
//
// Computes out = (bigmat @ bits) & 1 for an (8m, 8k) int8 bit-matrix and
// (8k, n) int8 bit columns, (8m, n) int8 out.  Row j*8+b of `bits` is bit b
// of data chunk j, column t is byte t of the stripe.  Only the low bit of
// each operand reaches the result: the parity of an integer dot is the
// XOR of the products of the operands' low bits.
//
// Bound on this card: device memory.  It reads 8k*n + 8m*8k bytes and
// writes 8m*n; at RS(6,3) that is 72 bytes per column against 2*24*48 int8
// operations, 32 per byte, far below the ridge point (~590 int8 ops per
// byte at 1,979 TOP/s over 3.35 TB/s), so the tensor cores would only wait
// on memory.
//
// Design: bit-packed parity.  The host packs the low bits of
// bigmat[t, 8j:8j+8] into one mask byte M[t][j] (row_masks in
// gf256_encode.py); a block replicates them into words in shared memory,
// [j][t], read by broadcast.  A thread owns 4 consecutive columns.  For each
// group j of 8 input rows it packs their low bits into one byte per column,
// P = OR_r (x_r & 0x01010101) << r (the data byte of GF(2^8) again), and
// every output row accumulates A_t ^= P & M[t][j] (one lop3 per row and
// group).  The parity of each byte of A_t is the result: three shift-XORs
// and an AND, then one 32-bit store of 4 columns.  A thread so keeps one
// accumulator word per output row (24 at RS(6,3)), where the __dp4a form
// before it kept 4 int32 sums per row and 150 registers a thread, one
// block per SM.  Loads stay 32-bit: 16 columns a thread would need 4x the
// accumulators, and a warp's 32 neighbouring 4-byte loads already cover
// whole 128-byte lines; the 8 loads of a group are independent, and as
// many blocks as the registers allow keep them in flight.  A ragged n goes
// through the byte path of bytes.cuh (no padding); a bit-matrix with more
// than kMaxRows rows tiles them over grid.y, re-reading `bits` once per
// tile.  Offsets are 64-bit and the column index lives in a grid-stride
// loop.

#include "bytes.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 24;     // RS(6,3)'s 8m = 24 output rows in one pass

// out[row0 + t, :] = parity of the masked input bits, for the rows of tile
// blockIdx.y.  `masks` is (em, kg) bytes, kg = ek / 8 groups of 8 rows.
__global__ void __launch_bounds__(kThreads)
gf_mxu_kernel(const uint8_t* __restrict__ masks, const uint8_t* __restrict__ bits,
              uint8_t* __restrict__ out, int em, int kg, int64_t n, bool vec) {
  extern __shared__ uint4 mat[];         // [group j][kMaxRows / 4]: M * 0x01010101
  const int row0 = blockIdx.y * kMaxRows;
  const int rows = min(kMaxRows, em - row0);
  uint32_t* words = reinterpret_cast<uint32_t*>(mat);
  for (int e = threadIdx.x; e < kg * kMaxRows; e += blockDim.x) {
    const int j = e / kMaxRows, t = e % kMaxRows;
    words[e] = t < rows ? uint32_t(masks[int64_t(row0 + t) * kg + j]) * 0x01010101u : 0u;
  }
  __syncthreads();

  const int64_t cols = (n + 3) >> 2;
  for (int64_t w = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; w < cols;
       w += int64_t(gridDim.x) * blockDim.x) {
    const int64_t p = w << 2;
    const int nb = n - p < 4 ? int(n - p) : 4;
    uint32_t acc[kMaxRows];
#pragma unroll
    for (int t = 0; t < kMaxRows; ++t) acc[t] = 0;
    for (int j = 0; j < kg; ++j) {
      const uint8_t* src = bits + int64_t(8 * j) * n + p;
      uint32_t x[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) x[r] = load4(src + int64_t(r) * n, nb, vec);
      uint32_t packed = 0;
#pragma unroll
      for (int r = 0; r < 8; ++r) packed |= (x[r] & 0x01010101u) << r;
#pragma unroll
      for (int q = 0; q < kMaxRows / 4; ++q) {
        const uint4 m = mat[j * (kMaxRows / 4) + q];
        acc[4 * q] ^= packed & m.x;
        acc[4 * q + 1] ^= packed & m.y;
        acc[4 * q + 2] ^= packed & m.z;
        acc[4 * q + 3] ^= packed & m.w;
      }
    }
    uint8_t* dst = out + int64_t(row0) * n + p;
#pragma unroll
    for (int t = 0; t < kMaxRows; ++t) {
      if (t < rows) {
        uint32_t a = acc[t];
        a ^= a >> 4;
        a ^= a >> 2;
        a ^= a >> 1;
        store4(dst + int64_t(t) * n, a & 0x01010101u, nb, vec);
      }
    }
  }
}

}  // namespace

// (em, ek / 8) packed row masks x (ek, n) int8 bits -> (em, n) int8,
// (bigmat @ bits) & 1.  Contiguous rows; the caller checks em, n >= 1 and
// ek % 8 == 0 with 8 <= ek <= 2048.
extern "C" int gf_matmul_mxu(const void* masks, const void* bits, void* out, int64_t em,
                             int64_t ek, int64_t n, void* stream) {
  if (ek % 8 != 0 || ek < 8 || ek > 2048) return int(cudaErrorInvalidValue);
  const int kg = int(ek / 8);
  const size_t smem = size_t(kg) * kMaxRows * 4;   // <= 256 * 96 B = 24 KiB
  const bool vec = (n % 4 == 0) && aligned4(bits) && aligned4(out);
  const dim3 grid(resident_grid(gf_mxu_kernel, (n + 3) / 4, kThreads, smem),
                  unsigned((em + kMaxRows - 1) / kMaxRows));
  gf_mxu_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(masks), static_cast<const uint8_t*>(bits),
      static_cast<uint8_t*>(out), int(em), kg, n, vec);
  return int(cudaGetLastError());
}
