// XOR fold of n byte rows: the streaming-TriEC parity-node aggregation,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels in src/repro/kernels/xor_reduce.py:
//   xor_reduce_bytes_batched  <- xor_reduce_batched (and, launched with
//                                S = 1, xor_reduce)
//
// Bound: device memory, S*(n+1)*L bytes (read S*n*L, write S*L).
//
// Design: the TPU kernel folds a VMEM tile of n rows with a log-depth tree
// in one sequential grid step.  Here a thread owns 16 consecutive bytes of
// one output row and folds the n input rows straight into registers, so
// every input byte is read once and every output byte written once, with
// no padding: the reference pads rows to whole u32 words and slices back,
// this kernel takes the ragged tail through the byte path of bytes.cuh.
// A memory-bound fold is as fast as the reads it keeps in flight: a thread
// issues the loads of up to kGroup rows (16 bytes each, one access on the
// wide path) before its first XOR, so n * 16 bytes are in flight per
// thread, where a loop that XORs each row as it arrives waits on every
// load in turn.  Rows past kGroup fold in further groups.  Offsets are
// 64-bit, and the stripe index lives in the grid-stride walk (GridWalk,
// which divides once per thread, not once per item), never in gridDim.y/z:
// S can exceed 65,535.

#include "bytes.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 8;      // rows whose loads are issued before the first XOR

// out[s, :] = XOR_i x[s, i, :].  kWide: every row takes 16-byte accesses.
template <bool kWide>
__global__ void __launch_bounds__(kThreads)
xor_reduce_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out, int64_t S, int n,
                  int64_t L, int width) {
  const int64_t chunks = (L + 15) >> 4;
  for (GridWalk w(chunks); w.row < S; w.next()) {      // (stripe, 16-byte column)
    const int64_t p = w.col << 4;
    const int nb = L - p < 16 ? int(L - p) : 16;
    const uint8_t* src = x + w.row * n * L + p;
    uint4 acc = make_uint4(0, 0, 0, 0);
    for (int i0 = 0; i0 < n; i0 += kGroup) {
      uint4 v[kGroup];
#pragma unroll
      for (int r = 0; r < kGroup; ++r)
        v[r] = i0 + r < n ? load_row<kWide>(src + int64_t(i0 + r) * L, nb, width)
                          : make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int r = 0; r < kGroup; ++r) {
        acc.x ^= v[r].x;
        acc.y ^= v[r].y;
        acc.z ^= v[r].z;
        acc.w ^= v[r].w;
      }
    }
    store_row<kWide>(out + w.row * L + p, acc, nb, width);
  }
}

template <bool kWide>
cudaError_t launch(const uint8_t* x, uint8_t* out, int64_t S, int n, int64_t L, int width,
                   cudaStream_t stream) {
  const int grid = resident_grid(xor_reduce_kernel<kWide>, S * ((L + 15) / 16), kThreads, 0);
  xor_reduce_kernel<kWide><<<grid, kThreads, 0, stream>>>(x, out, S, n, L, width);
  return cudaGetLastError();
}

}  // namespace

// (S, n, L) bytes -> (S, L) bytes.  Contiguous rows; the caller checks
// S, n, L >= 1.
extern "C" int xor_reduce_bytes_batched(const void* x, void* out, int64_t S, int64_t n,
                                        int64_t L, void* stream) {
  const auto* in = static_cast<const uint8_t*>(x);
  auto* o = static_cast<uint8_t*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  const int width = row_width(L, x, out);
  if (width == 16) return int(launch<true>(in, o, S, int(n), L, width, st));
  return int(launch<false>(in, o, S, int(n), L, width, st));
}
