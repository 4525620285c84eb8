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
// in one sequential grid step.  Here a thread owns 4 consecutive bytes of
// one output row and folds the n input words straight into a register, so
// every input byte is read once and every output byte written once, with
// no padding: the reference pads rows to whole u32 words and slices back,
// this kernel takes the ragged tail through the byte path of bytes.cuh.
// Offsets are 64-bit and the batch index lives in the grid-stride loop.

#include "bytes.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

// out[s, :] = XOR_i x[s, i, :]
__global__ void __launch_bounds__(kThreads)
xor_reduce_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out, int64_t S, int n,
                  int64_t L, bool vec) {
  const int64_t words = (L + 3) >> 2;
  const int64_t items = S * words;
  for (int64_t it = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; it < items;
       it += int64_t(gridDim.x) * blockDim.x) {
    const int64_t s = it / words;
    const int64_t p = (it - s * words) << 2;
    const int nb = L - p < 4 ? int(L - p) : 4;
    const uint8_t* src = x + s * n * L + p;
    uint32_t acc = 0;
    for (int i = 0; i < n; ++i) acc ^= load4(src + int64_t(i) * L, nb, vec);
    store4(out + s * L + p, acc, nb, vec);
  }
}

}  // namespace

// (S, n, L) bytes -> (S, L) bytes.  Contiguous rows; the caller checks
// S, n, L >= 1.
extern "C" int xor_reduce_bytes_batched(const void* x, void* out, int64_t S, int64_t n,
                                        int64_t L, void* stream) {
  const bool vec = (L % 4 == 0) && aligned4(x) && aligned4(out);
  const int grid = grid_blocks(S * ((L + 3) / 4), kThreads, kBlocksPerSm);
  xor_reduce_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<uint8_t*>(out), S, int(n), L, vec);
  return int(cudaGetLastError());
}
