// Byte-row helpers shared by the data-plane kernels.
//
// load4/store4: a thread owns 4 consecutive bytes of a row.  When every
// row starts on a 4-byte boundary (L % 4 == 0 and aligned base pointers,
// checked on the host) it moves them as one 32-bit word; otherwise byte by
// byte, which also masks the ragged tail of a row (nb < 4).  Byte b of the word is
// row byte p + b (little-endian), in both paths.
#pragma once

#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>

#include <cuda_runtime.h>

__device__ __forceinline__ uint32_t load4(const uint8_t* __restrict__ p, int nb, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const uint32_t*>(p));
  uint32_t x = 0;
  for (int b = 0; b < nb; ++b) x |= uint32_t(__ldg(p + b)) << (8 * b);
  return x;
}

__device__ __forceinline__ void store4(uint8_t* __restrict__ p, uint32_t x, int nb, bool vec) {
  if (vec) {
    *reinterpret_cast<uint32_t*>(p) = x;
    return;
  }
  for (int b = 0; b < nb; ++b) p[b] = uint8_t(x >> (8 * b));
}

inline bool aligned4(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 3u) == 0; }

// The same for 16 consecutive bytes as four little-endian words (x: bytes
// 0-3, ..., w: bytes 12-15).  `width` is what every row allows: 16 (one
// 16-byte access; L % 16 == 0 and 16-byte aligned bases), 4 (four 32-bit
// accesses, the missing words of a ragged tail skipped; L % 4 == 0 and
// 4-byte aligned bases) or 1 (bytes, masked to nb).
__device__ __forceinline__ uint4 load16(const uint8_t* __restrict__ p, int nb, int width) {
  if (width == 16) return __ldg(reinterpret_cast<const uint4*>(p));
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = min(max(nb - 4 * i, 0), 4);
    w[i] = load4(p + 4 * i, m, width == 4 && m == 4);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void store16(uint8_t* __restrict__ p, uint4 x, int nb, int width) {
  if (width == 16) {
    *reinterpret_cast<uint4*>(p) = x;
    return;
  }
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = min(max(nb - 4 * i, 0), 4);
    store4(p + 4 * i, w[i], m, width == 4 && m == 4);
  }
}

// The widest access every row of these operands allows (see load16).
inline int row_width(int64_t L, const void* a, const void* b) {
  const uintptr_t bases = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b);
  if (L % 16 == 0 && (bases & 15u) == 0) return 16;
  if (L % 4 == 0 && (bases & 3u) == 0) return 4;
  return 1;
}

// 16 bytes of a row: one 16-byte access on the wide path (kWide: the
// operands' width is 16), else load16/store16 at `width`.
template <bool kWide>
__device__ __forceinline__ uint4 load_row(const uint8_t* __restrict__ p, int nb, int width) {
  return kWide ? __ldg(reinterpret_cast<const uint4*>(p)) : load16(p, nb, width);
}

template <bool kWide>
__device__ __forceinline__ void store_row(uint8_t* __restrict__ p, uint4 x, int nb, int width) {
  if (kWide)
    *reinterpret_cast<uint4*>(p) = x;
  else
    store16(p, x, nb, width);
}

// A grid-stride walk over the cells (row, col) of a row-major grid of
// `cols` columns.  The first cell's index is divided once, when the thread
// starts; each step then adds the stride's (rows, cols) and carries once.
// A GPU has no integer divider: a 64-bit division is a software routine of
// tens of instructions, too many to pay for every 16 bytes.
struct GridWalk {
  int64_t row, col;
  int64_t step_row, step_col, cols;

  __device__ explicit GridWalk(int64_t cols_) : cols(cols_) {
    const int64_t first = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
    const int64_t stride = int64_t(gridDim.x) * blockDim.x;
    row = first / cols;
    col = first - row * cols;
    step_row = stride / cols;
    step_col = stride - step_row * cols;
  }

  __device__ __forceinline__ void next() {
    row += step_row;
    col += step_col;
    if (col >= cols) {
      col -= cols;
      ++row;
    }
  }
};

// Resident blocks of `kernel` on every SM of the current device, for a
// grid-stride loop over `items` work items: enough to cover them, as many
// as the kernel's registers and shared memory let the card hold at once.
// The SM count and the occupancy are asked of the runtime once per device,
// kernel and shared-memory size, and cached: the two queries cost more
// host time than the launch itself.
template <typename Kernel>
int resident_grid(Kernel kernel, int64_t items, int threads, size_t smem) {
  static std::mutex mu;
  static std::map<std::tuple<int, const void*, int, size_t>, int64_t> caps;
  int dev = 0;
  cudaGetDevice(&dev);
  int64_t cap;
  {
    const std::lock_guard<std::mutex> lock(mu);
    const auto key = std::make_tuple(dev, reinterpret_cast<const void*>(kernel), threads, smem);
    auto found = caps.find(key);
    if (found == caps.end()) {
      int sms = 1, per_sm = 1;
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
      if (per_sm < 1) per_sm = 1;
      found = caps.emplace(key, int64_t(sms) * per_sm).first;
    }
    cap = found->second;
  }
  const int64_t need = (items + threads - 1) / threads;
  return int(need < cap ? need : cap);
}

// The message of a CUDA error code, for the Python wrappers' exceptions.
extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
