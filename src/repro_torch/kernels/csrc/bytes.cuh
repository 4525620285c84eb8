// Byte-row helpers shared by the data-plane kernels.
//
// load4/store4: a thread owns 4 consecutive bytes of a row.  When every
// row starts on a 4-byte boundary (L % 4 == 0 and aligned base pointers,
// checked on the host) it moves them as one 32-bit word; otherwise byte by
// byte, which also masks the ragged tail of a row (nb < 4).  Byte b of the word is
// row byte p + b (little-endian), in both paths.
#pragma once

#include <cstdint>
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

// Resident blocks of `kernel` on every SM of the current device, for a
// grid-stride loop over `items` work items: enough to cover them, as many
// as the kernel's registers and shared memory let the card hold at once.
template <typename Kernel>
int resident_grid(Kernel kernel, int64_t items, int threads, size_t smem) {
  int dev = 0, sms = 1, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (per_sm < 1) per_sm = 1;
  const int64_t need = (items + threads - 1) / threads;
  const int64_t cap = int64_t(sms) * per_sm;
  return int(need < cap ? need : cap);
}

// Blocks for a grid-stride loop over `items` work items: enough to cover
// them, capped at `per_sm` resident blocks on every SM of the current device.
inline int grid_blocks(int64_t items, int threads, int per_sm) {
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t need = (items + threads - 1) / threads;
  const int64_t cap = int64_t(sms) * per_sm;
  return int(need < cap ? need : cap);
}

// The message of a CUDA error code, for the Python wrappers' exceptions.
extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
