// Byte-row helpers shared by the data-plane kernels.
//
// A thread owns 4 consecutive bytes of a row.  When every row starts on a
// 4-byte boundary (L % 4 == 0 and aligned base pointers, checked on the
// host) it moves them as one 32-bit word; otherwise byte by byte, which
// also masks the ragged tail of a row (nb < 4).  Byte b of the word is
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
