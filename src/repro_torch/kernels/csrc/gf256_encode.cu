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
// that these byte products could saturate first, but a kernel can spend so
// many integer instructions per byte that they, not the bytes, set its time.
//
// Both kernels work on bytes, not bit-planes.  The TPU kernel works on
// bit-planes because a TPU has no byte gather; the reference packs and
// unpacks them around the kernel, three extra passes over memory.  Here a
// kernel reads bytes and writes bytes in a single pass, and the bytes equal
// the bit-sliced result: both compute the same products in the field of
// the primitive polynomial 0x11d.  Offsets are 64-bit, the stripe index
// lives in the grid-stride loop (never in gridDim.y/z), codes up to
// k + n <= 256 tile their output rows over grid.y (each tile re-reads the
// input), and ragged or unaligned rows go through the byte path of
// bytes.cuh.
//
// gf_matmul_kernel: bit-field tables and byte permutes (the GPU form of the
// pshufb method of ISA-L and GF-Complete, on fields of 3 bits because prmt
// picks 4 bytes out of 8).  c * x = T_a[x & 7] ^ T_b[(x >> 3) & 7] ^
// T_c[x >> 6] with tables of 8, 8 and 4 products per coefficient (32 bytes
// with padding), built on the host (field_tables in gf256_encode.py) and
// copied to shared memory per block.  A lookup of a data word's 4 bytes in
// one table is one prmt, whose selector holds one 3-bit field per byte; the
// selectors depend on the data word only, so split() builds them once (a
// mask, a multiply by 0x1001 that gathers the 4 fields into one 16-bit
// window, a shift: 10 instructions for 3 selectors and the permuted word)
// and every output row reuses them, at 3 prmt + 2 lop3 per (word,
// coefficient).  The multiply leaves the fields in the order of bytes 0, 2,
// 1, 3, so the products and the accumulators are in that order too, and
// the store swaps bytes 1 and 2 back.  Fields of 3 bits, not nibbles:
// a 16-entry lookup costs two prmt and a bytewise select.  A zero
// coefficient is skipped and a unit one is an XOR (uniform branches: every
// lane takes the same), so decode, whose inverted matrix is mostly zeros
// and unit rows, does no more products than encode.  A thread owns 16
// bytes of each of a tile's rows and loads the next input row while it
// works on this one; rows that allow it take a path of 16-byte accesses
// only.  It keeps one uint4 accumulator per output row: the tile height R
// is a template parameter, so a tile of R rows holds 4R accumulator
// registers and no more, and the grid fills the card with as many blocks
// as the registers let it hold (4 of 256 threads from R = 4 on, whose
// register count is capped for it).
//
// gf_scale_kernel is that body without the fold over j: a thread owns 16
// bytes of one input row j, splits its 4 words once and writes all m
// products c[i, j] * x of them (a zero coefficient stores zeros, a unit one
// the word itself), loading the next item's 16 bytes before it issues this
// one's stores.  It keeps no accumulators, so m costs no registers; the
// output rows tile over grid.y only when their tables exceed the default
// 48 KiB.  Its grid-stride walk over (j, column) steps without a 64-bit
// division per item (GridWalk in bytes.cuh).

#include "bytes.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 8;
constexpr int kSmemDefault = 48 * 1024;

// -- gf_matmul_kernel: bit-field tables ------------------------------------------

// Bytes of one coefficient's tables: T_a[8] (c * x), T_b[8] (c * (x << 3)),
// T_c[4] (c * (x << 6)), then 12 bytes of zeros.
constexpr int kFieldTableBytes = 32;

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(sel));
  return r;
}

// Bytes 0, 2, 1, 3 of x: the order of the selectors' fields (an involution).
__device__ __forceinline__ uint32_t swap12(uint32_t x) { return prmt(x, 0, 0x3120u); }

// What the lookups of one data word need, whatever the coefficient: a prmt
// selector per field (one selector nibble per byte, in the order of bytes
// 0, 2, 1, 3) and the word itself in that order, for unit coefficients.
// Masked to one field, x * 0x1001 holds every byte's field at a distinct
// nibble (no carries: each field is at most 3 bits), 4 of them in one
// 16-bit window that the shift moves to the bottom; prmt reads only the
// low 16 bits of a selector.
struct Fields {
  uint32_t a, b, c, x;
};

__device__ __forceinline__ Fields split(uint32_t x) {
  return {((x & 0x07070707u) * 0x1001u) >> 12, ((x & 0x38383838u) * 0x1001u) >> 15,
          ((x & 0xc0c0c0c0u) * 0x1001u) >> 18, swap12(x)};
}

// c * x for the 4 bytes of x, bytes 1 and 2 swapped, through c's tables:
// ab = T_a, T_b (4 words: entry e of T_a is byte e % 4 of word e / 4),
// c4 = T_c.
__device__ __forceinline__ uint32_t mul4_fields(const uint4& ab, uint32_t c4, const Fields& f) {
  return prmt(ab.x, ab.y, f.a) ^ prmt(ab.z, ab.w, f.b) ^ prmt(c4, 0, f.c);
}

// Products or sums in the selectors' byte order back in the row's.
__device__ __forceinline__ uint4 swap12(const uint4& x) {
  return make_uint4(swap12(x.x), swap12(x.y), swap12(x.z), swap12(x.w));
}

// out[s, i, :] = XOR_j c[i, j] * data[s, j, :] for the rows of tile
// blockIdx.y (R rows, fewer in the last tile).  `tables` is (n, k, 32);
// kWide: every row takes 16-byte accesses (width == 16).
template <int R, bool kWide>
__global__ void __launch_bounds__(kThreads, R > 3 ? 4 : 1)
gf_matmul_kernel(const uint4* __restrict__ tables, const uint8_t* __restrict__ data,
                 uint8_t* __restrict__ out, int64_t S, int n, int k, int64_t L, int width) {
  extern __shared__ uint4 field_tab[];    // [row t][j][T_a T_b, T_c and zeros]
  const int row0 = blockIdx.y * R;
  const int rows = min(R, n - row0);
  const uint4* src_tab = tables + int64_t(row0) * k * 2;
  for (int e = threadIdx.x; e < rows * k * 2; e += blockDim.x) field_tab[e] = src_tab[e];
  __syncthreads();

  const int64_t chunks = (L + 15) >> 4;
  const int64_t items = S * chunks;
  for (int64_t it = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; it < items;
       it += int64_t(gridDim.x) * blockDim.x) {
    const int64_t s = it / chunks;
    const int64_t p = (it - s * chunks) << 4;
    const int nb = L - p < 16 ? int(L - p) : 16;
    const uint8_t* src = data + s * k * L + p;
    uint4 acc[R];
#pragma unroll
    for (int t = 0; t < R; ++t) acc[t] = make_uint4(0, 0, 0, 0);
    uint4 next = load_row<kWide>(src, nb, width);
    for (int j = 0; j < k; ++j) {
      const uint4 x = next;
      if (j + 1 < k) next = load_row<kWide>(src + int64_t(j + 1) * L, nb, width);
      const Fields f0 = split(x.x), f1 = split(x.y), f2 = split(x.z), f3 = split(x.w);
#pragma unroll
      for (int t = 0; t < R; ++t) {
        if (t >= rows) break;
        const uint4 ab = field_tab[(t * k + j) * 2];
        const uint32_t c = (ab.x >> 8) & 0xffu;   // T_a[1] = c * 1
        if (c == 0) continue;
        if (c == 1) {
          acc[t].x ^= f0.x, acc[t].y ^= f1.x, acc[t].z ^= f2.x, acc[t].w ^= f3.x;
          continue;
        }
        const uint32_t c4 = field_tab[(t * k + j) * 2 + 1].x;
        acc[t].x ^= mul4_fields(ab, c4, f0);
        acc[t].y ^= mul4_fields(ab, c4, f1);
        acc[t].z ^= mul4_fields(ab, c4, f2);
        acc[t].w ^= mul4_fields(ab, c4, f3);
      }
    }
    uint8_t* dst = out + (s * n + row0) * L + p;
#pragma unroll
    for (int t = 0; t < R; ++t)
      if (t < rows) store_row<kWide>(dst + int64_t(t) * L, swap12(acc[t]), nb, width);
  }
}

template <int R, bool kWide>
cudaError_t launch_tile(const uint4* tables, const uint8_t* data, uint8_t* out, int64_t S,
                        int n, int k, int64_t L, int width, cudaStream_t stream) {
  const size_t smem = size_t(R) * k * kFieldTableBytes;
  const dim3 grid(resident_grid(gf_matmul_kernel<R, kWide>, S * ((L + 15) / 16), kThreads, smem),
                  unsigned((n + R - 1) / R));
  gf_matmul_kernel<R, kWide><<<grid, kThreads, smem, stream>>>(tables, data, out, S, n, k, L,
                                                               width);
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_matmul(const uint4* tables, const uint8_t* data, uint8_t* out, int64_t S,
                          int n, int k, int64_t L, cudaStream_t stream) {
  const int width = row_width(L, data, out);
  if (width == 16) return launch_tile<R, true>(tables, data, out, S, n, k, L, width, stream);
  return launch_tile<R, false>(tables, data, out, S, n, k, L, width, stream);
}

// -- gf_scale_kernel: the same lookups, no fold -------------------------------------

// out[row0 + t, j, :] = c[row0 + t, j] * data[j, :] for the `tile` output
// rows of tile blockIdx.y (fewer in the last).  `tables` is (m, k, 32).
template <bool kWide>
__global__ void __launch_bounds__(kThreads)
gf_scale_kernel(const uint4* __restrict__ tables, const uint8_t* __restrict__ data,
                uint8_t* __restrict__ out, int m, int k, int64_t L, int tile, int width) {
  extern __shared__ uint4 field_tab[];    // [row t][j][T_a T_b, T_c and zeros]
  const int row0 = blockIdx.y * tile;
  const int rows = min(tile, m - row0);
  const uint4* src_tab = tables + int64_t(row0) * k * 2;
  for (int e = threadIdx.x; e < rows * k * 2; e += blockDim.x) field_tab[e] = src_tab[e];
  __syncthreads();

  const int64_t chunks = (L + 15) >> 4;
  const int64_t row_stride = int64_t(k) * L;    // from output row t to t + 1
  const auto bytes_at = [L](int64_t p) { return L - p < 16 ? int(L - p) : 16; };
  GridWalk w(chunks);                           // (j, 16-byte column)
  uint4 next;
  if (w.row < k) next = load_row<kWide>(data + w.row * L + (w.col << 4), bytes_at(w.col << 4),
                                        width);
  while (w.row < k) {
    const int j = int(w.row);
    const int64_t p = w.col << 4;
    const int nb = bytes_at(p);
    const uint4 x = next;
    w.next();
    if (w.row < k) next = load_row<kWide>(data + w.row * L + (w.col << 4),
                                          bytes_at(w.col << 4), width);
    const Fields f0 = split(x.x), f1 = split(x.y), f2 = split(x.z), f3 = split(x.w);
    uint8_t* dst = out + (int64_t(row0) * k + j) * L + p;
    for (int t = 0; t < rows; ++t, dst += row_stride) {
      const uint4 ab = field_tab[(t * k + j) * 2];
      const uint32_t c = (ab.x >> 8) & 0xffu;   // T_a[1] = c * 1
      uint4 y = x;
      if (c == 0) {
        y = make_uint4(0, 0, 0, 0);
      } else if (c != 1) {
        const uint32_t c4 = field_tab[(t * k + j) * 2 + 1].x;
        y = swap12(make_uint4(mul4_fields(ab, c4, f0), mul4_fields(ab, c4, f1),
                              mul4_fields(ab, c4, f2), mul4_fields(ab, c4, f3)));
      }
      store_row<kWide>(dst, y, nb, width);
    }
  }
}

template <bool kWide>
cudaError_t launch_scale(const uint4* tables, const uint8_t* data, uint8_t* out, int m, int k,
                         int64_t L, int tile, int width, cudaStream_t stream) {
  const size_t smem = size_t(tile) * k * kFieldTableBytes;
  const dim3 grid(resident_grid(gf_scale_kernel<kWide>, k * ((L + 15) / 16), kThreads, smem),
                  unsigned((m + tile - 1) / tile));
  gf_scale_kernel<kWide><<<grid, kThreads, smem, stream>>>(tables, data, out, m, k, L, tile,
                                                          width);
  return cudaGetLastError();
}

}  // namespace

// (n, k, 32) bit-field tables x (S, k, L) bytes -> (S, n, L) bytes.  Contiguous
// rows and 16-byte aligned tables; the caller checks S, n, L >= 1 and
// 1 <= k <= 256.
extern "C" int gf_matmul_bytes_batched(const void* tables, const void* data, void* out,
                                       int64_t S, int64_t n, int64_t k, int64_t L,
                                       void* stream) {
  if (reinterpret_cast<uintptr_t>(tables) & 15u) return int(cudaErrorMisalignedAddress);
  // output rows per tile: all of them up to kMaxRows while their tables fit
  // the default 48 KiB of shared memory
  int64_t rows = kSmemDefault / (k * kFieldTableBytes);
  rows = rows < n ? rows : n;
  rows = rows < kMaxRows ? rows : kMaxRows;
  const auto* t = static_cast<const uint4*>(tables);
  const auto* d = static_cast<const uint8_t*>(data);
  auto* o = static_cast<uint8_t*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  const int ni = int(n), ki = int(k);
  switch (rows) {
    case 1: return int(launch_matmul<1>(t, d, o, S, ni, ki, L, st));
    case 2: return int(launch_matmul<2>(t, d, o, S, ni, ki, L, st));
    case 3: return int(launch_matmul<3>(t, d, o, S, ni, ki, L, st));
    case 4: return int(launch_matmul<4>(t, d, o, S, ni, ki, L, st));
    case 5: return int(launch_matmul<5>(t, d, o, S, ni, ki, L, st));
    case 6: return int(launch_matmul<6>(t, d, o, S, ni, ki, L, st));
    case 7: return int(launch_matmul<7>(t, d, o, S, ni, ki, L, st));
    default: return int(launch_matmul<8>(t, d, o, S, ni, ki, L, st));
  }
}

// (m, k, 32) bit-field tables x (k, L) bytes -> (m, k, L) bytes.  Contiguous
// rows and 16-byte aligned tables; the caller checks m, L >= 1 and
// 1 <= k <= 256.
extern "C" int gf_scale_bytes(const void* tables, const void* data, void* out, int64_t m,
                              int64_t k, int64_t L, void* stream) {
  if (reinterpret_cast<uintptr_t>(tables) & 15u) return int(cudaErrorMisalignedAddress);
  // output rows per tile: all of them while their tables fit the default
  // 48 KiB of shared memory (at least 6: k <= 256)
  int64_t tile = kSmemDefault / (k * kFieldTableBytes);
  tile = tile < m ? tile : m;
  const auto* t = static_cast<const uint4*>(tables);
  const auto* d = static_cast<const uint8_t*>(data);
  auto* o = static_cast<uint8_t*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  const int width = row_width(L, data, out);
  if (width == 16)
    return int(launch_scale<true>(t, d, o, int(m), int(k), L, int(tile), width, st));
  return int(launch_scale<false>(t, d, o, int(m), int(k), L, int(tile), width, st));
}
