// Device code shared by the tensor-core probe kernels (tc_rate.cu,
// int8_anatomy.cu, fixed_anatomy.cu), the Hopper counterparts of the TPU
// measurement probes under experiments/.  A probe measures a served
// kernel's parts, so it reuses the served headers: the wgmma, descriptor
// and fragment code of ../int8_wgmma.cuh (fir::int8tc) and the Q15 helpers
// of ../fir_common.cuh.  What is its own:
//
// - Resident operands.  A TPU probe keeps its operands in VMEM for the
//   whole grid; here a CTA copies its tiles into shared memory once, before
//   its timed loop, which then loads nothing from global memory.  Shared
//   memory holds a weight tile as the descriptor operand reads it
//   (int8tc::descriptor: K-slices of 32 bytes a row, 8-row x 16-byte core
//   matrices, no swizzle) and x rows [tap][lane] padded by 16 bytes, so the
//   8 rows an ldmatrix reads fall in distinct banks.
// - Int8 x rows [tap][lane] as the register operand (load_pairs): one
//   ldmatrix.x4.trans of the b16 pairs (lane 2j, lane 2j + 1) gives a
//   thread taps 2t, 2t + 1 of two neighbouring lanes in each 8-tap block;
//   byte permutes take the even lane's bytes of blocks 0-1 (2-3) into
//   fragment register 0 (2) and the odd lane's into 1 (3).  So K position
//   4t + j holds tap 8*(j/2) + 2t + j%2 (+ 16), the served kernels'
//   tiled_fir.K_PERM, and the fragment's M rows g and g + 8 of a warp are
//   its lanes 2g and 2g + 1 (tile_lane).
// - Splits of a reduction over CTAs.  Where one CTA cannot hold every
//   operand of its output tile, the tile's dot chains (tc_rate: the 8 x
//   blocks; int8_anatomy: the taps) are split over `groups` CTAs, each
//   storing its partial int32 tile; partial_sum adds them after the loop.
// - Filling the card: a launch runs n_ctas CTAs, CTA b computing unit b %
//   n_units (a unit: one CTA's tile of the function), so every SM holds
//   as many CTAs as fit.  CTAs b < n_units store the output; a later copy
//   stores its tile, every iteration, to a scratch tile of its own
//   (scratch + (b - n_units) * the tile's size), so the copies neither
//   contend for the output's lines nor grow the bytes written to memory.
#pragma once

#include "fir_common.cuh"
#include "int8_wgmma.cuh"

#include <type_traits>

namespace probes {

using fir::int8tc::kK;         // bytes of K a wgmma reads a row: 32
constexpr int kLanes = 64;     // M: the lanes of a warpgroup's tile
constexpr int kWgThreads = 128;
constexpr int kPitch8 = kLanes + 16;          // int8 x row, shared memory
constexpr int kPitch16 = fir::int8tc::kRawPitch;  // int16 / bf16 x row
constexpr int kSlots = 16;     // output slots: iteration i writes i % 16
constexpr int kMaxSmem = fir::int8tc::kMaxSmem;

static_assert(kPitch16 == 2 * kLanes + 16, "load_split's row pitch");

// Copies rows [0, n) x bytes [0, kb) of a K-major global matrix (row r at
// src + r * ld) into shared memory at dst as int8tc::descriptor reads it:
// K-slice s (32 bytes a row) of a tile_rows-row tile at s * tile_rows *
// 32, the rows from row0 of the tile (tile_rows = n, row0 = 0: the whole
// tile).  16-byte loads; src and ld 16-byte aligned, kb a multiple of 32.
__device__ __forceinline__ void stage_w(uint32_t dst, const uint8_t* src,
                                        size_t ld, int n, int kb, int tid,
                                        int threads, int tile_rows = 0,
                                        int row0 = 0) {
  const int chunks = kb / 16;
  if (tile_rows == 0) tile_rows = n;
  for (int e = tid; e < n * chunks; e += threads) {
    const int row = e / chunks, j = e % chunks;
    const uint4 v = *reinterpret_cast<const uint4*>(src + row * ld + j * 16);
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                     dst + (j / 2) * tile_rows * kK +
                     fir::int8tc::core_offset(row0 + row, j % 2)),
                 "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
                 : "memory");
  }
}

// Copies n rows of rb bytes (row r at src + r * ld) to dst + r * pitch.
// 16-byte loads; src, ld and rb 16-byte aligned.
__device__ __forceinline__ void stage_rows(uint32_t dst, int pitch,
                                           const uint8_t* src, size_t ld,
                                           int n, int rb, int tid,
                                           int threads) {
  const int chunks = rb / 16;
  for (int e = tid; e < n * chunks; e += threads) {
    const int row = e / chunks, j = e % chunks;
    const uint4 v = *reinterpret_cast<const uint4*>(src + row * ld + j * 16);
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                     dst + row * pitch + j * 16),
                 "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
                 : "memory");
  }
}

// The generic-proxy stores above, visible to the tensor cores (the async
// proxy) and to every thread of the CTA.
__device__ __forceinline__ void staged() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

// The int8 A fragment of one 32-tap K-slice of x rows [tap][lane] (pitch
// kPitch8): `at` = the slice's first row + l * kPitch8 + 16 * w for lane
// l of warp w (matrix l / 8 = taps 8*(l/8) .. +7 of the warp's 16 lanes).
__device__ __forceinline__ void load_pairs(uint32_t at, uint32_t (&a)[4]) {
  uint32_t m[4];
  fir::int8tc::ldmatrix_t(at, m);
  a[0] = __byte_perm(m[0], m[1], 0x6420);
  a[1] = __byte_perm(m[0], m[1], 0x7531);
  a[2] = __byte_perm(m[2], m[3], 0x6420);
  a[3] = __byte_perm(m[2], m[3], 0x7531);
}

// The lane of a warpgroup's tile that accumulator register i of thread
// (warp w, lane l) holds: M row 16w + l/4 + 8*((i/2)%2) is that lane for
// load_split's and the bf16 fragments, lane 16w + 2*(l/4) + (i/2)%2 for
// load_pairs'.  Its N column is 8*(i/4) + 2*(l%4) + i%2 either way.
template <bool kPaired>
__device__ __forceinline__ int tile_lane(int w, int l, int i) {
  return kPaired ? 16 * w + 2 * (l / 4) + (i / 2) % 2
                 : 16 * w + l / 4 + 8 * ((i / 2) % 2);
}
__device__ __forceinline__ int tile_col(int l, int i) {
  return 8 * (i / 4) + 2 * (l % 4) + i % 2;
}

// out[i] = sum_g partial[g * n + i] mod 2^32: the groups' partial tiles
// (one copy a source file that includes this header).
static __global__ void partial_sum_kernel(const uint32_t* __restrict__ partial,
                                   uint32_t* __restrict__ out, int groups,
                                   long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    uint32_t s = 0;
    for (int g = 0; g < groups; ++g) s += partial[g * n + i];
    out[i] = s;
  }
}

inline cudaError_t partial_sum(const void* partial, void* out, int groups,
                               long long n, cudaStream_t stream) {
  const int blocks = (int)((n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024);
  partial_sum_kernel<<<blocks, 256, 0, stream>>>(
      static_cast<const uint32_t*>(partial), static_cast<uint32_t*>(out),
      groups, n);
  return cudaGetLastError();
}

// The CTAs that fill the card: the kernel's blocks an SM at `smem` bytes
// of dynamic shared memory times the SMs, at least n_units.  Negative: a
// CUDA error.
template <typename Kernel>
inline int fill(Kernel* kernel, int threads, int smem, int n_units) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return per_sm * sms > n_units ? per_sm * sms : n_units;
}

}  // namespace probes
