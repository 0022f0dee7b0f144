// Scheme "highest" on Hopper's CUDA cores: the device function of
// streamed_fir_f32_kernel (both phase-tiled geometries) and
// dense_fir_f32_kernel.
//
// It computes y = WORD2INT(sum_t W[t, r] * float(x[v0 + t, lane])) for the
// CTA's 64 rows r of block k (phase m = k % P) and kLanes lanes.  Each
// output's sum is one f32 FMA chain (__fmaf_rn), from 0.0f, in ascending
// tap order: the chain of the port's first f32 kernel (fir_tile_f32, 8 x 4
// tiles staged synchronously, since removed), so the bits are the same.
// Taps skipped outside a tile's or a warp's nonzero band have a weight of
// exactly 0 and would add exactly 0 (x is an int16, so finite); WORD2INT
// does not see the sign of a zero.  No TF32 and no tensor cores: Hopper's
// take no f32 operands, and split5 is the tensor-core float scheme.
//
// What bounds it: the multiply-adds (filt_len per output, 2 FLOP each at
// the 67 TFLOP/s of the CUDA cores), several times the bytes.  The design
// keeps the FMA pipe fed:
//
// - Copy pipeline.  A ring of kStages stage buffers in dynamic shared
//   memory, each kStageTaps tap rows of the tile's 64 weight columns
//   (256-byte f32 rows) and of the CTA's int16 x lanes, filled by 16-byte
//   cp.async kLead stages ahead, one commit group a stage; one wait_group
//   and one barrier a stage.  x rows come from hist, x or nothing (past
//   the chunk: zero-filled), one row pointer a tap row; B % 8 != 0 or an
//   unaligned buffer takes 2-byte loads (copy_x8).  Weight rows past the
//   band are zero-filled; x rows past it are not copied (whatever int16
//   the buffer holds is finite, and meets a zero weight).  16-tap stages,
//   not 32: the ring and the two f32 buffers then take 40 KB, and at
//   127-151 registers a thread three or four CTAs share an SM (two at 32
//   taps, 80 KB); on the H100 that ran 1.16-1.45x faster (PERF.md).
// - int16 -> f32 once an element: the stage after the one being multiplied
//   is converted from the ring into one of two f32 buffers (x read by every
//   row group of the CTA would otherwise be converted 4 times), exactly:
//   float(v) = as_float(0x4B000000 + (v + 32768)) - 8421376.
// - Register tile.  A thread holds 8 rows x 8 lanes (64 accumulators);
//   a warp 16 rows x 128 lanes (2 x 16 threads), so per warp and tap 64
//   FFMAs take four 16-byte shared loads (the weights broadcast).  Thread
//   (ty, tx) of warp w: rows 16*(w % 4) + 8*ty .. +7, lanes 4*tx .. +3 and
//   64 + 4*tx .. +3 of its warp's 128 (neighbouring threads read
//   neighbouring 16 bytes).
// - Sub-bands.  Warp w % 4 owns 16 rows; the table gives their nonzero taps
//   (bands[m, rt*4 + w % 4], [lo, hi)), and the CTA copies their union.
//   A warp runs the 8-tap slices of a stage that meet its own sub-band and
//   skips the rest (warp-uniform, no bit changes): about 1.06-1.17x the
//   needed multiply-adds, against 1.25-1.49x for the 64-row band.
#pragma once

#include "fir_common.cuh"

namespace fir {
namespace f32 {

constexpr int kSubRows = 16;                    // rows of a warp's sub-band
constexpr int kSubBands = kRowTile / kSubRows;  // sub-bands of a row tile
constexpr int kLanes = 128;                     // lanes of a CTA
constexpr int kTM = 8;                          // rows of a thread
constexpr int kTN = 8;                          // lanes of a thread
constexpr int kWarpLanes = 16 * kTN;            // a warp: 2 x 16 threads
constexpr int kLaneGroups = kLanes / kWarpLanes;
constexpr int kThreads = 32 * kSubBands * kLaneGroups;
constexpr int kMinBlocks = 2;                   // CTAs an SM holds
constexpr int kStageTaps = 16;                  // tap rows of a stage
constexpr int kSlice = 8;                       // taps of a sub-band slice
constexpr int kLead = 2;                        // stages the copies run ahead
constexpr int kStages = kLead + 1;              // ring buffers

constexpr int kWBytes = kStageTaps * kRowTile * 4;
constexpr int kRawBytes = kStageTaps * kLanes * 2;
constexpr int kSlotBytes = kWBytes + kRawBytes;
constexpr int kXfBytes = kStageTaps * kLanes * 4;
constexpr int kSmemBytes = kStages * kSlotBytes + 2 * kXfBytes;

static_assert(kSubRows == 2 * kTM, "two 8-row thread groups a warp");
static_assert(kTN == 8, "two 4-lane groups a thread, 64 lanes apart");
static_assert(kLanes % kWarpLanes == 0 && kStageTaps % kSlice == 0, "tiles");
static_assert(kStageTaps * 16 % kThreads == 0 &&
                  kStageTaps * kLanes / 8 % kThreads == 0 &&
                  kStageTaps * kLanes / 4 % kThreads == 0,
              "whole copies and conversions a thread");
static_assert(kLead >= 2, "a stage converted while the next is copied");

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Exact int16 -> f32 by the bit pattern of 2^23 + (v + 32768).
__device__ __forceinline__ float to_float(uint32_t bits16) {
  const int v = (int16_t)(bits16 & 0xFFFF);
  return __int_as_float(0x4B000000 + (v + 32768)) - 8421376.0f;
}

// Four int16 lanes (8 bytes of shared memory) as f32.
__device__ __forceinline__ void load4_i16(float* dst, const int16_t* src) {
  const uint2 v = *reinterpret_cast<const uint2*>(src);
  dst[0] = to_float(v.x);
  dst[1] = to_float(v.x >> 16);
  dst[2] = to_float(v.y);
  dst[3] = to_float(v.y >> 16);
}

// The output tile (block k, row tile rt, lanes lane0 ..) whose patch starts
// at row v0 of the virtual axis; w f32[P, K, R], g.taps int32[P, R / 16, 2]
// (each 16-row sub-band's nonzero taps [lo, hi), (0, 0) if none).  A block
// stores its first `rows` rows (y is [n_blocks * rows, B]): g.R, or fewer
// where R is padded to a whole row tile (the dense kernel).  A CTA covers
// kLanes_ lanes in thread tiles of kTN_ lanes: the tiled and streamed
// kernels take the defaults, launched with kThreads threads and kSmemBytes
// of dynamic shared memory; the dense kernel narrower CTAs, launched with
// threads_for() and smem_bytes() of its lanes.
template <int kLanes_ = kLanes, int kTN_ = kTN>
__device__ __forceinline__ void fir_tile(const Launch& g, int k, int rt,
                                         int lane0, int v0, int rows,
                                         const float* __restrict__ w) {
  // this CTA's lane tiling, as the namespace's constants for the defaults
  constexpr int kLanes = kLanes_, kTN = kTN_;
  constexpr int kWarpLanes = 16 * kTN;
  constexpr int kLaneGroups = kLanes / kWarpLanes;
  constexpr int kThreads = 32 * kSubBands * kLaneGroups;
  constexpr int kRawBytes = kStageTaps * kLanes * 2;
  constexpr int kSlotBytes = kWBytes + kRawBytes;
  constexpr int kXfBytes = kStageTaps * kLanes * 4;
  static_assert(kTN % 4 == 0 && kLanes % kWarpLanes == 0, "4-lane groups");
  static_assert(kStageTaps * 16 % kThreads == 0 &&
                    kStageTaps * kLanes / 8 % kThreads == 0 &&
                    kStageTaps * kLanes / 4 % kThreads == 0,
                "whole copies and conversions a thread");
  extern __shared__ __align__(16) uint8_t f32_smem[];
  const int tid = threadIdx.x, warp = tid / 32;
  const int sb = warp % kSubBands, lg = warp / kSubBands;
  const int ty = (tid % 32) / 16, tx = tid % 16;
  const int m = k % g.P;

  // the sub-bands of this row tile; the CTA walks their union
  const int32_t* bands =
      g.taps + ((size_t)m * (g.R / kSubRows) + rt * kSubBands) * 2;
  int t_lo = g.K, t_hi = 0;
#pragma unroll
  for (int i = 0; i < kSubBands; ++i) {
    if (bands[2 * i] < bands[2 * i + 1]) {
      t_lo = min(t_lo, bands[2 * i]);
      t_hi = max(t_hi, bands[2 * i + 1]);
    }
  }
  const int sb_lo = bands[2 * sb], sb_hi = bands[2 * sb + 1];
  const int n = t_hi > t_lo ? (t_hi - t_lo + kStageTaps - 1) / kStageTaps : 0;

  const float* wm = w + (size_t)m * g.K * g.R + rt * kRowTile;
  const bool vec = g.B % 8 == 0 &&
                   (reinterpret_cast<uintptr_t>(g.hist) |
                    reinterpret_cast<uintptr_t>(g.x)) % 16 == 0;
  auto slot = [&](int s) { return f32_smem + (s % kStages) * kSlotBytes; };
  auto xf = [&](int s) {
    return reinterpret_cast<float*>(f32_smem + kStages * kSlotBytes +
                                    (s % 2) * kXfBytes);
  };

  // stage s: its weight rows and int16 x rows, one commit group (empty past
  // the band)
  auto copy_stage = [&](int s) {
    if (s < n) {
      uint8_t* buf = slot(s);
      const int t0 = t_lo + s * kStageTaps;
#pragma unroll
      for (int r = 0; r < kStageTaps * 16 / kThreads; ++r) {
        const int i = tid + r * kThreads, t = t0 + i / 16;
        copy16(smem_addr(buf + i * 16),
               t < t_hi ? wm + (size_t)t * g.R + (i % 16) * 4 : w,
               t < t_hi ? 16 : 0);
      }
#pragma unroll
      for (int r = 0; r < kStageTaps * kLanes / 8 / kThreads; ++r) {
        const int i = tid + r * kThreads, t = t0 + i / (kLanes / 8);
        if (t < t_hi)
          copy_x8(g, v0 + t, lane0 + (i % (kLanes / 8)) * 8, vec,
                  smem_addr(buf + kWBytes + i * 16), w);
      }
    }
    commit();
  };
  // stage s's int16 x rows, landed, into its f32 buffer
  auto convert = [&](int s) {
    const int16_t* raw = reinterpret_cast<const int16_t*>(slot(s) + kWBytes);
    float* dst = xf(s);
#pragma unroll
    for (int r = 0; r < kStageTaps * kLanes / 4 / kThreads; ++r) {
      const int i = tid + r * kThreads;
      float v[4];
      load4_i16(v, raw + i * 4);
      *reinterpret_cast<float4*>(dst + i * 4) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  };

  float acc[kTM][kTN];
#pragma unroll
  for (int a = 0; a < kTM; ++a)
#pragma unroll
    for (int b = 0; b < kTN; ++b) acc[a][b] = 0.0f;
  const int wrow = sb * kSubRows + ty * kTM;     // this thread's rows
  const int xlane = lg * kWarpLanes + 4 * tx;    // and lanes, + 64c

  // acc += stage s's taps, ascending, in the 8-tap slices that meet this
  // warp's sub-band
  auto multiply = [&](int s) {
    const float* ws = reinterpret_cast<const float*>(slot(s));
    const float* xs = xf(s);
    const int st = t_lo + s * kStageTaps;
#pragma unroll
    for (int j = 0; j < kStageTaps / kSlice; ++j) {
      if (!(st + j * kSlice < sb_hi && st + (j + 1) * kSlice > sb_lo))
        continue;
#pragma unroll
      for (int kk = 0; kk < kSlice; ++kk) {
        const int t = j * kSlice + kk;
        float wr[kTM], xr[kTN];
        load4(wr, ws + t * kRowTile + wrow);
        load4(wr + 4, ws + t * kRowTile + wrow + 4);
#pragma unroll
        for (int c = 0; c < kTN / 4; ++c)
          load4(xr + 4 * c, xs + t * kLanes + xlane + 64 * c);
#pragma unroll
        for (int a = 0; a < kTM; ++a)
#pragma unroll
          for (int b = 0; b < kTN; ++b)
            acc[a][b] = __fmaf_rn(wr[a], xr[b], acc[a][b]);
      }
    }
  };

  // The ring: stage s is multiplied while stage s + 1 is converted and
  // stages up to s + kLead are copied; the barrier ending iteration s makes
  // stage s + 1's f32 rows and stage s + 2's int16 rows visible, and frees
  // stage s's buffers.
#pragma unroll
  for (int s = 0; s < kLead; ++s) copy_stage(s);
  if (n > 0) {
    wait<kLead - 2>();
    __syncthreads();
    convert(0);
    __syncthreads();
  }
#pragma unroll 1
  for (int s = 0; s < n; ++s) {
    copy_stage(s + kLead);
    if (s + 1 < n) convert(s + 1);
    multiply(s);
    wait<kLead - 2>();
    __syncthreads();
  }

  // rows wrow .., lanes xlane + 64c ..: 4 int16 lanes an 8-byte store
  const bool vec_y =
      g.B % 4 == 0 && reinterpret_cast<uintptr_t>(g.y) % 8 == 0;
#pragma unroll
  for (int a = 0; a < kTM; ++a) {
    const int row = rt * kRowTile + wrow + a;
    if (row >= rows) break;
    int16_t* out = g.y + ((size_t)k * rows + row) * g.B + lane0;
#pragma unroll
    for (int c = 0; c < kTN / 4; ++c) {
      const int lane = xlane + 64 * c;
      int16_t q[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) q[b] = word2int(acc[a][4 * c + b]);
      if (vec_y) {
        if (lane0 + lane < g.B)
          *reinterpret_cast<uint2*>(out + lane) = make_uint2(
              (uint32_t)(uint16_t)q[0] | ((uint32_t)(uint16_t)q[1] << 16),
              (uint32_t)(uint16_t)q[2] | ((uint32_t)(uint16_t)q[3] << 16));
      } else {
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (lane0 + lane + b < g.B) out[lane + b] = q[b];
      }
    }
  }
}

// The threads and dynamic shared memory of a CTA of `lanes` lanes in
// thread tiles of `tn` lanes (kThreads and kSmemBytes for the defaults).
constexpr int threads_for(int lanes, int tn) {
  return 32 * kSubBands * (lanes / (16 * tn));
}
constexpr int smem_bytes(int lanes) {
  return kStages * (kWBytes + kStageTaps * lanes * 2) +
         2 * kStageTaps * lanes * 4;
}

// Lets an f32 kernel take kSmemBytes of dynamic shared memory (the most
// any f32 CTA takes), kMinBlocks CTAs to an SM.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel* kernel) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

}  // namespace f32
}  // namespace fir
