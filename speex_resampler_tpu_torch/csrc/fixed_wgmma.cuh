// Scheme "fixed" (the Q15 universe) on Hopper's int8 tensor cores: the
// device function of streamed_fir_fixed_kernel<kAccum> (both phase-tiled
// geometries) and dense_fir_fixed_kernel<kAccum>
// (sm_90a only).  It takes a fir::Tile, so one body serves every geometry.
//
// It computes the JAX package's _dot_fixed (speex_resampler_tpu/ops/
// pallas_fir.py), the exact int16 x int16 dot mod 2^32 as four int8 dots:
// with the balanced split w = 256*wh + wl0 (wh, wl0 in [-128, 127];
// ops/fixed_math.balanced_q15_split) and x = 256*xh + xl + 128 (xh = x >>
// 8, xl = (x & 255) - 128: int8_wgmma.cuh's load_split), for each of the
// kAccum weight column sets c (column c*R + r) and each output row r,
//
//   acc_c = 65536*<wh_c, xh> + 256*(<wh_c, xl> + <wl_c, xh>) + <wl_c, xl>
//           + bias[m][c*R + r]                       (uint32, mod 2^32)
//
// where bias = 128 * sum_t w[t, c*R + r].  That is sum_t w*x exactly mod
// 2^32 for every int16 x (the zero rows past the chunk and the zero
// weights of the padded band included) and in any summation order: the C
// accumulator's value.  Then the Q15 epilogue (fir_common.cuh): kAccum 1
// (direct) y = SATURATE32PSHR(acc_0, 15, 32767); kAccum 4 (interpolated)
// y = SATURATE32PSHR(sum_c MULT16_32_Q15(coef[m][c][r], acc_c >> 1)), the
// sum in uint32 (fixed_generic.h, resample.c:474-479).
//
// Product: wgmma.mma_async m64nNk32 .s32.s8.s8 as in int8_wgmma.cuh: the
// CTA's 64 lanes as M, x as the register operand A (xh and xl built once
// per 32-tap K-slice by load_split, shared by every product and column
// set), a weight plane's [32 taps x N] tile as the shared-memory operand
// B, K-major (planes int8[2, P, C, K_pad], each 32-tap group permuted by
// streamed_fir.K_PERM; K_pad a multiple of 32).  Four wgmmas a K-slice:
// wh.xh, then wh.xl and wl.xh into one accumulator, then wl.xl; so three
// accumulators (hh, mid, ll), without .satfinite, so their sums wrap.
//
// Registers decide the tile: an accumulator over N columns costs N/2
// registers a thread.  kAccum 4 puts the column sets on N: a warpgroup
// takes 16 rows x 4 sets (N = 64, set-major: column 16c + r), 3 x 32
// accumulator registers, and the CTA's two warpgroups take 32 rows; each
// thread then holds all four sets of its outputs, so the cubic mix needs
// no exchange.  kAccum 1: 32 rows a warpgroup (N = 32, 3 x 16), 64 a CTA.
// The tap table is the CTA's: tiled_fir.tap_ranges(.., rows=kRows).
// kAccum 1 runs 2 CTAs an SM (at most 128 registers a thread, 2 x 87 KB
// of shared memory), which the streamed kernel needs to fit two (PERF.md
// section 6); kAccum 4 runs 1, as at 128 registers it spills.
//
// Pipeline (as int8_wgmma.cuh): a ring of kStages buffers of two K-slices,
// each the two planes' tiles and the int16 x rows of the CTA's lanes,
// filled by 16-byte cp.async kLead stages ahead; a barrier a stage; each
// K-slice one wgmma group, its fragments built while the previous slice's
// wgmmas run.  Where B % 8 != 0 a thread loads its x chunk with 2-byte
// loads.  The int16 tile leaves through shared memory as 16-byte rows.
//
// What bounds it: the tensor cores.  At 48 kHz -> 44.1 kHz q10 (B = 2048,
// n_accum 4) the function needs 43.2 G int16 multiply-adds, four int8
// products each: 345 G operations, 0.17 ms at the 1,979 TOP/s peak,
// above the ~0.06 ms of its ~194 MB.  On the CUDA cores (IMAD, 64 a clock
// an SM) the 44.5 G multiply-adds the tiles walk take >= 2.7 ms.
#pragma once

#include "fir_common.cuh"
#include "int8_wgmma.cuh"

namespace fir {
namespace fixedtc {

using int8tc::kK;
using int8tc::kLanes;
using int8tc::kRawBytes;
using int8tc::kRawPitch;
using int8tc::kStageTaps;
using int8tc::kSub;

constexpr int kLead = 3;  // stages the copies run ahead
// ring buffers: the stage in use and the one still draining take no copy
constexpr int kStages = kLead + 2;

template <int kAccum>
struct Shape {
  static_assert(kAccum == 1 || kAccum == 4, "n_accum 1 or 4");
  static constexpr int kWgRows = kAccum == 4 ? 16 : 32;  // rows a warpgroup
  static constexpr int kRows = 2 * kWgRows;              // rows a CTA
  static constexpr int kN = kWgRows * kAccum;            // wgmma N
  static constexpr int kAcc = kN / 2;        // registers an accumulator
  static constexpr int kPer = kAcc / kAccum;  // of them a column set
  static constexpr int kTileBytes = kK * 2 * kN;  // one plane's K-slice
  static constexpr int kWBytes = 2 * kSub * kTileBytes;
  static constexpr int kStageBytes = (kWBytes + kRawBytes + 127) / 128 * 128;
  static constexpr int kSmemBytes = kStages * kStageBytes + 128;
  static constexpr int kWCopies = 2 * kN * kSub * 2 / kThreads;  // a plane
  static constexpr int kMinBlocks = kAccum == 1 ? 2 : 1;  // CTAs an SM
};

// d (+)= A . B: m64n32k32 and m64n64k32 s32 += s8 x s8.
using int8tc::mma;

// The CTA's output tile (c: Shape::kRows rows of block k from row c.rt *
// kRows, kLanes lanes from c.lane0; c built with those rows and lanes)
// from planes int8[2, P, kAccum * R, K] (wh, wl0; each 32-tap group
// permuted, above), bias int32[P, kAccum * R] and, for kAccum 4, coef
// int32[P, 4, R].  Launch with kThreads threads and Shape::kSmemBytes of
// dynamic shared memory; K % 32 == 0 and the planes 16-byte aligned.  A
// block stores its first `rows` rows (g.R when 0: the dense kernel's
// weights carry zero columns up to a multiple of kRows), y being [n_blocks
// * rows, B].
template <int kAccum>
__device__ __forceinline__ void fir_tile(const Launch& g, const Tile& c,
                                         const int8_t* __restrict__ planes,
                                         const int32_t* __restrict__ bias,
                                         const int32_t* __restrict__ coef,
                                         int rows = 0) {
  using Sh = Shape<kAccum>;
  extern __shared__ uint8_t fixed_smem[];
  const uint32_t ring = (smem_addr(fixed_smem) + 127) & ~127u;
  const int tid = threadIdx.x, h = tid / 128;
  const int w = (tid % 128) / 32, l = tid % 32;
  const int C = kAccum * g.R;
  const int row0 = c.rt * Sh::kRows;  // the CTA's first block-local row

  const int t_begin = c.t_lo & ~(kK - 1);
  const int n_stages =
      c.t_hi > t_begin ? (c.t_hi - t_begin + kStageTaps - 1) / kStageTaps : 0;

  // This thread's weight copies: 16-byte chunk i % 2 of K-slice (i / 2) %
  // 2 of the CTA's B row n = i / 4 (warpgroup n / kN, set (n % kN) /
  // kWgRows, row n % kWgRows) in each plane; x as in int8_wgmma.cuh.
  const size_t plane = (size_t)g.P * C * g.K;
  const int8_t* wsrc[Sh::kWCopies];
  uint32_t wdst[Sh::kWCopies];
  int wt[Sh::kWCopies];
#pragma unroll
  for (int q = 0; q < Sh::kWCopies; ++q) {
    const int i = tid + q * kThreads, n = i / 4;
    const int set = (n % Sh::kN) / Sh::kWgRows;
    const int row = row0 + (n / Sh::kN) * Sh::kWgRows + n % Sh::kWgRows;
    wsrc[q] = planes + ((size_t)c.m * C + set * g.R + row) * g.K;
    wdst[q] = (i / 2) % 2 * Sh::kTileBytes + int8tc::core_offset(n, i % 2);
    wt[q] = (i / 2) % 2 * kK + i % 2 * 16;
  }
  const bool vec = g.B % 8 == 0 &&
                   (reinterpret_cast<uintptr_t>(g.hist) |
                    reinterpret_cast<uintptr_t>(g.x)) % 16 == 0;
  // This thread's ldmatrix row (int8tc::load_split).
  const uint32_t frag = (8 * (l / 16) + l % 8) * kRawPitch +
                        (16 * w + 8 * ((l / 8) % 2)) * 2;

  auto stage_at = [&](int s) { return ring + (s % kStages) * Sh::kStageBytes; };
  // stage s of the walk: one cp.async group, empty past the band
  auto copy_stage = [&](int s) {
    if (s < n_stages) {
      const uint32_t buf = stage_at(s);
      const int t0 = t_begin + s * kStageTaps;
#pragma unroll
      for (int q = 0; q < Sh::kWCopies; ++q) {
        const int t = t0 + wt[q];
        const bool in = t < g.K;
#pragma unroll
        for (int p = 0; p < 2; ++p)
          copy16(buf + p * kSub * Sh::kTileBytes + wdst[q],
                 in ? wsrc[q] + p * plane + t : planes, in ? 16 : 0);
      }
#pragma unroll
      for (int r = 0; r < kStageTaps * kLanes / 8 / kThreads; ++r) {
        const int i = tid + r * kThreads, tap = i / (kLanes / 8);
        const int lane = (i % (kLanes / 8)) * 8;
        copy_x8(g, c.v0 + t0 + tap, c.lane0 + lane, vec,
                buf + Sh::kWBytes + tap * kRawPitch + lane * 2, planes);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  // this thread's copies of the next stage have landed; then every
  // thread's, visible to the tensor cores and to ldmatrix
  auto stage_ready = [&]() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kLead - 1) : "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
  };

  int acc[3][Sh::kAcc];  // hh, mid, ll
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int i = 0; i < Sh::kAcc; ++i) acc[j][i] = 0;
  if (n_stages > 0) {
#pragma unroll
    for (int s = 0; s < kLead; ++s) copy_stage(s);
    stage_ready();
  }
  uint32_t xh[2][4], xl[2][4];
#pragma unroll 1
  for (int s = 0; s < n_stages; ++s) {
    const uint32_t buf = stage_at(s);
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      // the last stage stops at the band's end (uniform over the CTA)
      if (j > 0 && t_begin + s * kStageTaps + j * kK >= c.t_hi) break;
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      int8tc::pin(xh[j]);
      int8tc::pin(xl[j]);
      int8tc::load_split(buf + Sh::kWBytes + j * kK * kRawPitch + frag, xh[j],
                         xl[j]);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      const int accumulate = s > 0 || j > 0;
      // this warpgroup's kN rows of the plane tiles
      const uint32_t b = buf + j * Sh::kTileBytes + h * (Sh::kN / 8) * 256;
      const uint64_t bh = int8tc::descriptor(b);
      const uint64_t bl = int8tc::descriptor(b + kSub * Sh::kTileBytes);
      mma(acc[0], xh[j], bh, accumulate);
      mma(acc[1], xl[j], bh, accumulate);
      mma(acc[1], xh[j], bl, 1);
      mma(acc[2], xl[j], bl, accumulate);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // later stages' copies run while this stage's wgmmas do
      if (j == 0) copy_stage(s + kLead);
    }
    stage_ready();
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int j = 0; j < 3; ++j) int8tc::pin(acc[j]);
  // every warpgroup's wgmmas are done before the ring takes the output tile
  __syncthreads();

  // Accumulator register i = set * kPer + e of thread (warp w, lane l) of
  // warpgroup h: lane 16w + l/4 + 8*((e/2)%2), column 8*(i/4) + 2*(l%4) +
  // i%2 = set * kWgRows + r, so CTA row h * kWgRows + r with r = 8*(e/4) +
  // 2*(l%4) + e%2.  The int16 results go through shared memory ([kRows
  // rows][kRawPitch], the first ring buffer, free after the last barrier)
  // to 16-byte row stores.
  const int32_t* bias_m = bias + (size_t)c.m * C + row0;
  const int32_t* coef_m =
      kAccum == 4 ? coef + (size_t)c.m * 4 * g.R + row0 : nullptr;
#pragma unroll
  for (int e = 0; e < Sh::kPer; ++e) {
    const int lane = 16 * w + l / 4 + 8 * ((e / 2) % 2);
    const int r = h * Sh::kWgRows + 8 * (e / 4) + 2 * (l % 4) + e % 2;
    unsigned mix = 0;
#pragma unroll
    for (int set = 0; set < kAccum; ++set) {
      const int i = set * Sh::kPer + e;
      const unsigned sum = 65536u * (unsigned)acc[0][i] +
                           256u * (unsigned)acc[1][i] + (unsigned)acc[2][i] +
                           (unsigned)bias_m[set * g.R + r];
      mix = kAccum == 1 ? sum
                        : mix + mult16_32_q15(coef_m[set * g.R + r],
                                              (int)sum >> 1);
    }
    asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(ring + r * kRawPitch +
                                                   lane * 2),
                 "h"(sat32pshr15((int)mix))
                 : "memory");
  }
  __syncthreads();
  const bool vec_y = g.B % 8 == 0 && reinterpret_cast<uintptr_t>(g.y) % 16 == 0;
  const int R_out = rows > 0 ? rows : g.R;
#pragma unroll
  for (int r = 0; r < Sh::kRows * kLanes / 8 / kThreads; ++r) {
    const int chunk = tid + r * kThreads;
    const int row = chunk / (kLanes / 8), cl = chunk % (kLanes / 8) * 8;
    const int lane = c.lane0 + cl;
    if (row0 + row >= R_out || lane >= g.B) continue;
    uint32_t v[4];
    asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
                 : "r"(ring + row * kRawPitch + cl * 2)
                 : "memory");
    int16_t* out = g.y + ((size_t)c.k * R_out + row0 + row) * g.B + lane;
    if (vec_y) {
      *reinterpret_cast<uint4*>(out) = make_uint4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int b = 0; b < 8; ++b)
        if (lane + b < g.B) out[b] = (int16_t)(v[b / 2] >> (16 * (b & 1)));
    }
  }
}

// Lets a fixed kernel take Shape<kAccum>::kSmemBytes of dynamic shared
// memory.
template <int kAccum, typename Kernel>
inline cudaError_t allow_smem(Kernel* kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Shape<kAccum>::kSmemBytes);
}

static_assert(kThreads == 256, "two warpgroups a CTA");
static_assert(Shape<4>::kWCopies * kThreads == 2 * Shape<4>::kN * kSub * 2 &&
                  Shape<1>::kWCopies * kThreads == 2 * Shape<1>::kN * kSub * 2,
              "whole weight copies");
static_assert(Shape<1>::kRows * kRawPitch <= Shape<1>::kStageBytes &&
                  Shape<4>::kRows * kRawPitch <= Shape<4>::kStageBytes,
              "the output tile fits");
static_assert(Shape<4>::kRows * kLanes / 8 % kThreads == 0 &&
                  Shape<1>::kRows * kLanes / 8 % kThreads == 0,
              "whole output stores");

}  // namespace fixedtc
}  // namespace fir
