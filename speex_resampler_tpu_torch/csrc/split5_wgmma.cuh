// Scheme "split5" on Hopper's bf16 tensor cores: the device function of
// streamed_fir_split5_kernel, both phase-tiled geometries (sm_90a only).
//
// It computes _dot_scheme's five dots (fir_common.cuh header): d_1..d_5 =
// <w_hi,x_hi>, <w_hi,x_lo>, <w_mid,x_hi>, <w_mid,x_lo>, <w_lo,x_hi>, every
// product bf16 x bf16 and so exact in f32, then y = ((((d_1 + d_2) + d_3)
// + d_4) + d_5) with __fadd_rn and WORD2INT.  A CTA keeps fir::Tile's
// output tile (block k, 64 rows, 128 lanes, 256 threads); warpgroup h
// (threads 128h..128h+127) owns lanes 64h..64h+63.
//
// Product: wgmma.mma_async m64n64k16, f32 += bf16 x bf16, with the lanes
// as M and the tile's 64 output rows as N (the transpose of y's [rows,
// lanes] block).  A is x_hi or x_lo, [64 lanes x 16 taps], in registers:
// each warp's ldmatrix.trans of the int16 rows in shared memory gives the
// fragment, split there into bf16 hi and lo.  B is a weight plane's [16
// taps x 64 rows] tile in shared memory: the [.., K, R] planes hold a
// tile's 64 rows in 128 contiguous bytes per tap, so B is N-major
// (transposed), stored in the 128-byte swizzle (16-byte chunk c of tap row
// t at chunk c ^ (t % 8)).  x as the register operand halves what the
// wgmmas read from shared memory (with both operands there an m64n64k16
// reads 4 KB for 32 tensor-core cycles, the SM's whole 128 B/cycle) and
// needs no shared-memory copy of x_hi / x_lo.
//
// Five accumulators, one walk: each dot keeps its own 32 f32 registers a
// thread (160 in all), so the tap band is walked once and each K-slice
// builds x_hi / x_lo once for five wgmmas.  No two dots share an
// accumulator: d_2..d_5 are 2^-8..2^-16 of d_1, and mixed into d_1's sum
// they would be rounded at d_1's scale (a K-concatenated bf16 bmm of the
// five products is off on 2-6 % of the outputs).
//
// Promotion of d_1: the tensor cores' f32 accumulation is not the plain
// version's round-to-nearest FMA chain, and over a long band (240 K-slices
// at 96 kHz -> 8 kHz q10) d_1's error builds up: kept in one wgmma
// accumulator it was off its plain version on 1.3e-2 of the outputs on
// the H100, past the 5e-3 tie bound.  So d_1's accumulator restarts every
// kPromote stages (scale-d 0) and is added into a register total with
// __fadd_rn (3.1e-3 there); d_2..d_5 are 2^-8 of d_1 or less and stay in
// theirs.
//
// Pipeline: each K-slice is its own wgmma group.  Two fragment sets: a
// slice's fragments are built while the previous slice's wgmmas run, into
// the set the slice before that used once its group is done, so the
// tensor cores run on across stages and drain only where d_1 is promoted.
// That and 5 x 32 + 32 accumulator registers leave no room for more sets
// or longer stages (64-tap stages spilled).
//
// Staging: a ring of kStages buffers of kStageTaps (32) taps, each copied
// kLead stages ahead by 16-byte cp.async, one group a stage: the three
// weight planes' 128-byte tap rows (zero-filled past K) and the int16 x
// rows of the CTA's 128 lanes.  cp.async and not TMA: a stage's weights
// are 96 rows of 128 bytes, three copies a thread, and need no tensor map
// kept per weight set; and x cannot go by TMA at all (the virtual axis
// hist ++ x spans two tensors, rows past the chunk read as zero, odd B
// gives rows that are not 16-byte aligned).  Where B % 8 != 0 a thread
// loads its x chunk with 2-byte loads instead.  A barrier a stage makes
// every thread's copies visible (after the proxy fence, to the tensor
// cores too).  The results leave through shared memory as 16-byte rows.
//
// What bounds it: the tensor cores' work is 0.20 ms at 96 kHz -> 8 kHz
// (0.14 ms at 48 kHz -> 44.1 kHz); on the H100 the kernel runs at about
// 36-40 % of that peak, held by the drains, the barrier a stage, and the
// ~20 KB a stage copies from L2 (PERF.md).
//
// Tap band: each row tile walks 16-tap K-slices from t_lo rounded down to
// 16 until t_hi is covered, copying whole stages; the extra taps hold zero
// weights in that tile (or are zero-filled past K) and add exact zeros.
// Rows past R are not stored, nor lanes past B.
#pragma once

#include <cuda_bf16.h>

#include "fir_common.cuh"

namespace fir {
namespace split5 {

constexpr int kK = 16;                     // taps per wgmma
constexpr int kSub = 2;                    // wgmma K-slices per stage
constexpr int kStageTaps = kK * kSub;
constexpr int kLead = 3;      // stages the copies run ahead
// ring buffers: the stage in use and the one still draining take no copy
constexpr int kStages = kLead + 2;
constexpr int kPromote = 2;   // stages per restart of d_1's accumulator
constexpr int kWCopies = kStageTaps * 8 / kThreads;  // per plane, a thread
constexpr int kTileBytes = kK * 128;       // one swizzled [16 taps x 64] tile
constexpr int kWBytes = 3 * kSub * kTileBytes;      // planes hi, mid, lo
// the int16 x rows of a stage, [taps][128 lanes], each row padded by 16
// bytes so the 8 rows an ldmatrix reads fall in distinct banks
constexpr int kRawPitch = kLaneTile * 2 + 16;
constexpr int kRawBytes = kStageTaps * kRawPitch;
constexpr int kStageBytes = (kWBytes + kRawBytes + 1023) / 1024 * 1024;
// the ring, and the slack to align it to the 1024-byte swizzle atom
constexpr int kSmemBytes = kStages * kStageBytes + 1024;

static_assert(kThreads == 256 && kRowTile == 64 && kLaneTile == 128,
              "two warpgroups of m64n64 tiles cover the CTA tile");
static_assert(kWCopies >= 1 && kWCopies * kThreads == kStageTaps * 8,
              "whole weight copies a thread");
static_assert(kThreads == kK * kLaneTile / 8, "one x chunk a thread a slice");
static_assert(kRowTile * kRawPitch <= kStageBytes, "the output tile fits");

// Byte offset of 16-byte chunk c of tap row t (0..15) in a swizzled tile.
__device__ __forceinline__ uint32_t swizzle(int t, int c) {
  return t * 128 + ((c ^ (t & 7)) << 4);
}

// Shared-memory matrix descriptor of a tile at a 1024-byte aligned address:
// the 128-byte swizzle, the second group of 8 taps 1024 bytes on (SBO); the
// M / N extent is one swizzle atom, so the leading offset is unused.
__device__ __forceinline__ uint64_t descriptor(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d (+)= A . B, m64n64k16: A [64 lanes x 16 taps] bf16 in registers (the
// fragment ldmatrix gives), B [16 taps x 64 rows] in shared memory,
// N-major (transposed).
__device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4],
                                    uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// Keeps the compiler from moving accumulator or fragment reads or writes
// across the wgmma fences and waits.
__device__ __forceinline__ void pin(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void pin(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of 16 lanes x 16 taps at raw_at (this thread's row of the
// four 8x8 int16 matrices, transposed: lanes become rows), split into x_hi
// = bf16(x) (nearest even) and x_lo = x - x_hi, both exact.
__device__ __forceinline__ void load_split(uint32_t raw_at, uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  uint32_t in[4];
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(in[0]), "=r"(in[1]), "=r"(in[2]), "=r"(in[3])
      : "r"(raw_at)
      : "memory");
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const float a = (float)(int16_t)(in[p] & 0xFFFF);
    const float b = (float)(int16_t)(in[p] >> 16);
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    hi[p] = bits(h);
    lo[p] = bits(__floats2bfloat162_rn(a - __low2float(h),
                                       b - __high2float(h)));
  }
}

// The CTA's output tile from the planes bf16[3, P, K, R] (hi, mid, lo).
// Launch with kSmemBytes of dynamic shared memory.
__device__ __forceinline__ void fir_tile(const Launch& g, const Tile& c,
                                         const __nv_bfloat16* __restrict__ planes) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_addr(smem_raw) + 1023) & ~1023u;
  const int tid = threadIdx.x, h = tid / 128;

  const int t_begin = c.t_lo & ~(kK - 1);
  const int n_stages =
      c.t_hi > t_begin ? (c.t_hi - t_begin + kStageTaps - 1) / kStageTaps : 0;

  // This thread's copies: chunk wc of tap rows wt + 32r of each plane, and
  // lanes xl .. xl+7 of x tap row xt of each K-slice.
  const int wt = tid / 8, wc = tid % 8;
  const __nv_bfloat16* wsrc =
      planes + (size_t)c.m * g.K * g.R + c.rt * kRowTile + wc * 8;
  const size_t plane = (size_t)g.P * g.K * g.R;
  const int xt = tid / 16, xl = (tid % 16) * 8;
  const bool vec = g.B % 8 == 0 &&
                   (reinterpret_cast<uintptr_t>(g.hist) |
                    reinterpret_cast<uintptr_t>(g.x)) % 16 == 0;
  // This thread's ldmatrix row: tap 8*(q/2) + lane%8 of a K-slice, lanes
  // 16w + 8*(q%2) .. +7 of its warpgroup's 64 (q = lane / 8; w its warp).
  const int w = (tid % 128) / 32, l = tid % 32;
  const uint32_t frag = (8 * (l / 16) + l % 8) * kRawPitch +
                        (64 * h + 16 * w + 8 * ((l / 8) % 2)) * 2;

  auto stage_at = [&](int s) { return ring + (s % kStages) * kStageBytes; };
  // stage s's weights and int16 x rows: one cp.async group, empty past
  // the band
  auto copy_stage = [&](int s) {
    if (s < n_stages) {
      const uint32_t buf = stage_at(s);
#pragma unroll
      for (int r = 0; r < kWCopies; ++r) {
        const int tr = wt + r * (kThreads / 8);
        const int t = t_begin + s * kStageTaps + tr;
#pragma unroll
        for (int p = 0; p < 3; ++p)
          copy16(buf + (p * kSub + tr / kK) * kTileBytes + swizzle(tr % kK, wc),
                 t < g.K ? wsrc + p * plane + (size_t)t * g.R : planes,
                 t < g.K ? 16 : 0);
      }
#pragma unroll
      for (int j = 0; j < kSub; ++j)
        copy_x8(g, c.v0 + t_begin + s * kStageTaps + j * kK + xt,
                c.lane0 + xl, vec,
                buf + kWBytes + (j * kK + xt) * kRawPitch + xl * 2, planes);
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

  float acc[5][32], total[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    total[i] = 0.0f;
#pragma unroll
    for (int d = 0; d < 5; ++d) acc[d][i] = 0.0f;
  }

  if (n_stages > 0) {
#pragma unroll
    for (int s = 0; s < kLead; ++s) copy_stage(s);
    stage_ready();
  }
  // Two fragment sets: a K-slice's are built while the previous slice's
  // wgmmas run, into the set the slice before that used, once its group is
  // done; so the tensor cores run on across stages, and drain only where
  // d_1 is promoted.
  uint32_t x_hi[2][4], x_lo[2][4];
#pragma unroll 1
  for (int s = 0; s < n_stages; ++s) {
    const uint32_t buf = stage_at(s);
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      // the last stage stops at the band's end (uniform over the CTA)
      if (j > 0 && t_begin + s * kStageTaps + j * kK >= c.t_hi) break;
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      pin(x_hi[j % 2]);
      pin(x_lo[j % 2]);
      load_split(buf + kWBytes + j * kK * kRawPitch + frag, x_hi[j % 2],
                 x_lo[j % 2]);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      const uint64_t w_hi = descriptor(buf + (0 * kSub + j) * kTileBytes);
      const uint64_t w_mid = descriptor(buf + (1 * kSub + j) * kTileBytes);
      const uint64_t w_lo = descriptor(buf + (2 * kSub + j) * kTileBytes);
      const bool restart = j == 0 && s % kPromote == 0;
      mma(acc[0], x_hi[j % 2], w_hi, !restart);
      mma(acc[1], x_lo[j % 2], w_hi, 1);
      mma(acc[2], x_hi[j % 2], w_mid, 1);
      mma(acc[3], x_lo[j % 2], w_mid, 1);
      mma(acc[4], x_hi[j % 2], w_lo, 1);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // later stages' copies run while this stage's wgmmas do
      if (j == 0) copy_stage(s + kLead);
    }
    if ((s + 1) % kPromote == 0 || s + 1 == n_stages) {
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
      for (int d = 0; d < 5; ++d) pin(acc[d]);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        pin(x_hi[k]);
        pin(x_lo[k]);
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) total[i] = __fadd_rn(total[i], acc[0][i]);
    }
    stage_ready();
  }

  // Accumulator register i of thread (warp w, lane l) of warpgroup h: lane
  // 64h + 16w + l/4 + 8*((i/2)%2), row 8*(i/4) + 2*(l%4) + i%2.  The int16
  // results go through shared memory ([64 rows][kRawPitch], in the first
  // stage buffer, free after the last barrier) to 16-byte row stores.
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    float y = total[i];
#pragma unroll
    for (int d = 1; d < 5; ++d) y = __fadd_rn(y, acc[d][i]);
    const int lane = 64 * h + 16 * w + l / 4 + 8 * ((i / 2) % 2);
    const int row = 8 * (i / 4) + 2 * (l % 4) + i % 2;
    asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(ring + row * kRawPitch +
                                                   lane * 2),
                 "h"(word2int(y))
                 : "memory");
  }
  __syncthreads();
  const bool vec_y = g.B % 8 == 0 && reinterpret_cast<uintptr_t>(g.y) % 16 == 0;
#pragma unroll
  for (int r = 0; r < kRowTile * kLaneTile / 8 / kThreads; ++r) {
    const int chunk = tid + r * kThreads;
    const int row = chunk / (kLaneTile / 8), cl = chunk % (kLaneTile / 8) * 8;
    const int lane = c.lane0 + cl;
    if (c.rt * kRowTile + row >= g.R || lane >= g.B) continue;
    uint32_t v[4];
    asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
                 : "r"(ring + row * kRawPitch + cl * 2)
                 : "memory");
    int16_t* out = g.y + ((size_t)c.k * g.R + c.rt * kRowTile + row) * g.B +
                   lane;
    if (vec_y) {
      *reinterpret_cast<uint4*>(out) = make_uint4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int b = 0; b < 8; ++b)
        if (lane + b < g.B) out[b] = (int16_t)(v[b / 2] >> (16 * (b & 1)));
    }
  }
}

// Lets a split5 kernel take kSmemBytes of dynamic shared memory.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel* kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kSmemBytes);
}

}  // namespace split5
}  // namespace fir
