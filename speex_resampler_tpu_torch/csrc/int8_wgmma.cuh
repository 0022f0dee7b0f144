// Scheme "int8" on Hopper's int8 tensor cores: the device function of
// streamed_fir_int8_kernel (sm_90a only).  It takes a fir::Tile, so the
// tiled int8 kernel can move onto it with a launcher change (its K must be
// a multiple of 16 and its planes laid out as below).
//
// It computes _dot_int8 (fir_common.cuh header): for digit d = 0..D-1 in
// order, I_d = sum_t w_d[t, r] * (x - 128) exactly (mod 2^32), then
// acc = __fadd_rn(acc, __fmul_rn(float(I_d), scale_d)), then
// y = WORD2INT(__fadd_rn(acc, bias[m, r])): the CUDA-core kernel's and the
// plain version's steps, so the bits are theirs.  x - 128 = 256*xh + xl,
// xh = x >> 8 (the int16's high byte) and xl = (x & 255) - 128 (its low
// byte with the top bit flipped), both int8; so I_d = 256*<w_d, xh> +
// <w_d, xl>: two int8 dots a digit with exact int32 sums, combined in
// uint32 (the wgmmas run without .satfinite, so their sums wrap as the
// CUDA cores' do; signed overflow would be undefined in C++).
//
// Product: wgmma.mma_async m64n32k32 .s32.s8.s8 with the lanes as M (64 a
// warpgroup), kN = 32 tile rows as N, xh or xl the register operand A and
// a digit plane's [32 taps x 32 rows] tile the shared-memory operand B.
// 8-bit wgmma has no transposed operand, so B is K-major: the planes are
// int8[D, P, R, K] (K bytes a row; ops/streamed_fir.py), staged as 8-row x
// 16-byte core matrices without swizzle (rows 16 bytes apart, the two
// 16-tap halves of a K-slice 128 bytes apart, 8-row groups 256 apart).
//
// A fragment: a thread of warp w holds lanes g = l/4 and g + 8 of the
// warp's 16, K positions 4t..4t+3 and 16+4t..16+4t+3 (t = l%4), four int8
// a register.  Two ldmatrix.x4.trans of the int16 x rows [tap][lane] give
// each thread taps 2t, 2t+1 of one lane per register, in the four 8-tap
// blocks of the slice; a byte permute (prmt) packs the high bytes (xh), or
// the low bytes ^ 0x80 (xl), of two such registers into one.  So K position
// 4t+j holds tap 8*(j/2) + 2t + j%2 (and 16 + that in the second half).
// The sums are exact integers, so the order inside a 32-tap slice is free:
// the host permutes each 32-tap group of the planes the same way
// (streamed_fir.K_PERM), and every 32-tap group starts at a multiple of 32.
//
// Registers: 2*D dots need 2*D accumulators.  At m64n64 that is 256 int32
// registers a thread for D = 4, which do not fit; so a warpgroup takes kN =
// 32 of the tile's 64 rows (16 registers a dot, 128 for D = 4) and every
// digit is summed in one walk of the band, building each K-slice's xh / xl
// fragments once for 2*D wgmmas.  A CTA is 64 rows x 64 lanes: the two
// warpgroups take the two 32-row halves of the same lanes.  Walking the
// band once a digit at m64n64 (2 x 32 accumulators, a CTA 64 rows x 128
// lanes) ran 3 % slower on the H100 for D = 4, what "auto" serves (1-3 %
// faster for D = 3; PERF.md section 6).
//
// Pipeline (as split5_wgmma.cuh): a ring of kStages buffers of two 32-tap
// K-slices, each the walk's digit tiles and the int16 x rows of the CTA's
// lanes (rows padded by 16 bytes, so an ldmatrix's 8 rows fall in distinct
// banks), filled by 16-byte cp.async kLead stages ahead, one group a
// stage; a barrier a stage.  Each K-slice is one wgmma group; two fragment
// sets let a slice's fragments be built while the previous slice's wgmmas
// run.  Where B % 8 != 0 a thread loads its x chunk with 2-byte loads.
//
// What bounds it: the tensor cores.  At 48 kHz -> 44.1 kHz q10 (B = 2048)
// the tiles walk 13.4 G multiply-adds, 2*D int8 products each: 0.11 ms at
// the 1,979 TOP/s peak for D = 4, against ~180 MB of bytes, 0.055 ms.
//
// Tap band: from t_lo rounded down to 32 until t_hi is covered, in whole
// K-slices; the extra taps hold zero weights in that row tile (or are
// zero-filled past K) and add exact zeros.  Rows past R are not stored,
// nor lanes past B.
#pragma once

#include "fir_common.cuh"

namespace fir {
namespace int8tc {

constexpr int kN = 32;                      // tile rows a warpgroup
constexpr int kMaxDigits = 4;               // digit planes a stage holds
constexpr int kK = 32;                      // taps per wgmma (K-slice)
constexpr int kSub = 2;                     // K-slices per stage
constexpr int kStageTaps = kK * kSub;
constexpr int kLead = 3;                    // stages the copies run ahead
// ring buffers: the stage in use and the one still draining take no copy
constexpr int kStages = kLead + 2;
constexpr int kLanes = 64;                  // lanes of a CTA (M)
constexpr int kTileBytes = kK * kRowTile;   // one [64 rows x 32 taps] tile
constexpr int kWBytes = kMaxDigits * kSub * kTileBytes;
constexpr int kRawPitch = kLanes * 2 + 16;
constexpr int kRawBytes = kStageTaps * kRawPitch;
constexpr int kStageBytes = (kWBytes + kRawBytes + 127) / 128 * 128;
constexpr int kSmemBytes = kStages * kStageBytes + 128;
constexpr int kAcc = kN / 2;                // accumulator registers a dot

static_assert(kThreads == 256 && kRowTile == 2 * kN,
              "two warpgroups a CTA, one a 32-row half");
static_assert(kSub == 2, "a stage's slot is reused two stages after it");
static_assert(kRowTile * kSub * 2 == kThreads, "one weight copy a digit");
static_assert(kStageTaps * kLanes / 8 % kThreads == 0, "whole x copies");
static_assert(kRowTile * kRawPitch <= kStageBytes, "the output tile fits");

// The byte offset of 16-byte chunk c (taps 16c .. 16c+15) of tile row n in
// a K-slice's tile: 8-row x 16-byte core matrices, no swizzle.
__device__ __forceinline__ uint32_t core_offset(int n, int c) {
  return (n / 8) * 256 + c * 128 + (n % 8) * 16;
}

// Shared-memory matrix descriptor of a K-major tile at a 16-byte aligned
// address, no swizzle: leading (K) byte offset 128 between the two 16-byte
// halves of a K-slice, stride (N) byte offset 256 between 8-row groups.
__device__ __forceinline__ uint64_t descriptor(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

// d (+)= A . B, m64n32k32 s32 += s8 x s8: A [64 lanes x 32 taps] in
// registers, B [32 taps x 32 rows] K-major in shared memory.
__device__ __forceinline__ void mma(int (&d)[kAcc], const uint32_t (&a)[4],
                                    uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// Keeps the compiler from moving accumulator or fragment reads or writes
// across the wgmma fences and waits.
template <int n>
__device__ __forceinline__ void pin(int (&d)[n]) {
#pragma unroll
  for (int i = 0; i < n; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
__device__ __forceinline__ void pin(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

__device__ __forceinline__ void ldmatrix_t(uint32_t at, uint32_t (&v)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
      : "r"(at)
      : "memory");
}

// The xh and xl A fragments of one K-slice: `at` is this thread's ldmatrix
// row (tap l%8 of 8-tap block (l/16), lanes 8*((l/8)%2) .. +7 of the
// warp's 16) in the slice's first 16 taps; the second 16 are 16 rows on.
// Register p of an ldmatrix holds taps 2t, 2t+1 (8-tap block p/2) of lane
// g + 8*(p%2); fragment register r takes blocks 0-1 (r < 2) or 2-3, lane
// g + 8*(r%2).
__device__ __forceinline__ void load_split(uint32_t at, uint32_t (&xh)[4],
                                           uint32_t (&xl)[4]) {
  uint32_t lo[4], hi[4];
  ldmatrix_t(at, lo);
  ldmatrix_t(at + 16 * kRawPitch, hi);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const uint32_t a = r < 2 ? lo[r % 2] : hi[r % 2];
    const uint32_t b = r < 2 ? lo[2 + r % 2] : hi[2 + r % 2];
    xh[r] = __byte_perm(a, b, 0x7531);
    xl[r] = __byte_perm(a, b, 0x6420) ^ 0x80808080u;
  }
}

__device__ __forceinline__ float pick(float4 s, int d) {
  return d == 0 ? s.x : d == 1 ? s.y : d == 2 ? s.z : s.w;
}

// The CTA's output tile (c: 64 rows of block k, kLanes lanes from
// c.lane0) from planes int8[kD, P, R, K] (each 32-tap group permuted,
// above), bias f32[P, R] and the kD digit scales.  Launch with kThreads
// threads and kSmemBytes of dynamic shared memory; K % 16 == 0 and the
// planes 16-byte aligned.
template <int kD>
__device__ __forceinline__ void fir_tile(const Launch& g, const Tile& c,
                                         const int8_t* __restrict__ planes,
                                         const float* __restrict__ bias,
                                         float4 scales) {
  static_assert(kD >= 1 && kD <= kMaxDigits, "digits");
  extern __shared__ uint8_t int8_smem[];
  const uint32_t ring = (smem_addr(int8_smem) + 127) & ~127u;
  const int tid = threadIdx.x, h = tid / 128;
  const int w = (tid % 128) / 32, l = tid % 32;
  const int wg_row = h * kN;  // this warpgroup's rows of the tile

  const int t_begin = c.t_lo & ~(kK - 1);
  const int n_stages =
      c.t_hi > t_begin ? (c.t_hi - t_begin + kStageTaps - 1) / kStageTaps : 0;

  // This thread's copies: 16-byte chunk wc of K-slice ws of tile row wr in
  // each digit plane; lanes 8*(i % (kLanes/8)) .. of x tap row i/(kLanes/8).
  const int wr = tid / 4, ws = (tid / 2) % 2, wc = tid % 2;
  const size_t plane = (size_t)g.P * g.R * g.K;
  const int8_t* wsrc =
      planes + ((size_t)c.m * g.R + c.rt * kRowTile + wr) * g.K;
  const uint32_t wdst = ws * kTileBytes + core_offset(wr, wc);
  const bool vec = g.B % 8 == 0 &&
                   (reinterpret_cast<uintptr_t>(g.hist) |
                    reinterpret_cast<uintptr_t>(g.x)) % 16 == 0;
  // This thread's ldmatrix row (load_split).
  const uint32_t frag = (8 * (l / 16) + l % 8) * kRawPitch +
                        (16 * w + 8 * ((l / 8) % 2)) * 2;

  auto stage_at = [&](int s) { return ring + (s % kStages) * kStageBytes; };
  // stage s of the walk: one cp.async group, empty past the band
  auto copy_stage = [&](int s) {
    if (s < n_stages) {
      const uint32_t buf = stage_at(s);
      const int t = t_begin + s * kStageTaps + ws * kK + wc * 16;
      const int bytes = min(max(g.K - t, 0), 16);
#pragma unroll
      for (int d = 0; d < kD; ++d)
        copy16(buf + d * kSub * kTileBytes + wdst,
               bytes ? wsrc + d * plane + t : planes,
               bytes);
#pragma unroll
      for (int r = 0; r < kStageTaps * kLanes / 8 / kThreads; ++r) {
        const int i = tid + r * kThreads, tap = i / (kLanes / 8);
        const int lane = (i % (kLanes / 8)) * 8;
        copy_x8(g, c.v0 + t_begin + s * kStageTaps + tap, c.lane0 + lane,
                vec, buf + kWBytes + tap * kRawPitch + lane * 2, planes);
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

  int acc[2 * kD][kAcc];
#pragma unroll
  for (int j = 0; j < 2 * kD; ++j)
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[j][i] = 0;
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
      pin(xh[j]);
      pin(xl[j]);
      load_split(buf + kWBytes + j * kK * kRawPitch + frag, xh[j], xl[j]);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      const int accumulate = s > 0 || j > 0;
#pragma unroll
      for (int d = 0; d < kD; ++d) {
        const uint64_t b = descriptor(buf + (d * kSub + j) * kTileBytes +
                                      (wg_row / 8) * 256);
        mma(acc[2 * d], xh[j], b, accumulate);
        mma(acc[2 * d + 1], xl[j], b, accumulate);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // later stages' copies run while this stage's wgmmas do
      if (j == 0) copy_stage(s + kLead);
    }
    stage_ready();
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int j = 0; j < 2 * kD; ++j) pin(acc[j]);
  float total[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) total[i] = 0.0f;
#pragma unroll
  for (int d = 0; d < kD; ++d) {
    const float scale = pick(scales, d);
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const uint32_t sum =
          256u * (uint32_t)acc[2 * d][i] + (uint32_t)acc[2 * d + 1][i];
      total[i] = __fadd_rn(total[i],
                           __fmul_rn(__int2float_rn((int)sum), scale));
    }
  }
  // every warpgroup's wgmmas are done before the ring takes the output tile
  __syncthreads();

  // Accumulator register i of thread (warp w, lane l) of warpgroup h: lane
  // 16w + l/4 + 8*((i/2)%2), row wg_row + 8*(i/4) + 2*(l%4) + i%2.
  // The int16 results go through shared memory ([64 rows][kRawPitch], the
  // first ring buffer, free after the last barrier) to 16-byte row stores.
  const float* bias_m = bias + (size_t)c.m * g.R + c.rt * kRowTile;
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int lane = 16 * w + l / 4 + 8 * ((i / 2) % 2);
    const int row = wg_row + 8 * (i / 4) + 2 * (l % 4) + i % 2;
    asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(ring + row * kRawPitch +
                                                   lane * 2),
                 "h"(word2int(__fadd_rn(total[i], bias_m[row])))
                 : "memory");
  }
  __syncthreads();
  const bool vec_y = g.B % 8 == 0 && reinterpret_cast<uintptr_t>(g.y) % 16 == 0;
#pragma unroll
  for (int r = 0; r < kRowTile * kLanes / 8 / kThreads; ++r) {
    const int chunk = tid + r * kThreads;
    const int row = chunk / (kLanes / 8), cl = chunk % (kLanes / 8) * 8;
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

// Lets an int8 kernel take kSmemBytes of dynamic shared memory.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel* kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kSmemBytes);
}

}  // namespace int8tc
}  // namespace fir
