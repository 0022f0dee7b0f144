// Scheme "int8" on Hopper's int8 tensor cores (sm_90a only): the device
// functions of streamed_fir_int8_kernel<kD, kDigits> (K2b: fir_tiles,
// persistent CTAs that hold each (phase, row tile) digit band in shared
// memory and stage x alone, where the digits pair up and the band fits;
// else fir_tile, one output tile a CTA, the weights streamed with x) and
// of tiled_fir_int8_kernel<kD, kVec> (fir_tile_resident: a row tile's
// digit planes held in shared memory across the kGroup output tiles its
// CTA walks; K1b).  A tiled step whose band does not fit launches K2b.
//
// It computes _dot_int8 (fir_common.cuh header): for digit d = 0..D-1 in
// order, I_d = sum_t w_d[t, r] * (x - 128) exactly (mod 2^32), then
// acc = __fadd_rn(acc, __fmul_rn(float(I_d), scale_d)), then
// y = WORD2INT(__fadd_rn(acc, bias[m, r])): the plain version's steps, so
// the bits are its own and the CUDA-core kernels' that came before.
// x - 128 = 256*xh + xl, xh = x >> 8 (the int16's high byte) and xl =
// (x & 255) - 128 (its low byte with the top bit flipped), both int8; so
// I_d = 256*<w_d, xh> + <w_d, xl>: two int8 dots a digit with exact int32
// sums, combined in uint32 (the wgmmas run without .satfinite, so their
// sums wrap as the CUDA cores' do; signed overflow would be undefined in
// C++).
//
// Product: wgmma.mma_async m64nNk32 .s32.s8.s8 with the lanes as M (64 a
// warpgroup), N = 32 or 64 tile rows (below), xh or xl the register
// operand A and a digit plane's [32 taps x N rows] tile the shared-memory
// operand B.
// 8-bit wgmma has no transposed operand, so B is K-major: the planes are
// int8[D, P, R, K] (K bytes a row; ops/tiled_fir.py), staged as 8-row x
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
// (tiled_fir.K_PERM), and every 32-tap group starts at a multiple of 32.
//
// Registers and split (fir_tile): 2*D dots a tile, all digits summed in
// one walk of the band, each K-slice's xh / xl fragments built once.  A CTA
// is 64 rows x 64 lanes; its two warpgroups share the stage and the
// fragments.  Where D is even (digit_split) warpgroup h sums digits h*D/2
// .. (h+1)*D/2 - 1 over all 64 rows, m64n64k32 (D accumulators of 32
// registers, 128 at D = 4); where D is odd each takes a 32-row half of
// every digit, m64n32k32 (2*D of 16; all 64 rows would need 256 at D = 4).
// The digit split's epilogue (store_tile_digits) hands each warpgroup's
// f32 terms to the other through shared memory in the plain version's
// order, each finishing half the tile.  On the H100 (48 kHz -> 44.1 kHz
// q10, B = 2048) it took K2b from 0.719 to 0.643 ms a launch at D = 4 and
// from 0.416 to 0.404 at D = 2; the walk alone (the epilogue dropped) ran
// no faster at N = 64 than at 32, so the gain is the epilogue's, whose
// biases are loaded before, and whose exchanged terms all at once, so no
// load waits in its finishing loop (PERF.md section 6).  Walking the band
// once a digit instead (2 accumulators, a CTA 64 rows x 128 lanes) ran 3 %
// slower at D = 4.
//
// fir_tile's pipeline (as split5_wgmma.cuh): a ring of kStages buffers of
// two 32-tap K-slices, each the walk's digit tiles and the int16 x rows of
// the CTA's lanes (rows padded by 16 bytes, so an ldmatrix's 8 rows fall
// in distinct banks), filled by 16-byte cp.async kLead stages ahead, one
// group a stage; a barrier a stage.  Each K-slice is one wgmma group; two
// fragment sets let a slice's fragments be built while the previous
// slice's wgmmas run.  Where B % 8 != 0 a thread loads its x chunk with
// 2-byte loads.  What bounds K2b: not the wgmma rate.  At 48 kHz -> 44.1
// kHz q10 (B = 2048) the tiles walk 13.4 G multiply-adds, 2*D int8
// products each (107 G at D = 4): 0.11 ms at the 1,979 TOP/s peak, against
// ~180 MB of bytes, 0.055 ms.  On fir_tile's walk (each tile's band staged
// again with x, 1.39 GB a launch) the walk took ~0.565 ms at N = 32 and 64
// alike: the stage copies held it.  fir_tiles (below) stages x alone and
// loads each band once a run (0.50 GB): 0.385 against 0.639 ms a launch
// in a CUDA graph, the walk alone 0.317 ms (0.375 us a walked K-slice a
// CTA), the digit-split epilogue ~0.07 and the exposed band switches
// ~0.01 (PERF.md section 6).  What holds it now: the x stages'
// copies and ldmatrix beside the wgmmas, one CTA an SM, and the epilogue,
// which nothing but the copies in flight overlaps.
//
// fir_tile_resident: the tiled geometry gives every block of one phase m
// the same weights, so the n_blocks / P blocks x ceil(B / 64) lane tiles
// of a (phase, 64-row tile) share one digit band.  A CTA owns one (m, row
// tile) and kGroup of those output tiles (its work list): all its threads
// copy the D digit bands once into shared memory, K-slice tile (d, i) at
// (d * n_slices + i) * kTileBytes in the layout the descriptor reads, with
// the row tile's biases.  Then its two warpgroups run on their own, each
// with its own ring of kRing 64-tap x stages (a named barrier a stage, no
// CTA barrier), so one warpgroup's epilogue, which drains its wgmmas,
// overlaps the other's products, and each ring runs on across the
// warpgroup's output tiles.  Where its 2*D accumulators fit (D <= 2, and
// D = 3 with 16-byte x copies) a warpgroup takes whole tiles, all 64 rows
// as N (m64n64k32: half the wgmmas of two 32-row halves, each x fragment
// built once); else (D = 4, and D = 3 with 2-byte x loads) each takes 32
// rows of every tile and copies the x it reads.  A stage's buffer is read
// only by ldmatrix (the weights are the shared-memory operand, x the
// register one), so a copy may refill the buffer of the stage before the
// current one: kRing - 1 stages run ahead.  At 44.1 kHz -> 48 kHz q7 (B =
// 2048, D = 3) a row tile's band spans at most 7 K-slices (42 KB of
// planes) and 128 output tiles share it; the copies a tile fall from ~29
// KB of x and 43 KB of planes (fir_tile) to ~29 KB + 43 / kGroup KB.  The
// bound: the launch's 82 MB, 0.0245 ms at 3.35 TB/s; the products (3.90 G
// band multiply-adds, 6 int8 products each) take 0.024 ms at the peak.
// Measured (PERF.md section 6), the wgmmas at N = 32 and the per-tile
// epilogue held the first, lockstep design, not the copies.
//
// Tap band: from t_lo rounded down to 32 until t_hi is covered, in whole
// K-slices; the extra taps hold zero weights in that row tile (or are
// zero-filled past K) and add exact zeros.  Rows past R are not stored,
// nor lanes past B.
#pragma once

#include "fir_common.cuh"

namespace fir {
namespace int8tc {

constexpr int kN = 32;                      // rows a warpgroup (row split)
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
// fir_tile_resident: the output tiles a CTA walks (its work list), its
// ring of x stage buffers (kRing - 1 stages ahead), its int16 output tile
constexpr int kGroup = 8;
constexpr int kRing = 4;
constexpr int kRingLead = kRing - 1;
constexpr int kOutBytes = kRowTile * kRawPitch;
constexpr int kMaxSmem = 232448;            // a CTA's most on the H100

// fir_tile's split of a tile between its two warpgroups: by digit plane
// where the digits pair up (warpgroup h sums digits h*kD/2 .. over all 64
// rows), else by 32-row half (every digit).
__host__ __device__ constexpr bool digit_split(int digits) {
  return digits % 2 == 0;
}

// fir_tiles (the persistent walk of a digit split): x stages copied
// kTileLead ahead across a CTA's tiles, in a ring of kTileLead + 2; the
// digit exchange of store_tile_digits (t and the second warpgroup's
// products of 16 registers a thread), a buffer of its own
constexpr int kTileLead = 6;
__host__ __device__ constexpr int exchange_bytes(int digits) {
  return 16 * (1 + digits / 2) * 128 * 4;
}
// Dynamic shared memory of fir_tiles with kD digit planes whose widest
// band spans `slices` K-slices: the x ring, the output tile, the
// exchange, two slots of a row tile's biases and one band buffer (kD
// planes' [64 rows x 32 taps] tiles a K-slice), alignment.
template <int kD>
__host__ __device__ constexpr int tiles_smem(int slices) {
  return (kTileLead + 2) * kRawBytes + kOutBytes + exchange_bytes(kD) +
         2 * kRowTile * 4 + kD * slices * kTileBytes + 128;
}

static_assert(kThreads == 256 && kRowTile == 2 * kN,
              "two warpgroups a CTA, 32 rows each in the row split");
static_assert(kSub == 2, "a stage's slot is reused two stages after it");
static_assert(kRowTile * kSub * 2 == kThreads, "one weight copy a digit");
static_assert(kStageTaps * kLanes / 8 % kThreads == 0, "whole x copies");
static_assert(kRowTile * kRawPitch <= kStageBytes, "the output tile fits");
static_assert(16 * (1 + kMaxDigits / 2) * 128 * 4 <= kStageBytes &&
                  kStages >= 2,
              "a second buffer holds the digit split's exchange");
static_assert(kRawBytes % 128 == 0 && kOutBytes % 128 == 0,
              "fir_tiles' buffers stay 128-byte aligned");

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

// d (+)= A . B, m64n64k32: B [32 taps x 64 rows] (fixed_wgmma.cuh's
// column sets; fir_tile_resident's whole row tile).
__device__ __forceinline__ void mma(int (&d)[32], const uint32_t (&a)[4],
                                    uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
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

// Dynamic shared memory of a resident CTA whose band spans `slices`
// K-slices of kD planes: the band, each warpgroup's ring and output tile,
// the row tile's biases, alignment.
template <int kD>
__host__ __device__ constexpr int resident_smem(int slices) {
  return kD * slices * kTileBytes + 2 * (kRing * kRawBytes + kOutBytes) +
         kRowTile * 4 + 128;
}

// Sends rows row0 .. row0 + kRows - 1 of the int16 tile in `out`
// ([kRowTile][kRawPitch] bytes of shared memory) to 16-byte row stores of
// block k, row tile rt, lanes from lane0: thread tid % kSharers of the
// kSharers threads that share `out` (rows past R and lanes past B are not
// stored).
template <int kRows, int kSharers>
__device__ __forceinline__ void store_rows(const Launch& g, int k, int rt,
                                           int lane0, int row0, uint32_t out) {
  const int tid = threadIdx.x;
  const bool vec_y = g.B % 8 == 0 && reinterpret_cast<uintptr_t>(g.y) % 16 == 0;
#pragma unroll
  for (int r = 0; r < kRows * kLanes / 8 / kSharers; ++r) {
    const int chunk = tid % kSharers + r * kSharers;
    const int row = row0 + chunk / (kLanes / 8), cl = chunk % (kLanes / 8) * 8;
    const int lane = lane0 + cl;
    if (rt * kRowTile + row >= g.R || lane >= g.B) continue;
    uint32_t v[4];
    asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
                 : "r"(out + row * kRawPitch + cl * 2)
                 : "memory");
    int16_t* dst = g.y + ((size_t)k * g.R + rt * kRowTile + row) * g.B + lane;
    if (vec_y) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int b = 0; b < 8; ++b)
        if (lane + b < g.B) dst[b] = (int16_t)(v[b / 2] >> (16 * (b & 1)));
    }
  }
}

// The epilogue of one output tile (64 rows from row rt * kRowTile of block
// k, phase m; kLanes lanes from lane0): its rows r0 .. r0 + kWgN - 1 that
// this warpgroup summed (kWgN/2 accumulator registers a dot), or, with
// kCta, both warpgroups' halves of the tile (kWgN = 32, r0 = 32 * h).
// Waits for the tile's wgmmas, takes each output's digit sums 256*h + l
// (uint32) and the f32 steps in digit order, adds the bias, and sends the
// int16 rows through `out` ([kRowTile][kRawPitch] bytes of shared memory
// that no copy in flight writes) to 16-byte row stores.  The bias is
// bias[m, rt * kRowTile + row] (kCta) or, for the resident CTA, the row
// tile's 64 biases at bias_smem, read an output at a time, so at 192
// accumulator registers none is held early.  Two barriers of
// the threads that share `out` (the CTA, or the warpgroup: named barrier
// 1 + h): before it is written (its last readers are done) and after.
template <int kD, int kWgN, bool kCta>
__device__ __forceinline__ void store_tile(const Launch& g, int k, int rt,
                                           int m, int lane0, int r0,
                                           int (&acc)[2 * kD][kWgN / 2],
                                           const float* __restrict__ bias,
                                           uint32_t bias_smem, float4 scales,
                                           uint32_t out) {
  constexpr int kRegs = kWgN / 2;
  constexpr int kSharers = kCta ? kThreads : 128;
  constexpr int kRows = kCta ? kRowTile : kWgN;   // rows the sharers store
  const int tid = threadIdx.x, h = tid / 128;
  const int w = (tid % 128) / 32, l = tid % 32;
  auto sync = [&]() {
    if (kCta)
      __syncthreads();
    else
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + h) : "memory");
  };
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int j = 0; j < 2 * kD; ++j) pin(acc[j]);
  sync();

  // Accumulator register i of thread (warp w, lane l) of a warpgroup:
  // lane 16w + l/4 + 8*((i/2)%2), row r0 + 8*(i/4) + 2*(l%4) + i%2.  An
  // output at a time, so its 2*kD registers are free once it is stored.
  const float* bias_m = bias + (size_t)m * g.R + rt * kRowTile;
#pragma unroll
  for (int i = 0; i < kRegs; ++i) {
    float total = 0.0f;
#pragma unroll
    for (int d = 0; d < kD; ++d) {
      const uint32_t sum =
          256u * (uint32_t)acc[2 * d][i] + (uint32_t)acc[2 * d + 1][i];
      total = __fadd_rn(total,
                        __fmul_rn(__int2float_rn((int)sum), pick(scales, d)));
    }
    const int lane = 16 * w + l / 4 + 8 * ((i / 2) % 2);
    const int row = r0 + 8 * (i / 4) + 2 * (l % 4) + i % 2;
    float b;
    if (kCta)
      b = bias_m[row];
    else  // an ordered shared load: no bias is hoisted into a register
      asm volatile("ld.shared.f32 %0, [%1];\n"
                   : "=f"(b)
                   : "r"(bias_smem + row * 4)
                   : "memory");
    asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(out + row * kRawPitch +
                                                   lane * 2),
                 "h"(word2int(__fadd_rn(total, b)))
                 : "memory");
  }
  sync();
  store_rows<kRows, kSharers>(g, k, rt, lane0, kCta ? 0 : r0, out);
}

// The digit-split epilogue of an output tile (block k, row tile rt, kLanes
// lanes from lane0; its 64 biases at bias_m, in global or shared memory) of
// fir_tile or fir_tiles, each warpgroup holding all 64 rows of its kD / 2
// digits (m64n64k32 accumulators: the same (lane, row) in the same register
// of both).  The f32 steps are store_tile's, in digit
// order: warpgroup 0 forms t = (0 + I_0 s_0) + I_1 s_1 (for kD = 4) of each
// output, warpgroup 1 its products I_2 s_2, I_3 s_3.  Each finishes half
// the outputs, t + I_2 s_2 + I_3 s_3 in that order, the bias, WORD2INT:
// warpgroup 1 registers 0-15 (rows 0-31), warpgroup 0 registers 16-31
// (rows 32-63), each sending the other the terms it lacks through `part`
// (a register index and thread apart: no bank conflict) across a CTA
// barrier.  The biases of a thread's 8 rows are loaded first and the
// exchanged terms all at once, so no load waits inside the finishing
// loop.  The int16 tile goes through `out` to 16-byte row stores.  `part`
// and `out` are buffers that no copy in flight writes.  `freed()` runs,
// every thread, once every wgmma of the CTA has retired (the first
// barrier): the shared memory they read is free from then on.
template <int kD, class Freed>
__device__ __forceinline__ void store_tile_digits(
    const Launch& g, int k, int rt, int lane0, int (&acc)[kD][32],
    const float* bias_m, float4 scales, uint32_t part, uint32_t out,
    Freed freed) {
  constexpr int kWgD = kD / 2;              // digits a warpgroup
  constexpr int kFin = 16;                  // registers a warpgroup finishes
  const int tid = threadIdx.x, h = tid / 128, wt = tid % 128;
  const int w = wt / 32, l = tid % 32;
  // word of the exchange: t of register i < kFin, or product d of register
  // kFin + i
  auto t_at = [&](int i) { return part + (i * 128 + wt) * 4; };
  auto p_at = [&](int d, int i) {
    return part + ((kFin + d * kFin + i) * 128 + wt) * 4;
  };
  // Accumulator register i of thread (warp w, lane l): lane 16w + l/4 +
  // 8*((i/2)%2), row 8*(i/4) + 2*(l%4) + i%2 (store_tile's, r0 = 0); the
  // finished registers fin0 + i, i < kFin, take bias b[(i/4)*2 + i%2].
  const int fin0 = h == 0 ? kFin : 0;
  float b[kFin / 2];
#pragma unroll
  for (int q = 0; q < kFin / 2; ++q)
    b[q] = bias_m[8 * (fin0 / 4 + q / 2) + 2 * (l % 4) + q % 2];
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int j = 0; j < kD; ++j) pin(acc[j]);
  __syncthreads();  // every wgmma's stage read: part and out are free
  freed();

  // I s of this warpgroup's digit d (the kernel's digit d + kWgD * h) in
  // accumulator register i
  auto term = [&](int d, int i, float scale) {
    const uint32_t sum =
        256u * (uint32_t)acc[2 * d][i] + (uint32_t)acc[2 * d + 1][i];
    return __fmul_rn(__int2float_rn((int)sum), scale);
  };
  auto st = [](uint32_t at, float v) {
    asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(at), "f"(v) : "memory");
  };
  auto ld = [](uint32_t at) {
    float v;
    asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(at) : "memory");
    return v;
  };
  auto finish = [&](int i, float total) {
    const int lane = 16 * w + l / 4 + 8 * ((i / 2) % 2);
    const int row = 8 * (i / 4) + 2 * (l % 4) + i % 2;
    const float bi = b[(i % kFin) / 4 * 2 + i % 2];
    asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(out + row * kRawPitch +
                                                   lane * 2),
                 "h"(word2int(__fadd_rn(total, bi)))
                 : "memory");
  };
  float v[kWgD][2 * kFin];  // warpgroup 0: t in v[0]; 1: its products
  if (h == 0) {
#pragma unroll
    for (int i = 0; i < 2 * kFin; ++i) {
      float total = 0.0f;
#pragma unroll
      for (int d = 0; d < kWgD; ++d)
        total = __fadd_rn(total, term(d, i, pick(scales, d)));
      v[0][i] = total;
      if (i < kFin) st(t_at(i), total);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 2 * kFin; ++i)
#pragma unroll
      for (int d = 0; d < kWgD; ++d) {
        v[d][i] = term(d, i, pick(scales, kWgD + d));
        if (i >= kFin) st(p_at(d, i - kFin), v[d][i]);
      }
  }
  __syncthreads();
  if (h == 0) {
    float p[kWgD][kFin];
#pragma unroll
    for (int i = 0; i < kFin; ++i)
#pragma unroll
      for (int d = 0; d < kWgD; ++d) p[d][i] = ld(p_at(d, i));
#pragma unroll
    for (int i = 0; i < kFin; ++i) {
      float total = v[0][kFin + i];
#pragma unroll
      for (int d = 0; d < kWgD; ++d) total = __fadd_rn(total, p[d][i]);
      finish(kFin + i, total);
    }
  } else {
    float t[kFin];
#pragma unroll
    for (int i = 0; i < kFin; ++i) t[i] = ld(t_at(i));
#pragma unroll
    for (int i = 0; i < kFin; ++i) {
      float total = t[i];
#pragma unroll
      for (int d = 0; d < kWgD; ++d) total = __fadd_rn(total, v[d][i]);
      finish(i, total);
    }
  }
  __syncthreads();
  store_rows<kRowTile, kThreads>(g, k, rt, lane0, 0, out);
}

// The CTA's output tile (c: 64 rows of block k, kLanes lanes from
// c.lane0) from planes int8[kD, P, R, K] (each 32-tap group permuted,
// above), bias f32[P, R] and the kD digit scales.  Launch with kThreads
// threads and kSmemBytes of dynamic shared memory; K % 16 == 0 and the
// planes 16-byte aligned.
template <int kD, bool kDigits = digit_split(kD)>
__device__ __forceinline__ void fir_tile(const Launch& g, const Tile& c,
                                         const int8_t* __restrict__ planes,
                                         const float* __restrict__ bias,
                                         float4 scales) {
  static_assert(kD >= 1 && kD <= kMaxDigits, "digits");
  static_assert(!kDigits || kD % 2 == 0, "the warpgroups' digits are even");
  // a warpgroup's digits and accumulator registers a dot
  constexpr int kWgD = kDigits ? kD / 2 : kD;
  constexpr int kRegs = kDigits ? kRowTile / 2 : kAcc;
  extern __shared__ uint8_t int8_smem[];
  const uint32_t ring = (smem_addr(int8_smem) + 127) & ~127u;
  const int tid = threadIdx.x, h = tid / 128;
  const int w = (tid % 128) / 32, l = tid % 32;
  const int wg_row = h * kN;  // this warpgroup's rows (the row split)
  // its B tiles in a stage: its digits' whole tiles, or its rows of each
  const uint32_t wg_b =
      kDigits ? h * kWgD * kSub * kTileBytes : (wg_row / 8) * 256;

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

  int acc[2 * kWgD][kRegs];
#pragma unroll
  for (int j = 0; j < 2 * kWgD; ++j)
#pragma unroll
    for (int i = 0; i < kRegs; ++i) acc[j][i] = 0;
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
      for (int d = 0; d < kWgD; ++d) {
        const uint64_t b =
            descriptor(buf + (d * kSub + j) * kTileBytes + wg_b);
        mma(acc[2 * d], xh[j], b, accumulate);
        mma(acc[2 * d + 1], xl[j], b, accumulate);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // later stages' copies run while this stage's wgmmas do
      if (j == 0) copy_stage(s + kLead);
    }
    stage_ready();
  }
  // the first ring buffer takes the output tile, the second the partial
  // sums: no copy is in flight
  if constexpr (kDigits)
    store_tile_digits<kD>(g, c.k, c.rt, c.lane0, acc,
                          bias + (size_t)c.m * g.R + c.rt * kRowTile, scales,
                          stage_at(1), ring, [] {});
  else
    store_tile<kD, kN, true>(g, c.k, c.rt, c.m, c.lane0, wg_row, acc, bias,
                             0, scales, ring);
}

// Rows of a tile a resident warpgroup sums: all 64 (m64n64k32, 32
// registers a dot) where its 2*kD accumulators fit beside the rest, else
// 32.  At kD = 3 they fit (255 registers, no spill) only without the
// 2-byte x path, whose eight loads are live beside them (kVec: every x
// row 16-byte aligned, B % 8 == 0).
template <int kD, bool kVec>
__host__ __device__ constexpr int resident_rows() {
  return kD <= 2 || (kD == 3 && kVec) ? kRowTile : kN;
}

// The resident CTA of phase m, row tile rt (64 rows): output tiles item0 ..
// item0 + n_items - 1 of its work list, item i being block m + P * (i /
// lane_tiles) (patch origin v_m + (i / lane_tiles) * S) and lane tile i %
// lane_tiles (kLanes lanes).  All threads copy the band; then each
// warpgroup runs on its own, with its own x ring, output buffer and named
// barrier (1 + h), so one warpgroup's epilogue and waits overlap the
// other's wgmmas: at 64 rows a warpgroup (resident_rows) warpgroup h
// takes the items h, h + 2, ..., all rows; at 32 it takes every item,
// rows 32h .. 32h + 31 (each warpgroup copies the x it reads).  kVec: x
// rows by 16-byte cp.async (B % 8 == 0, hist and x 16-byte aligned), else
// 2-byte loads.  Planes
// int8[kD, P, R, K] (each 32-tap group permuted, above), bias f32[P, R],
// the kD digit scales; the band spans at most max_slices K-slices in any
// row tile (the host's, from the tap table; a longer band traps).  Launch
// with kThreads threads and resident_smem<kD>(max_slices) bytes of dynamic
// shared memory; K % 32 == 0 and the planes 16-byte aligned.
template <int kD, bool kVec>
__device__ __forceinline__ void fir_tile_resident(
    const Launch& g, int m, int rt, int item0, int n_items, int lane_tiles,
    int v_m, int S, const int8_t* __restrict__ planes,
    const float* __restrict__ bias, float4 scales, int max_slices) {
  static_assert(kD >= 1 && kD <= kMaxDigits, "digits");
  static_assert(kRing >= 2, "a copy refills the previous stage's buffer");
  constexpr int kWgN = resident_rows<kD, kVec>();
  constexpr int kRegs = kWgN / 2;                  // registers a dot
  constexpr bool kSplit = kWgN == kRowTile;        // tiles split by warpgroup
  constexpr int kWgThreads = kThreads / 2;
  extern __shared__ uint8_t int8_smem[];
  const int tid = threadIdx.x, h = tid / kWgThreads;
  const int wt = tid % kWgThreads, w = wt / 32, l = tid % 32;
  const int r0 = kSplit ? 0 : h * kWgN;  // this warpgroup's first row
  const int n_rt = g.R / kRowTile;
  const int t_lo = g.taps[(m * n_rt + rt) * 2];
  const int t_hi = g.taps[(m * n_rt + rt) * 2 + 1];
  const int t_begin = t_lo & ~(kK - 1);
  const int n_slices = t_hi > t_begin ? (t_hi - t_begin + kK - 1) / kK : 0;
  if (n_slices > max_slices) __trap();
  const int n_st = (n_slices + kSub - 1) / kSub;  // x stages an output tile
  // this warpgroup's items: item0 + first + step * i, i < n_mine
  const int first = kSplit ? h : 0, step = kSplit ? 2 : 1;
  const int n_mine = kSplit ? (n_items - h + 1) / 2 : n_items;
  const int n_total = n_mine * n_st;
  const uint32_t band = (smem_addr(int8_smem) + 127) & ~127u;
  const uint32_t rings = band + kD * max_slices * kTileBytes;
  const uint32_t ring = rings + h * kRing * kRawBytes;
  const uint32_t out = rings + 2 * kRing * kRawBytes + h * kOutBytes;
  const uint32_t bias_smem = rings + 2 * (kRing * kRawBytes + kOutBytes);
  // This thread's ldmatrix row (load_split).
  const uint32_t frag = (8 * (l / 16) + l % 8) * kRawPitch +
                        (16 * w + 8 * ((l / 8) % 2)) * 2;

  // The band: digit d's [64 rows x 32 taps] tile of K-slice i at (d *
  // n_slices + i) * kTileBytes; copy e takes 16-byte chunk cc of tile row
  // n's band in plane d (neighbouring threads, neighbouring chunks).
  auto copy_band = [&]() {
    constexpr int kHalves = kK / 16;        // 16-byte chunks a K-slice row
    const int per_row = kHalves * n_slices;
    const size_t plane = (size_t)g.P * g.R * g.K;
    const int8_t* src = planes + ((size_t)m * g.R + rt * kRowTile) * g.K;
    for (int e = tid; e < kD * kRowTile * per_row; e += kThreads) {
      const int cc = e % per_row, n = e / per_row % kRowTile;
      const int d = e / (per_row * kRowTile);
      const int t = t_begin + cc * 16;
      const int bytes = min(max(g.K - t, 0), 16);
      copy16(band + (d * n_slices + cc / kHalves) * kTileBytes +
                 core_offset(n, cc % kHalves),
             bytes ? src + d * plane + (size_t)n * g.K + t : planes, bytes);
    }
  };
  // stage q of this warpgroup's walk (its output tile q / n_st, that
  // tile's stage q % n_st): one cp.async group, empty past the walk; the x
  // rows of a K-slice past the band are not copied
  auto copy_stage = [&](int q) {
    if (q < n_total) {
      const int item = item0 + first + step * (q / n_st), s = q % n_st;
      const int v = v_m + item / lane_tiles * S + t_begin + s * kStageTaps;
      const int lane0 = item % lane_tiles * kLanes;
      const uint32_t buf = ring + q % kRing * kRawBytes;
#pragma unroll
      for (int r = 0; r < kStageTaps * kLanes / 8 / kWgThreads; ++r) {
        const int i = wt + r * kWgThreads, tap = i / (kLanes / 8);
        const int lane = (i % (kLanes / 8)) * 8;
        if (s * kStageTaps + tap < n_slices * kK)
          copy_x8(g, v + tap, lane0 + lane, kVec,
                  buf + tap * kRawPitch + lane * 2, planes);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  // this thread's copies of the next stage have landed; then the
  // warpgroup's, visible to its ldmatrix.  The first wait also takes the
  // band and the biases (in the first group): every thread's, fenced for
  // the tensor cores (the async proxy), across the CTA.
  auto stage_ready = [&](bool first_wait) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kRingLead - 1) : "memory");
    if (first_wait) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
    } else {
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + h), "n"(kWgThreads)
                   : "memory");
    }
  };

  int acc[2 * kD][kRegs];
#pragma unroll
  for (int j = 0; j < 2 * kD; ++j)
#pragma unroll
    for (int i = 0; i < kRegs; ++i) acc[j][i] = 0;
  // the row tile's biases and band, and this warpgroup's first stages
  if (tid < kRowTile / 4)
    copy16(bias_smem + tid * 16,
           bias + (size_t)m * g.R + rt * kRowTile + tid * 4, 16);
  copy_band();
#pragma unroll
  for (int q = 0; q < kRingLead; ++q) copy_stage(q);
  stage_ready(true);
  uint32_t xh[2][4], xl[2][4];
  const uint32_t w_row = band + (r0 / 8) * 256;
#pragma unroll 1
  for (int it = 0; it < n_mine; ++it) {
#pragma unroll 1
    for (int s = 0; s < n_st; ++s) {
      const int q = it * n_st + s;
      const uint32_t buf = ring + q % kRing * kRawBytes;
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const int slice = s * kSub + j;
        // a tile's last stage stops at the band's end (uniform)
        if (j > 0 && slice >= n_slices) break;
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        pin(xh[j]);
        pin(xl[j]);
        load_split(buf + j * kK * kRawPitch + frag, xh[j], xl[j]);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int d = 0; d < kD; ++d) {
          const uint64_t b =
              descriptor(w_row + (d * n_slices + slice) * kTileBytes);
          mma(acc[2 * d], xh[j], b, slice > 0);
          mma(acc[2 * d + 1], xl[j], b, slice > 0);
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        // the buffer of stage q - 1 takes stage q + kRingLead: every
        // thread's ldmatrix of it ended before the last barrier
        if (j == 0) copy_stage(q + kRingLead);
      }
      stage_ready(false);
    }
    // store_tile waits for every wgmma, so the next tile's first slice
    // may rebuild fragment set 0 even after an odd band
    const int item = item0 + first + step * it;
    store_tile<kD, kWgN, false>(g, m + g.P * (item / lane_tiles), rt, m,
                                item % lane_tiles * kLanes, r0, acc, bias,
                                bias_smem, scales, out);
  }
}

// The K-slices each tile of a band walks: from its tap table entry's lo
// rounded down to 32 to its hi, 1 where the entry is empty.
__device__ __forceinline__ int band_width(const int32_t* entry) {
  const int lo = entry[0] & ~(kK - 1), hi = entry[1];
  return hi > lo ? (hi - lo + kK - 1) / kK : 1;
}

// A resident walk's run (fir_tiles here, fixedtc::fir_tiles) of CTA c =
// blockIdx.x of G = gridDim.x: the
// items [first, last) of the band-major order whose work starts in [c W /
// G, (c + 1) W / G), an item of band b weighing its K-slices s_b
// (band_width of tap table entry b, b = m * row_tiles + rt), W = per_band *
// sum_b s_b: the first item of a run at work t is b * per_band + ceil((t -
// per_band * S_b) / s_b) for the band b with per_band * S_b < t <=
// per_band * S_(b+1), S_b = s_0 + ... + s_(b-1) (0 at t = 0).  So the
// CTAs' runs take as many K-slices, give or take one item, where the
// bands' widths differ (a run may be empty).  Each thread sums a chunk of
// the bands; a block scan gives each chunk's S, and the chunk holding t
// writes the bound to `scratch` (48 bytes of shared memory, free), which
// every thread reads back.
__device__ __forceinline__ void balanced_run(const Launch& g, int row_tiles,
                                             int per_band, uint32_t scratch,
                                             int& first, int& last) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n_bands = g.P * row_tiles;
  const int chunk = (n_bands + kThreads - 1) / kThreads;
  const int b0 = min(tid * chunk, n_bands), b1 = min(b0 + chunk, n_bands);
  int own = 0;
  for (int b = b0; b < b1; ++b) own += band_width(g.taps + 2 * b);
  int incl = own;  // the inclusive scan of the warp's chunks
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31)
    asm volatile("st.shared.s32 [%0], %1;\n" ::"r"(scratch + warp * 4),
                 "r"(incl)
                 : "memory");
  __syncthreads();
  int before = incl - own, total = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    int t;
    asm volatile("ld.shared.s32 %0, [%1];\n"
                 : "=r"(t)
                 : "r"(scratch + w * 4)
                 : "memory");
    before += w < warp ? t : 0;
    total += t;
  }
  const long long work = (long long)per_band * total;
  const int c = blockIdx.x, n_ctas = gridDim.x;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const long long t = (long long)(c + e) * work / n_ctas;
    long long at = (long long)per_band * before;
    if (t <= at || t > at + (long long)per_band * own) continue;
    int b = b0, s = band_width(g.taps + 2 * b);
    for (; t > at + (long long)per_band * s;
         at += (long long)per_band * s, s = band_width(g.taps + 2 * ++b)) {
    }
    const int item = b * per_band + (int)((t - at + s - 1) / s);
    asm volatile("st.shared.s32 [%0], %1;\n" ::"r"(scratch + 32 + e * 4),
                 "r"(item)
                 : "memory");
  }
  __syncthreads();
  int bound[2];
#pragma unroll
  for (int e = 0; e < 2; ++e)
    asm volatile("ld.shared.s32 %0, [%1];\n"
                 : "=r"(bound[e])
                 : "r"(scratch + 32 + e * 4)
                 : "memory");
  first = c == 0 ? 0 : bound[0];
  last = bound[1];
}

// The persistent walk of a digit split (kD even; K2b's where the launch
// takes it, streamed_fir.cu): output tiles (block k, row tile rt, lane tile
// lt of kLanes lanes), n_items = n_kr * lane_tiles of them, in band-major
// order: band (m, rt) = (phase, row tile) the slowest, then the n_blocks /
// P blocks k = m + P * j, then the lane tiles (item i: band b = i /
// per_band, m = b / row tiles, rt = b % row tiles, j = i % per_band /
// lane_tiles, lt = i % lane_tiles; per_band = n_blocks / P * lane_tiles).
// CTA c walks a contiguous run of them, balanced by K-slices
// (balanced_run), min(tiles, SMs) CTAs.  Each tile is fir_tile's: the same
// wgmmas, the same exact int32 sums over its band (K-slices from t_lo
// rounded down to 32 until t_hi is covered; one K-slice of zero weights
// where the entry is empty, whose sums are exact zeros, as fir_tile's
// unwalked ones), the same digit-split epilogue (store_tile_digits), so
// the outputs are fir_tile's bit for bit.
//
// The band is resident: the CTA holds its band's kD digit planes (digit
// d's [64 rows x 32 taps] tile of K-slice i at (d * slices + i) *
// kTileBytes, in the layout the descriptor reads) and the row tile's 64
// biases in shared memory, and its stages hold x alone.  One band buffer
// (at q10, D = 4, a 12-slice band is 96 KB: two would not fit beside the
// ring): the walk loads the next band where its run enters it, once the
// last tile of the band before has retired its wgmmas (store_tile_digits'
// freed(), after its first barrier), so the copy runs behind that tile's
// epilogue; the biases alternate between two slots, as that epilogue still
// reads the old ones.  The next tile's first stage then waits for every
// copy (cp.async.wait_all): the switch is exposed but for the epilogue,
// ~2.7 % of the launch at q10.  Refilling the buffer K-slice by K-slice
// behind the last tile's walk instead ran ~4 % slower (its branch in the
// walk's loop cost more than the copies it hid; PERF.md).
// The copy cursor (the tile and stage the next copy_next takes) runs
// kTileLead stages ahead of the walk and on into the next tiles, one group
// a stage, into a ring of kTileLead + 2 x stages: the buffer of stage q +
// kTileLead is stage q - 2's, whose last ldmatrix ended before stage q -
// 1's barrier.  x rows of a K-slice past the band are not copied.  The
// output tile and the exchange have buffers of their own, so the copies
// in flight go on through the epilogue.  Launch with kThreads threads and
// tiles_smem<kD>(band_cap) bytes of dynamic shared memory, band_cap the
// widest band's K-slices (a wider band traps); K % 32 == 0 and the planes
// 16-byte aligned.
template <int kD>
__device__ __forceinline__ void fir_tiles(const Launch& g, Origin o, int n_kr,
                                          int lane_tiles, int band_cap,
                                          const int8_t* __restrict__ planes,
                                          const float* __restrict__ bias,
                                          float4 scales) {
  static_assert(digit_split(kD) && kD <= kMaxDigits, "the digits pair up");
  constexpr int kWgD = kD / 2;                // digits a warpgroup
  constexpr int kXStages = kTileLead + 2;
  extern __shared__ uint8_t int8_smem[];
  const uint32_t base = smem_addr(int8_smem);
  const uint32_t ring = (base + 127) & ~127u;
  const uint32_t out = ring + kXStages * kRawBytes;
  const uint32_t part = out + kOutBytes;
  const uint32_t heads = part + exchange_bytes(kD);   // two bias slots
  const uint32_t band = heads + 2 * kRowTile * 4;
  const int tid = threadIdx.x, h = tid / 128;
  const int w = (tid % 128) / 32, l = tid % 32;
  const int row_tiles = g.R / kRowTile;
  const int per_band = n_kr / row_tiles / g.P * lane_tiles;
  // this CTA's items [first, last) (the output tile's buffer is free for
  // balanced_run's scratch)
  int first, last;
  balanced_run(g, row_tiles, per_band, out, first, last);
  const bool vec = g.B % 8 == 0 &&
                   (reinterpret_cast<uintptr_t>(g.hist) |
                    reinterpret_cast<uintptr_t>(g.x)) % 16 == 0;
  // This thread's ldmatrix row (load_split).
  const uint32_t frag = (8 * (l / 16) + l % 8) * kRawPitch +
                        (16 * w + 8 * ((l / 8) % 2)) * 2;

  // item -> (block k, row tile rt, lane tile lt)
  auto decode = [&](int item, int& k, int& rt, int& lt) {
    const int b = item / per_band, r = item - b * per_band;
    const int m = b / row_tiles, j = r / lane_tiles;
    rt = b - m * row_tiles;
    lt = r - j * lane_tiles;
    k = m + g.P * j;
  };
  // Band b's biases into slot `slot` and its K-slices of the kD planes
  // into the band buffer, one cp.async group (copy e takes 16-byte chunk
  // cc of band row n's slices in plane d: neighbouring threads,
  // neighbouring chunks); returns its K-slices.
  auto load_band = [&](int b, int slot) {
    const int m = b / row_tiles, rt = b - m * row_tiles;
    const int t0 = g.taps[2 * b] & ~(kK - 1), hi = g.taps[2 * b + 1];
    const int slices = hi > t0 ? (hi - t0 + kK - 1) / kK : 1;
    if (slices > band_cap) __trap();
    if (tid < kRowTile / 4)
      copy16(heads + slot * kRowTile * 4 + tid * 16,
             bias + (size_t)m * g.R + rt * kRowTile + tid * 4, 16);
    constexpr int kHalves = kK / 16;        // 16-byte chunks a K-slice row
    const int per_row = kHalves * slices;
    const size_t plane = (size_t)g.P * g.R * g.K;
    const int8_t* src = planes + ((size_t)m * g.R + rt * kRowTile) * g.K;
    for (int e = tid; e < kD * kRowTile * per_row; e += kThreads) {
      const int cc = e % per_row, n = e / per_row % kRowTile;
      const int d = e / (per_row * kRowTile);
      const int t = t0 + cc * 16;
      const int bytes = min(max(g.K - t, 0), 16);
      copy16(band + (d * slices + cc / kHalves) * kTileBytes +
                 core_offset(n, cc % kHalves),
             bytes ? src + d * plane + (size_t)n * g.K + t : planes, bytes);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    return slices;
  };

  // The copy cursor: tile c_item, stage c_s of its c_n, its band c_slices
  // K-slices from virtual row c_v, its lanes from c_lane0; ring stage c_q.
  int c_item = first, c_s = 0, c_n = 0, c_slices = 0, c_v = 0, c_lane0 = 0;
  int c_q = 0;
  // the cursor's stage into ring buffer c_q % kXStages: one cp.async
  // group, empty past the CTA's last tile
  auto copy_next = [&]() {
    if (c_item < last) {
      if (c_s == 0) {  // enters tile c_item
        int k, rt, lt;
        decode(c_item, k, rt, lt);
        const int32_t* e = g.taps + ((k % g.P) * row_tiles + rt) * 2;
        const int t0 = e[0] & ~(kK - 1), hi = e[1];
        c_slices = hi > t0 ? (hi - t0 + kK - 1) / kK : 1;
        c_n = (c_slices + kSub - 1) / kSub;
        c_v = origin(g, o, k) + t0;
        c_lane0 = lt * kLanes;
      }
      const uint32_t buf = ring + (c_q % kXStages) * kRawBytes;
      // the stage's taps inside the band
      const int taps = c_slices * kK - c_s * kStageTaps;
#pragma unroll
      for (int r = 0; r < kStageTaps * kLanes / 8 / kThreads; ++r) {
        const int i = tid + r * kThreads, tap = i / (kLanes / 8);
        const int lane = (i % (kLanes / 8)) * 8;
        if (tap < taps)
          copy_x8(g, c_v + c_s * kStageTaps + tap, c_lane0 + lane, vec,
                  buf + tap * kRawPitch + lane * 2, planes);
      }
      if (++c_s == c_n) {
        ++c_item;
        c_s = 0;
      }
    }
    ++c_q;
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  // this thread's copies of the next stage have landed; then every
  // thread's, visible to the tensor cores and to ldmatrix
  auto stage_ready = [&]() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kTileLead - 1) : "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
  };

  int acc[kD][32];
#pragma unroll
  for (int j = 0; j < kD; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[j][i] = 0;
  // the first band (the walk's band b_cur, its K-slices, its bias slot),
  // then the first stages
  int b_cur = first / per_band, slot = 0;
  int slices = first < last ? load_band(b_cur, slot) : 0;
#pragma unroll 1
  for (int s = 0; s < kTileLead; ++s) copy_next();
  stage_ready();
  uint32_t xh[2][4], xl[2][4];
  int q = 0;  // the walk's stage
#pragma unroll 1
  for (int item = first; item < last; ++item) {
    int k, rt, lt;
    decode(item, k, rt, lt);
    const int n_stages = (slices + kSub - 1) / kSub;
    // this warpgroup's digits' tiles of the band's first K-slice
    const uint32_t wband = band + h * kWgD * slices * kTileBytes;
#pragma unroll 1
    for (int s = 0; s < n_stages; ++s, ++q) {
      const uint32_t buf = ring + (q % kXStages) * kRawBytes;
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const int slice = s * kSub + j;
        // the last stage stops at the band's end (uniform over the CTA)
        if (j > 0 && slice >= slices) break;
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        pin(xh[j]);
        pin(xl[j]);
        load_split(buf + j * kK * kRawPitch + frag, xh[j], xl[j]);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int d = 0; d < kWgD; ++d) {
          const uint64_t b =
              descriptor(wband + (d * slices + slice) * kTileBytes);
          mma(acc[2 * d], xh[j], b, slice > 0);
          mma(acc[2 * d + 1], xl[j], b, slice > 0);
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        // later stages' copies, the next tiles' too, run while this
        // stage's wgmmas do
        if (j == 0) copy_next();
      }
      stage_ready();
    }
    // the run's next tile in another band: its band is loaded once this
    // tile's wgmmas have read the old one, behind the epilogue
    const bool enters = item + 1 < last && (item + 1) / per_band != b_cur;
    const float* bias_m = reinterpret_cast<const float*>(
        int8_smem + (heads + slot * kRowTile * 4 - base));
    store_tile_digits<kD>(g, k, rt, lt * kLanes, acc, bias_m, scales, part,
                          out, [&] {
                            if (enters) {
                              slot ^= 1;
                              slices = load_band(++b_cur, slot);
                            }
                          });
    if (enters) {
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
    }
  }
  // no copy group may be in flight when the CTA exits
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Lets an int8 kernel take `bytes` of dynamic shared memory (fir_tile's
// kSmemBytes by default; a resident kernel's launches differ by band, so
// it takes kMaxSmem, as does K2b's where fir_tiles serves it).
template <typename Kernel>
inline cudaError_t allow_smem(Kernel* kernel, int bytes = kSmemBytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace int8tc
}  // namespace fir
