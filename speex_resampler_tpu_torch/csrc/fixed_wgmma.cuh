// Scheme "fixed" (the Q15 universe) on Hopper's int8 tensor cores: the
// device functions of streamed_fir_fixed_kernel<kAccum, kBlockMajor> (both
// phase-tiled geometries: fir_tiles, persistent CTAs, at n_accum 4;
// fir_tile, one tile a CTA, at n_accum 1) and dense_fir_fixed_kernel<kAccum>
// (fir_tile) (sm_90a only).  fir_tile takes a fir::Tile, so one body
// serves every geometry.
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
// fir_tiles' resident walk holds a (phase, row tile)'s planes in shared
// memory instead, as int8_wgmma.cuh's fir_tile_resident does, and its
// stages hold x alone.
//
// What bounds it: the tensor cores.  At 48 kHz -> 44.1 kHz q10 (B = 2048,
// n_accum 4) the function needs 43.2 G int16 multiply-adds, four int8
// products each: 345 G operations, 0.17 ms at the 1,979 TOP/s peak,
// above the ~0.06 ms of its ~194 MB.  On the CUDA cores (IMAD, 64 a clock
// an SM) the 44.5 G multiply-adds the tiles walk take >= 2.7 ms.  The
// streamed walk's stage copies held it (2.2 GB a q10 launch at ~2.3-2.8
// TB/s); the resident walk copies 0.74 GB there and runs 0.61 against
// 0.89 ms a launch in a CUDA graph (PERF.md section 6).
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
  // The phase-tiled launch: persistent CTAs (fir_tiles), else one tile a
  // CTA (fir_tile).  At n_accum 1 the next tile's state spills under the
  // 128-register cap of 2 CTAs an SM, so it keeps one tile a CTA.
  static constexpr bool kPersistent = kAccum == 4;
  // fir_tiles: copies kTileLead stages ahead across its tiles, in a ring
  // of kTileLead + 2; each tile's epilogue inputs (kEpiBytes: its
  // descriptor, kAccum * kRows biases and, at n_accum 4, as many coefs) in
  // one of kTileLead + 1 slots; the output tile in a buffer of its own.
  static constexpr int kTileLead = 6;
  static constexpr int kBiases = kAccum * kRows;
  static constexpr int kEpiBytes = 16 + (kAccum == 4 ? 2 : 1) * kBiases * 4;
  static constexpr int kOutBytes = kRows * kRawPitch;
  static constexpr int kTilesSmemBytes = (kTileLead + 2) * kStageBytes +
                                         (kTileLead + 1) * kEpiBytes +
                                         kOutBytes + 128;
  // fir_tiles' resident walk: a band buffer holds a (phase, row tile)'s
  // biases and coefs (kBandHead bytes), then its K-slices, the two planes'
  // tiles of a K-slice side by side (kSliceBytes); a stage holds x alone
  static constexpr int kBandHead = (kEpiBytes - 16 + 127) / 128 * 128;
  static constexpr int kSliceBytes = 2 * kTileBytes;
  static constexpr int kXStageBytes = (kRawBytes + 127) / 128 * 128;
  // the ring of x stages, the output tile, the 16-byte tile descriptors
  // and two band buffers of `slices` K-slices
  __host__ __device__ static constexpr int resident_smem(int slices) {
    return (kTileLead + 2) * kXStageBytes + kOutBytes +
           ((kTileLead + 1) * 16 + 127) / 128 * 128 +
           2 * (kBandHead + slices * kSliceBytes) + 128;
  }
  // the dynamic shared memory of the phase-tiled launch (the resident walk
  // asks for resident_smem of its band)
  static constexpr int kLaunchSmemBytes =
      kPersistent ? kTilesSmemBytes : kSmemBytes;
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

// 4-byte asynchronous copy (cp.async.ca: a 4-byte copy needs only its
// int32 alignment).
__device__ __forceinline__ void copy4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// The resident walk's balanced runs (int8_wgmma.cuh, shared with K2b's).
using int8tc::balanced_run;

// A persistent CTA's output tiles, below n_items = n_kr * lane_tiles (G =
// gridDim.x CTAs).  Each tile is fir_tile's, with the same sums and
// epilogue, so the outputs are its own bit for bit, in either walk; R %
// Shape::kRows == 0, every row is stored.
//
// The streamed walk (kResident false): items blockIdx.x, blockIdx.x + G,
// ..., item i being (block, row tile) kr and lane tile lt: kr = i % n_kr,
// lt = i / n_kr where kBlockMajor, else kr = i / lane_tiles, lt = i %
// lane_tiles (the one-tile launch's CTA order); block k = kr / row tiles,
// row tile kr % row tiles, phase k % P, patch origin origin(g, o, k).  A
// stage holds the two planes' tiles of two K-slices and their x rows.
//
// The resident walk (kResident): the items in band-major order, band
// (m, rt) = (phase, row tile) the slowest, then the n_blocks / P blocks k
// = m + P * j, then the lane tiles (item i: band b = i / per_band, m = b /
// row tiles, rt = b % row tiles, j = i % per_band / lane_tiles, lt = i %
// lane_tiles; per_band = n_blocks / P * lane_tiles, the tiles that share
// a band); CTA c walks a contiguous run of them, balanced by K-slices
// (balanced_run).  Where the copy cursor enters a band it copies the band's
// K-slices of both planes (in the layout the descriptor reads) and its
// biases and coefs into the next of two band buffers, with that stage's
// group, once; the wgmmas read their B operand there, and a stage holds x
// alone.  Band buffer b % 2 of the CTA's b-th band was last read by band
// b - 2, whose tiles are walked before the cursor enters band b: the
// cursor runs kTileLead stages ahead, and a band between two others is
// whole, per_band tiles of one stage or more, so the launcher takes this
// walk only where per_band >= kTileLead and both buffers of its widest
// band (band_cap K-slices; a wider band traps) fit shared memory.
//
// One ring of kTileLead + 2 stage buffers serves the CTA's whole sequence
// of stages: the copy cursor (the tile and stage the next copy_next
// takes) runs kTileLead stages ahead of the walk and on into the next
// tiles, so the next tile's first stages are in flight while a tile's
// last ones are walked and its epilogue runs.  Where the cursor enters a
// tile it computes the tile's origin and tap band (the tap table entry
// loaded one tile before, so no load waits); in the streamed walk it
// copies the tile's biases and coefs into the tile's epilogue slot with
// that stage's group.  Thread 0 writes the tile's descriptor in its slot
// (K-slices, first output row, first lane, the address of its biases and
// coefs: in the slot, or in its band buffer, whose K-slices follow them).
// x rows of a K-slice past the tile's band are not copied.  The epilogue
// is fir_tile's, its biases and coefs read from shared memory (an 8-byte
// load gives two rows'), its int16 tile leaving through a buffer of its
// own, so the copies in flight go on.  Slot t % (kTileLead + 1) of the
// CTA's t-th tile is written kTileLead + 1 tiles later, once its epilogue
// has read it: every tile walks at least one stage (a tile whose columns
// are all zero walks one K-slice of zero weights, whose sums are exact
// zeros), so the cursor is at most kTileLead tiles ahead.  Launch with
// kThreads threads and Shape::kTilesSmemBytes (streamed) or
// Shape::resident_smem(band_cap) bytes of dynamic shared memory; K % 32 ==
// 0 and the planes 16-byte aligned.  Each walk is its own instance, so
// neither pays for the other's choices at run time.  The resident walk
// tells `witness` its run (run(first, last), every thread, once) and each
// band it enters (band(), every thread); the served kernel's NoWitness
// does nothing, a test build's records what the walk did.
struct NoWitness {
  __device__ __forceinline__ void run(int, int) const {}
  __device__ __forceinline__ void band() const {}
};
template <int kAccum, bool kBlockMajor, bool kResident,
          class Witness = NoWitness>
__device__ __forceinline__ void fir_tiles(const Launch& g, Origin o,
                                          int n_kr, int lane_tiles,
                                          int band_cap,
                                          const int8_t* __restrict__ planes,
                                          const int32_t* __restrict__ bias,
                                          const int32_t* __restrict__ coef,
                                          Witness witness = {}) {
  using Sh = Shape<kAccum>;
  constexpr int kLead = Sh::kTileLead;
  constexpr int kStages = kLead + 2;
  constexpr int kSlots = kLead + 1;
  extern __shared__ uint8_t fixed_smem[];
  // a stage's bytes, and where its x rows start in it
  const int stage_bytes = kResident ? Sh::kXStageBytes : Sh::kStageBytes;
  const int x_at = kResident ? 0 : Sh::kWBytes;
  const int slot_bytes = kResident ? 16 : Sh::kEpiBytes;
  const int band_bytes = Sh::kBandHead + band_cap * Sh::kSliceBytes;
  const uint32_t ring = (smem_addr(fixed_smem) + 127) & ~127u;
  const uint32_t out = ring + kStages * stage_bytes;
  const uint32_t epi = out + Sh::kOutBytes;
  const uint32_t bands = epi + (kSlots * 16 + 127) / 128 * 128;
  const int tid = threadIdx.x, h = tid / 128;
  const int w = (tid % 128) / 32, l = tid % 32;
  const int C = kAccum * g.R;
  const int row_tiles = g.R / Sh::kRows;
  const int n_items = n_kr * lane_tiles;
  const int n_ctas = gridDim.x;
  const int per_band = n_kr / row_tiles / g.P * lane_tiles;
  // this CTA's items: first, first + stride, ... below last (the output
  // tile's buffer is free for balanced_run's scratch)
  int first = blockIdx.x, last = n_items;
  if constexpr (kResident) {
    balanced_run(g, row_tiles, per_band, out, first, last);
    witness.run(first, last);
  }
  const int stride = kResident ? 1 : n_ctas;

  // This thread's weight copies (fir_tile's): 16-byte chunk i % 2 of
  // K-slice (i / 2) % 2 of the CTA's B row n = i / 4, at woff[q] bytes
  // (and the K-slice's first tap) from the tile's first row in a plane.
  const size_t plane = (size_t)g.P * C * g.K;
  int woff[Sh::kWCopies];
  uint32_t wdst[Sh::kWCopies];
  int wt[Sh::kWCopies];
#pragma unroll
  for (int q = 0; q < Sh::kWCopies; ++q) {
    const int i = tid + q * kThreads, n = i / 4;
    const int set = (n % Sh::kN) / Sh::kWgRows;
    const int row = (n / Sh::kN) * Sh::kWgRows + n % Sh::kWgRows;
    wt[q] = (i / 2) % 2 * kK + i % 2 * 16;
    woff[q] = (set * g.R + row) * g.K + wt[q];
    wdst[q] = (i / 2) % 2 * Sh::kTileBytes + int8tc::core_offset(n, i % 2);
  }
  const bool vec = g.B % 8 == 0 &&
                   (reinterpret_cast<uintptr_t>(g.hist) |
                    reinterpret_cast<uintptr_t>(g.x)) % 16 == 0;
  const bool vec_y = g.B % 8 == 0 && reinterpret_cast<uintptr_t>(g.y) % 16 == 0;
  // This thread's ldmatrix row (int8tc::load_split).
  const uint32_t frag = (8 * (l / 16) + l % 8) * kRawPitch +
                        (16 * w + 8 * ((l / 8) % 2)) * 2;

  // item -> (block k, row tile rt, lane tile lt)
  auto decode = [&](int item, int& k, int& rt, int& lt) {
    if constexpr (kResident) {
      const int b = item / per_band, r = item - b * per_band;
      const int m = b / row_tiles, j = r / lane_tiles;
      rt = b - m * row_tiles;
      lt = r - j * lane_tiles;
      k = m + g.P * j;
    } else {
      const int kr = kBlockMajor ? item % n_kr : item / lane_tiles;
      lt = kBlockMajor ? item / n_kr : item % lane_tiles;
      k = kr / row_tiles;
      rt = kr - k * row_tiles;
    }
  };
  auto band = [&](int item) {  // the tap table entry of an item's tile
    int k, rt, lt;
    decode(item, k, rt, lt);
    return g.taps + ((k % g.P) * row_tiles + rt) * 2;
  };

  // The copy cursor: tile c_item (its slot c_slot), stage c_s of its c_n,
  // its band c_slices K-slices; its first weight row c_w, its band's first
  // tap c_t at virtual row c_v, its lanes from c_lane0; the next tile's
  // tap entry n_lo, n_hi; the resident walk's band c_band (m * row tiles
  // + rt) in band buffer c_buf.
  int c_item = first, c_slot = 0, c_s = 0, c_n = 0, c_slices = 0;
  const int8_t* c_w = planes;
  int c_t = 0, c_v = 0, c_lane0 = 0;
  int n_lo = 0, n_hi = 0;
  int c_band = -1, c_buf = 1;
  if (c_item < last) {
    const int32_t* e = band(c_item);
    n_lo = e[0];
    n_hi = e[1];
  }
  // this thread's share (one word) of the biases and coefs of row tile
  // row0 of phase m, to `head`
  auto copy_head = [&](uint32_t head, int m, int row0) {
    if (tid < Sh::kBiases)
      copy4(head + tid * 4, bias + (size_t)m * C + tid / Sh::kRows * g.R +
                                row0 + tid % Sh::kRows);
    else if (kAccum == 4 && tid < 2 * Sh::kBiases)
      copy4(head + tid * 4,
            coef + (size_t)m * 4 * g.R +
                (tid - Sh::kBiases) / Sh::kRows * g.R + row0 +
                (tid - Sh::kBiases) % Sh::kRows);
  };
  // The band of row tile row0 of phase m, K-slices c_t / 32 .. + slices -
  // 1 of both planes, into the band buffer after `head`: K-slice s of
  // plane p at (2s + p) * kTileBytes, copy e taking 16-byte chunk cc of
  // band row n's slices (neighbouring threads, neighbouring chunks).
  auto copy_band = [&](uint32_t head, int m, int row0, int slices) {
    const int per_row = kK / 16 * slices;
    const int8_t* src = planes + ((size_t)m * C + row0) * g.K + c_t;
    for (int e = tid; e < 2 * 2 * Sh::kN * per_row; e += kThreads) {
      const int cc = e % per_row, np = e / per_row;
      const int n = np % (2 * Sh::kN), p = np / (2 * Sh::kN);
      const int set = (n % Sh::kN) / Sh::kWgRows;
      const int row = (n / Sh::kN) * Sh::kWgRows + n % Sh::kWgRows;
      copy16(head + Sh::kBandHead + (2 * (cc / 2) + p) * Sh::kTileBytes +
                 int8tc::core_offset(n, cc % 2),
             src + p * plane + (size_t)(set * g.R + row) * g.K + cc * 16, 16);
    }
  };
  // enters tile c_item: its geometry, epilogue slot and descriptor (and,
  // entering a band, the band), and the tap entry of the tile after it
  auto enter = [&]() {
    int k, rt, lt;
    decode(c_item, k, rt, lt);
    const int m = k % g.P, row0 = rt * Sh::kRows;
    c_t = n_lo & ~(kK - 1);
    c_slices = n_hi > c_t ? (n_hi - c_t + kK - 1) / kK : 1;
    c_n = (c_slices + kSub - 1) / kSub;
    c_s = 0;
    c_w = planes + ((size_t)m * C + row0) * g.K;
    c_v = origin(g, o, k) + c_t;
    c_lane0 = lt * kLanes;
    const uint32_t slot = epi + c_slot * slot_bytes;
    uint32_t head = slot + 16;
    if constexpr (kResident) {
      const bool enters = m * row_tiles + rt != c_band;
      if (enters) {
        if (c_slices > band_cap) __trap();
        c_band = m * row_tiles + rt;
        c_buf ^= 1;
        witness.band();
      }
      head = bands + c_buf * band_bytes;
      if (enters) {
        copy_head(head, m, row0);
        copy_band(head, m, row0, c_slices);
      }
    } else {
      copy_head(head, m, row0);
    }
    if (tid == 0)
      asm volatile("st.shared.v4.s32 [%0], {%1, %2, %3, %4};\n" ::"r"(slot),
                   "r"(c_slices), "r"(k * g.R + row0), "r"(c_lane0),
                   "r"(head)
                   : "memory");
    if (c_item + stride < last) {
      const int32_t* e = band(c_item + stride);
      n_lo = e[0];
      n_hi = e[1];
    }
  };
  // the cursor's stage into ring buffer q % kStages: one cp.async group,
  // empty past the CTA's last tile
  int c_q = 0;
  auto copy_next = [&]() {
    if (c_item < last) {
      if (c_s == 0) enter();
      const uint32_t buf = ring + (c_q % kStages) * stage_bytes;
      const int t0 = c_t + c_s * kStageTaps;
      if constexpr (!kResident) {
#pragma unroll
        for (int q = 0; q < Sh::kWCopies; ++q) {
          const bool in = t0 + wt[q] < g.K;
#pragma unroll
          for (int p = 0; p < 2; ++p)
            copy16(buf + p * kSub * Sh::kTileBytes + wdst[q],
                   in ? c_w + p * plane + woff[q] + t0 : planes,
                   in ? 16 : 0);
        }
      }
      // the stage's taps inside the band
      const int taps = c_slices * kK - c_s * kStageTaps;
#pragma unroll
      for (int r = 0; r < kStageTaps * kLanes / 8 / kThreads; ++r) {
        const int i = tid + r * kThreads, tap = i / (kLanes / 8);
        const int lane = (i % (kLanes / 8)) * 8;
        if (tap < taps)
          copy_x8(g, c_v + c_s * kStageTaps + tap, c_lane0 + lane, vec,
                  buf + x_at + tap * kRawPitch + lane * 2, planes);
      }
      if (++c_s == c_n) {
        c_item += stride;
        c_slot = c_slot + 1 == kSlots ? 0 : c_slot + 1;
        c_s = 0;
      }
    }
    ++c_q;
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
  // fir_tile's epilogue of the tile in acc, its biases and coefs from
  // `head` (CTA row r of set s at word s * kRows + r of each), into `out`:
  // four outputs e = 4g .. 4g + 3 at a time, lanes 16w + l/4 (+ 8) of CTA
  // rows r0 and r0 + 1, so one 8-byte load takes their two biases of a
  // set and one their two coefs.
  auto mix = [&](uint32_t head) {
    const uint32_t bias_s = head, coef_s = bias_s + Sh::kBiases * 4;
#pragma unroll
    for (int g4 = 0; g4 < Sh::kPer / 4; ++g4) {
      const int r0 = h * Sh::kWgRows + 8 * g4 + 2 * (l % 4);
      unsigned mixed[4] = {0, 0, 0, 0};
#pragma unroll
      for (int set = 0; set < kAccum; ++set) {
        unsigned bi[2];
        int co[2] = {0, 0};
        asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
                     : "=r"(bi[0]), "=r"(bi[1])
                     : "r"(bias_s + (set * Sh::kRows + r0) * 4)
                     : "memory");
        if (kAccum == 4)
          asm volatile("ld.shared.v2.s32 {%0, %1}, [%2];\n"
                       : "=r"(co[0]), "=r"(co[1])
                       : "r"(coef_s + (set * Sh::kRows + r0) * 4)
                       : "memory");
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = set * Sh::kPer + 4 * g4 + u;
          const unsigned sum = 65536u * (unsigned)acc[0][i] +
                               256u * (unsigned)acc[1][i] +
                               (unsigned)acc[2][i] + bi[u % 2];
          mixed[u] = kAccum == 1
                         ? sum
                         : mixed[u] + mult16_32_q15(co[u % 2], (int)sum >> 1);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int lane = 16 * w + l / 4 + 8 * (u / 2);
        asm volatile("st.shared.u16 [%0], %1;\n"
                     ::"r"(out + (r0 + u % 2) * kRawPitch + lane * 2),
                     "h"(sat32pshr15((int)mixed[u]))
                     : "memory");
      }
    }
  };
  // the int16 rows of `out` to block rows yrow .. yrow + kRows - 1, lanes
  // from lane0 (lanes past B are not stored)
  auto store = [&](int yrow, int lane0) {
#pragma unroll
    for (int r = 0; r < Sh::kRows * kLanes / 8 / kThreads; ++r) {
      const int chunk = tid + r * kThreads;
      const int row = chunk / (kLanes / 8), cl = chunk % (kLanes / 8) * 8;
      const int lane = lane0 + cl;
      if (lane >= g.B) continue;
      uint32_t v[4];
      asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
                   : "r"(out + row * kRawPitch + cl * 2)
                   : "memory");
      int16_t* dst = g.y + (size_t)(yrow + row) * g.B + lane;
      if (vec_y) {
        *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int b = 0; b < 8; ++b)
          if (lane + b < g.B) dst[b] = (int16_t)(v[b / 2] >> (16 * (b & 1)));
      }
    }
  };

#pragma unroll 1
  for (int s = 0; s < kLead; ++s) copy_next();
  stage_ready();
  uint32_t xh[2][4], xl[2][4];
  int q = 0, slot_i = 0;  // the walk's stage and its tile's slot
  // a K-slice's plane tiles: the second plane's this far from the first
  const int plane_at = kResident ? Sh::kTileBytes : kSub * Sh::kTileBytes;
#pragma unroll 1
  for (int item = first; item < last; item += stride) {
    const uint32_t slot = epi + slot_i * slot_bytes;
    int slices, yrow, lane0;
    uint32_t head;
    asm volatile("ld.shared.v4.s32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(slices), "=r"(yrow), "=r"(lane0), "=r"(head)
                 : "r"(slot)
                 : "memory");
    const int n_stages = (slices + kSub - 1) / kSub;
    // this warpgroup's kN rows of the band's first K-slice
    const uint32_t wband = head + Sh::kBandHead + h * (Sh::kN / 8) * 256;
#pragma unroll 1
    for (int s = 0; s < n_stages; ++s, ++q) {
      const uint32_t buf = ring + (q % kStages) * stage_bytes;
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        // the last stage stops at the band's end (uniform over the CTA)
        if (j > 0 && s * kSub + j >= slices) break;
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        int8tc::pin(xh[j]);
        int8tc::pin(xl[j]);
        int8tc::load_split(buf + x_at + j * kK * kRawPitch + frag, xh[j],
                           xl[j]);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        const int accumulate = s > 0 || j > 0;
        // this warpgroup's kN rows of the plane tiles: K-slice s * kSub + j
        // of the band, or slice j of the stage
        const uint32_t b =
            kResident ? wband + 2 * (s * kSub + j) * Sh::kTileBytes
                     : buf + j * Sh::kTileBytes + h * (Sh::kN / 8) * 256;
        const uint64_t bh = int8tc::descriptor(b);
        const uint64_t bl = int8tc::descriptor(b + plane_at);
        mma(acc[0], xh[j], bh, accumulate);
        mma(acc[1], xl[j], bh, accumulate);
        mma(acc[1], xh[j], bl, 1);
        mma(acc[2], xl[j], bl, accumulate);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        // later stages' copies, the next tiles' too, run while this
        // stage's wgmmas do
        if (j == 0) copy_next();
      }
      stage_ready();
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < 3; ++j) int8tc::pin(acc[j]);
    // the epilogue: `out` was last read before this tile's stage barriers
    mix(head);
    __syncthreads();
    store(yrow, lane0);
    slot_i = slot_i + 1 == kSlots ? 0 : slot_i + 1;
  }
  // no copy group may be in flight when the CTA exits
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Lets a fixed kernel take `bytes` of dynamic shared memory
// (Shape<kAccum>::kSmemBytes, fir_tile's, by default).
template <int kAccum, typename Kernel>
inline cudaError_t allow_smem(Kernel* kernel,
                              int bytes = Shape<kAccum>::kSmemBytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
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
static_assert(Shape<4>::kTilesSmemBytes <= int8tc::kMaxSmem,
              "the persistent CTA's ring fits its shared memory");
static_assert(Shape<4>::kPer % 4 == 0 && Shape<1>::kPer % 4 == 0,
              "fir_tiles' mix: outputs in fours");
static_assert(Shape<4>::kBiases * 2 <= kThreads &&
                  Shape<1>::kBiases <= kThreads,
              "one bias or coef copy a thread");

}  // namespace fixedtc
}  // namespace fir
