// Phase-tiled polyphase FIR launch for Hopper (sm_90a), schemes
// "highest", "int8" (D <= 4 digit planes), "fixed" (n_accum 1 and 4) and
// "split5": the one launcher of both phase-tiled geometries.
//
// Replaces speex_resampler_tpu/ops/pallas_fir.py resample_conv_tm_pallas_v4
// / _kernel_v4 (with _v4_hist_plans), the TPU kernel of the large-P
// configurations (the "streamed" geometry: every 48 kHz -> 44.1 kHz
// conversion, P = 147 weight phases, 38.5 MB of f32 weights at q10, and
// 44.1 kHz -> 16 kHz at q7), and resample_conv_tm_pallas_v3 / _kernel_v3
// (the "tiled" geometry of small weight cycles, 44.1 kHz -> 48 kHz and the
// like), but for v3's "int8" scheme where its band fits shared memory,
// which tiled_fir.cu's resident kernel serves.  Both compute the same
// function: output block k (R rows, all lanes) is
//
//     y_k = epilogue( W[k % P]^T [R, K] @ patch_k [K, B] ),
//     patch_k = rows v0 .. v0+K-1 of the virtual axis hist ++ x,
//     v0      = floor16((f0 + k*R*num) / den + shift)   (in 64 bits),
//
// the closed form of _kernel_v4 (fir_common.cuh's origin), equal to v3's
// (k / P) * S + offsets[k % P], so the two geometries differ only in their
// weights' K (the tiled one's unpadded, or padded to 32 for the int8
// planes; the streamed one's padded to 128 as the JAX package pads it)
// and their chunk rows, both the host's.  The TPU kernels DMA'd each
// block's weights and patch into VMEM; here every CTA reads tap row v0+t
// from hist when v0+t < H, else from x.  The weights are the port's own
// layout [P, K, R] (JAX streams [P, R, K]; the int8 and fixed planes are
// K-major, below); the staging, product and epilogues are the scheme
// headers' (f32_fir.cuh, split5_wgmma.cuh, int8_wgmma.cuh, fixed_wgmma.cuh;
// the int8 resident kernel shares int8_wgmma.cuh's sums and epilogue).
//
// What bounds it on the H100: the multiply-adds.  One 48k->44.1k q10 launch
// at B = 2048 (n_blocks 147, R 128, K 512, filt_len 280) must move ~183 MB
// (x 85 MB, y 77 MB, the nonzero f32 weights 21 MB): ~55 us at 3.35 TB/s;
// it needs 10.8 G multiply-adds (filt_len per output): ~322 us at the
// 33.5 T FMA/s of the CUDA cores in f32; under "int8" 2*D int8 products
// each, 87 us at the 1,979 TOP/s of the int8 tensor cores for D = 4.  The
// 64-row tiles walk 13.4 G of them, each tile's
// nonzero tap band; the "highest" kernel's warps 11.7 G, each 16-row
// sub-band's 8-tap slices (f32_fir.cuh).  The flagship's tiled launch
// (44.1k->48k q7, B = 2048) reads ~38 MB of int16 rows and writes 42 MB,
// ~25 us at 3.35 TB/s, and needs 2.7 G multiply-adds, ~80 us at the f32
// CUDA cores' rate.
// What the TPU design was for (weights too large for VMEM) does not apply:
// the H100 reads weights through its 50 MB L2 either way.  The Hopper risk
// is re-reading them from HBM once per lane tile (16 x 38.5 MB per launch
// at B = 2048).  So where the weight cycle is large (kBlockMajorBytes) the
// grid runs over lane tiles fastest: the CTAs that share block k's weight
// columns are scheduled together, HBM serves each weight tile once and L2
// the other lane tiles (the counterpart of v4's "widest lane tile" rule).
// A smaller cycle (every tiled launch's: <= 4 MB, 6 MB fixed) stays in L2
// across the lane tiles, and its grid runs (block, row tile) fastest,
// lane tiles on grid y: measured 1-12 % faster there.  Each kernel is
// instantiated for both orders (kBlockMajor); the launcher picks one from
// the launch's weight bytes.
//
// Scheme "int8" (K2b) runs on the int8 tensor cores (int8_wgmma.cuh):
// wgmma s8 with xh / xl as the register operand, 2*D exact int32 dots
// summed in one walk of each tile's band, the f32 epilogue of the CUDA-core
// int8 kernel.  Its two warpgroups split an even D's digit planes, each
// summing D/2 of them over the tile's 64 rows at m64n64k32
// (streamed_fir_int8_kernel<D, true>), and an odd D's rows, each summing
// every digit over 32 of them at m64n32k32 (<D, false>): at q10, D = 4,
// 0.643 ms a launch at B = 2048 against 0.719 with the row split, whose
// walk takes as long; the digit split's epilogue is the cheaper (PERF.md).
// Its planes are K-major, int8[D, P, R, K_pad], each 32-tap group permuted
// to the fragment's tap order (JAX streams [P, D, R, K_pad]); its lane
// tile is int8tc::kLanes.  Where the digits pair up, the launch's widest
// (phase, row tile) band fits one band buffer beside the x ring and at
// least int8tc::kTileLead tiles share a band (int8_band_tiles), its CTAs
// are persistent (int8tc::fir_tiles): min(tiles, SMs) of them, each a
// K-slice-balanced run of tiles in band-major order, each band resident
// and x alone staged (q10, D = 4, B = 2048: 0.385 against 0.639 ms
// a launch in a CUDA graph; PERF.md); else a CTA takes one tile, its
// weights staged with x.  A tiled int8 step whose band does not fit the
// resident kernel's shared memory launches it on the same planes.
//
// Scheme "fixed" (K2d, and K1e / K1d at n_accum 4 / 1; the fixed branches
// of v4 and v3: _dot_fixed, then the fixed_math epilogues) runs on the int8
// tensor cores too (fixed_wgmma.cuh): _dot_fixed's four int8 dots and
// bias, all n_accum column sets in one walk.  Its planes are K-major,
// int8[2, P, n_accum * R, K_pad] (wh, wl0; 77 MB at q10, n_accum 4; JAX
// streams [P, 2, C, K_pad]), each 32-tap group permuted as int8's; its CTA
// takes fixedtc::Shape's rows and int8tc::kLanes lanes.  A q10 launch
// needs 43.2 G int16 multiply-adds (filt_len x 4 per output): 345 G int8
// tensor-core operations, ~174 us, above the ~61 us of its bytes, so
// operations bound it.  At n_accum 4 its CTAs are persistent
// (fixedtc::fir_tiles): min(tiles, SMs) of them, with one copy ring that
// runs on across a CTA's tiles, so the next tile's copies are in flight
// through a tile's epilogue (q10, B = 2048: 0.880 against 1.018 ms a
// launch in a CUDA graph, one tile a CTA; PERF.md).  Where the launch's
// widest (phase, row tile) band fits two band buffers and enough tiles
// share a band (resident_band_tiles), each CTA walks a contiguous run of
// tiles in band-major order, holds each band's planes in shared memory
// and stages x alone (q10: 0.61 against 0.89 ms with the weights
// restaged every stage; PERF.md); else it walks every G-th tile of the
// launch's CTA order with the weights streamed beside x.  n_accum 1 (2
// CTAs an SM at 128 registers, where that state spills) keeps one tile a
// CTA.
//
// Scheme "split5" (K2c, and K1c; five bf16 products per multiply-add
// summed in f32) reads bf16 planes [3, P, K_pad, R] (JAX streams [P, 3, R,
// K_pad]).  At 48k->44.1k q10 it needs the 10.8 G multiply-adds of
// "highest": 108 G bf16 tensor-core FLOP, ~0.11 ms, above the ~58 us of its
// bytes, so operations bound it.  It runs on the bf16 tensor cores
// (split5_wgmma.cuh): five f32 accumulators, one walk of each tile's
// ~350-tap band in 32-tap stages copied three stages ahead.  Its tiles
// are short (11 stages), so a CTA's pipeline fill and epilogue weigh more
// than at 96k->8k (tiled, K 4600, 3840 taps a tile).
//
// Scheme "highest" (K2a, and K1a) runs on the CUDA cores (f32_fir.cuh): a
// 3-stage cp.async ring of 16-tap stages, an 8 x 8 register tile a thread,
// each warp multiplying only the 8-tap slices that meet its 16 rows'
// nonzero band, every output one FMA chain in tap order.

#include "f32_fir.cuh"
#include "fir_common.cuh"
#include "fixed_wgmma.cuh"
#include "int8_wgmma.cuh"
#include "split5_wgmma.cuh"

#include <algorithm>

namespace {

using fir::kRowTile;
using fir::kLaneTile;
using fir::kThreads;
using fir::Origin;
using fir::origin;

// A CTA's (block k, row tile) index kr and lane tile lt: (block, row tile)
// fastest, lane tiles on grid y (kBlockMajor), or lane tiles fastest on a
// 1-D grid, CTA kr * lane_tiles + lt.
template <bool kBlockMajor>
struct Cta {
  int kr, lt;
  __device__ explicit Cta(int lane_tiles)
      : kr(kBlockMajor ? blockIdx.x : blockIdx.x / lane_tiles),
        lt(kBlockMajor ? blockIdx.y : blockIdx.x % lane_tiles) {}
};

// Launches kernels[1] ((block, row tile) fastest, lane tiles on grid y,
// at most 65535) where the launch's weight cycle (weight_bytes, every
// phase's weights) is at most kBlockMajorBytes, so L2 holds it across the
// lane tiles, else kernels[0] (lane tiles fastest): the CTAs that share a
// weight tile run together, HBM serves it once and L2 the other lane
// tiles.  On the H100 (B = 2048) (block, row tile) fastest ran up to 12 %
// faster at 0.1-21 MB cycles (int8 and fixed; f32 and split5 tied), and
// lane tiles fastest 3 % faster at 55 MB (PERF.md, PR 26).
constexpr long long kBlockMajorBytes = 16ll << 20;

template <typename Kernel, typename... Args>
cudaError_t launch_ordered(Kernel* const (&kernels)[2], int n_kr,
                           int lane_tiles, long long weight_bytes,
                           int threads, int smem, cudaStream_t stream,
                           Args... args) {
  if (weight_bytes <= kBlockMajorBytes && lane_tiles <= 65535)
    kernels[1]<<<dim3(n_kr, lane_tiles), threads, smem, stream>>>(args...);
  else
    kernels[0]<<<n_kr * lane_tiles, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// CTA (block k, row tile, lane tile) of f32::kLanes lanes.
template <bool kBlockMajor>
__global__ void __launch_bounds__(fir::f32::kThreads, fir::f32::kMinBlocks)
streamed_fir_f32_kernel(fir::Launch g, Origin o, const float* __restrict__ w) {
  const Cta<kBlockMajor> c((g.B + fir::f32::kLanes - 1) / fir::f32::kLanes);
  const int row_tiles = g.R / kRowTile;
  const int k = c.kr / row_tiles;
  fir::f32::fir_tile(g, k, c.kr % row_tiles, c.lt * fir::f32::kLanes,
                     origin(g, o, k), g.R, w);
}

// Output tiles (block k, row tile, lane tile of int8tc::kLanes lanes) of
// n_kr (block, row tile) pairs; kD digit planes, split between the
// warpgroups by digit (kDigits: int8tc::digit_split) or by row.  With
// band_cap > 0 (a digit split only) persistent CTAs walk contiguous runs
// of them in band-major order, each band resident (int8tc::fir_tiles),
// else a CTA takes one (Cta).
template <int kD, bool kDigits, bool kBlockMajor>
__global__ void __launch_bounds__(kThreads, 1)
streamed_fir_int8_kernel(fir::Launch g, Origin o, int n_kr, int band_cap,
                         const int8_t* __restrict__ planes,
                         const float* __restrict__ bias, float4 scales) {
  const int lane_tiles = (g.B + fir::int8tc::kLanes - 1) / fir::int8tc::kLanes;
  if constexpr (kDigits) {
    if (band_cap > 0) {
      fir::int8tc::fir_tiles<kD>(g, o, n_kr, lane_tiles, band_cap, planes,
                                 bias, scales);
      return;
    }
  }
  const Cta<kBlockMajor> c(lane_tiles);
  const int row_tiles = g.R / kRowTile;
  const int k = c.kr / row_tiles;
  fir::int8tc::fir_tile<kD, kDigits>(
      g,
      fir::Tile(g, k, c.kr % row_tiles, c.lt, origin(g, o, k),
                fir::int8tc::kLanes),
      planes, bias, scales);
}

// The device's SM count, read once a device (set_once's way: at the first
// launch there, so a CUDA graph captured after a warm-up launch holds no
// attribute call).
cudaError_t sm_count(int* n) {
  static std::atomic<int> counts[32];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  *n = counts[dev & 31].load();
  if (*n > 0) return cudaSuccess;
  err = cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) counts[dev & 31].store(*n);
  return err;
}

// The tiles that share a (phase, row tile) band, n_blocks / P x lane
// tiles, where the kD-plane int8 launch's persistent CTAs hold each band
// resident (int8tc::fir_tiles), else 0 (a CTA a tile, its band streamed
// with x): where the digits pair up, the launch's widest band, `slices`
// K-slices (the widest of tiled_fir.band_widths of its tap table, carried
// in the int8 weights), fits one band buffer beside the x ring and at
// least the ring's lead of tiles share a band.
template <int kD>
int int8_band_tiles(int slices, int n_blocks, int P, int B) {
  const int per_band =
      n_blocks / P * ((B + fir::int8tc::kLanes - 1) / fir::int8tc::kLanes);
  return fir::int8tc::digit_split(kD) && per_band >= fir::int8tc::kTileLead &&
                 fir::int8tc::tiles_smem<kD>(slices) <= fir::int8tc::kMaxSmem
             ? per_band
             : 0;
}

// Launches the kD-plane int8 kernel (its shared memory set once a device)
// and sets *band_tiles to int8_band_tiles and *ctas to the CTAs launched:
// where *band_tiles is not 0, min(tiles, SMs) persistent CTAs on a 1-D
// grid, each band resident; else one a tile in the order launch_ordered's
// rule picks.
template <int kD>
cudaError_t launch_int8(const fir::Launch& g, Origin o, const int8_t* planes,
                        const float* bias, float4 scales, int n_blocks,
                        int slices, cudaStream_t stream, int* ctas,
                        int* band_tiles) {
  constexpr bool kDigits = fir::int8tc::digit_split(kD);
  static decltype(&streamed_fir_int8_kernel<kD, kDigits, false>) const
      kernels[2] = {streamed_fir_int8_kernel<kD, kDigits, false>,
                    streamed_fir_int8_kernel<kD, kDigits, true>};
  // the persistent walk's launches differ by band, so it takes a CTA's most
  constexpr int kSmemMax =
      kDigits ? fir::int8tc::kMaxSmem : fir::int8tc::kSmemBytes;
  static std::atomic<unsigned> smem_set{0};
  const cudaError_t attr = fir::set_once(smem_set, [] {
    const cudaError_t e = fir::int8tc::allow_smem(kernels[0], kSmemMax);
    return e != cudaSuccess ? e : fir::int8tc::allow_smem(kernels[1], kSmemMax);
  });
  if (attr != cudaSuccess) return attr;
  const int n_kr = n_blocks * (g.R / kRowTile);
  const int lane_tiles = (g.B + fir::int8tc::kLanes - 1) / fir::int8tc::kLanes;
  const long long weight_bytes = (long long)kD * g.P * g.R * g.K;
  *band_tiles = int8_band_tiles<kD>(slices, n_blocks, g.P, g.B);
  if (*band_tiles > 0) {
    int sms = 0;
    const cudaError_t err = sm_count(&sms);
    if (err != cudaSuccess) return err;
    *ctas = std::min(n_kr * lane_tiles, sms);
    kernels[weight_bytes <= kBlockMajorBytes]<<<
        *ctas, kThreads, fir::int8tc::tiles_smem<kD>(slices), stream>>>(
        g, o, n_kr, slices, planes, bias, scales);
    return cudaGetLastError();
  }
  *ctas = n_kr * lane_tiles;
  return launch_ordered(kernels, n_kr, lane_tiles, weight_bytes, kThreads,
                        fir::int8tc::kSmemBytes, stream, g, o, n_kr, 0,
                        planes, bias, scales);
}

// Output tiles (block k, row tile of fixedtc::Shape<kAccum>::kRows rows,
// lane tile of int8tc::kLanes lanes) of n_kr (block, row tile) pairs: a
// persistent CTA walks many of them (fixedtc::fir_tiles: every gridDim.x-th
// in the CTA order kBlockMajor gives, or, with band_cap > 0, a contiguous
// run in band-major order, each band resident), else a CTA takes one
// (Cta).
template <int kAccum, bool kBlockMajor>
__global__ void __launch_bounds__(kThreads,
                                  fir::fixedtc::Shape<kAccum>::kMinBlocks)
streamed_fir_fixed_kernel(fir::Launch g, Origin o, int n_kr, int band_cap,
                          const int8_t* __restrict__ planes,
                          const int32_t* __restrict__ bias,
                          const int32_t* __restrict__ coef) {
  using Shape = fir::fixedtc::Shape<kAccum>;
  const int lane_tiles = (g.B + fir::int8tc::kLanes - 1) / fir::int8tc::kLanes;
  if constexpr (Shape::kPersistent) {
    if (band_cap > 0)
      fir::fixedtc::fir_tiles<kAccum, kBlockMajor, true>(
          g, o, n_kr, lane_tiles, band_cap, planes, bias, coef);
    else
      fir::fixedtc::fir_tiles<kAccum, kBlockMajor, false>(
          g, o, n_kr, lane_tiles, 0, planes, bias, coef);
  } else {
    const Cta<kBlockMajor> c(lane_tiles);
    const int row_tiles = g.R / Shape::kRows;
    const int k = c.kr / row_tiles;
    fir::fixedtc::fir_tile<kAccum>(
        g,
        fir::Tile(g, k, c.kr % row_tiles, c.lt, origin(g, o, k),
                  fir::int8tc::kLanes, Shape::kRows),
        planes, bias, coef);
  }
}

// The tiles that share a (phase, row tile) band, n_blocks / P x lane
// tiles, where the n_accum kAccum fixed launch's persistent CTAs hold each
// band resident, else 0 (they walk it streamed): where the launch's widest
// band, `slices` K-slices (the widest of tiled_fir.band_widths of its tap
// table, carried in the fixed weights), fits two band buffers beside the x
// ring in a CTA's shared memory and at least kTileLead tiles share a band
// (fir_tiles' condition for reusing a band buffer).
template <int kAccum>
int resident_band_tiles(int slices, int n_blocks, int P, int B) {
  using Shape = fir::fixedtc::Shape<kAccum>;
  const int per_band =
      n_blocks / P * ((B + fir::int8tc::kLanes - 1) / fir::int8tc::kLanes);
  return Shape::kPersistent && per_band >= Shape::kTileLead &&
                 Shape::resident_smem(slices) <= fir::int8tc::kMaxSmem
             ? per_band
             : 0;
}

// Launches the n_accum kAccum fixed kernel (its shared memory set once a
// device) and sets *ctas to the CTAs launched: persistent
// (Shape::kPersistent), min(tiles, SMs x Shape::kMinBlocks) on a 1-D grid,
// else one a tile in the order launch_ordered's rule picks; and
// *band_tiles to resident_band_tiles (the persistent CTAs hold each band
// resident where it is not 0).
template <int kAccum>
cudaError_t launch_fixed(const fir::Launch& g, Origin o, const int8_t* planes,
                         const int32_t* bias, const int32_t* coef,
                         int n_blocks, int slices, cudaStream_t stream,
                         int* ctas, int* band_tiles) {
  using Shape = fir::fixedtc::Shape<kAccum>;
  static decltype(&streamed_fir_fixed_kernel<kAccum, false>) const
      kernels[2] = {streamed_fir_fixed_kernel<kAccum, false>,
                    streamed_fir_fixed_kernel<kAccum, true>};
  // the persistent kernel's resident launches differ by band, so it takes
  // a CTA's most
  constexpr int kSmemMax =
      Shape::kPersistent ? fir::int8tc::kMaxSmem : Shape::kLaunchSmemBytes;
  static std::atomic<unsigned> smem_set{0};
  const cudaError_t attr = fir::set_once(smem_set, [] {
    const cudaError_t e =
        fir::fixedtc::allow_smem<kAccum>(kernels[0], kSmemMax);
    return e != cudaSuccess
               ? e
               : fir::fixedtc::allow_smem<kAccum>(kernels[1], kSmemMax);
  });
  if (attr != cudaSuccess) return attr;
  const int n_kr = n_blocks * (g.R / Shape::kRows);
  const int lane_tiles = (g.B + fir::int8tc::kLanes - 1) / fir::int8tc::kLanes;
  const long long weight_bytes = 2ll * g.P * kAccum * g.R * g.K;
  if constexpr (Shape::kPersistent) {
    int sms = 0;
    const cudaError_t err = sm_count(&sms);
    if (err != cudaSuccess) return err;
    *ctas = std::min(n_kr * lane_tiles, sms * Shape::kMinBlocks);
    *band_tiles = resident_band_tiles<kAccum>(slices, n_blocks, g.P, g.B);
    const bool resident = *band_tiles > 0;
    kernels[weight_bytes <= kBlockMajorBytes]<<<
        *ctas, kThreads,
        resident ? Shape::resident_smem(slices) : Shape::kTilesSmemBytes,
        stream>>>(g, o, n_kr, resident ? slices : 0, planes, bias, coef);
    return cudaGetLastError();
  } else {
    *ctas = n_kr * lane_tiles;
    *band_tiles = 0;
    return launch_ordered(kernels, n_kr, lane_tiles, weight_bytes, kThreads,
                          Shape::kSmemBytes, stream, g, o, n_kr, 0, planes,
                          bias, coef);
  }
}

// CTA (block k, row tile, lane tile) of kLaneTile lanes.
template <bool kBlockMajor>
__global__ void __launch_bounds__(kThreads, 1)
streamed_fir_split5_kernel(fir::Launch g, Origin o,
                           const __nv_bfloat16* __restrict__ planes) {
  const Cta<kBlockMajor> c((g.B + kLaneTile - 1) / kLaneTile);
  const int row_tiles = g.R / kRowTile;
  const int k = c.kr / row_tiles;
  fir::split5::fir_tile(
      g, fir::Tile(g, k, c.kr % row_tiles, c.lt, origin(g, o, k)), planes);
}

// Both orders' instances of the f32 and split5 kernels.
decltype(&streamed_fir_f32_kernel<false>) const f32_kernels[2] = {
    streamed_fir_f32_kernel<false>, streamed_fir_f32_kernel<true>};
decltype(&streamed_fir_split5_kernel<false>) const split5_kernels[2] = {
    streamed_fir_split5_kernel<false>, streamed_fir_split5_kernel<true>};

}  // namespace

extern "C" {

// Tile sizes the host wrapper must honour (R % row_tile == 0; taps table;
// the "highest" table's sub-bands of sub_rows rows; the fixed tables' rows
// at n_accum 1 and 4).
int streamed_fir_row_tile() { return kRowTile; }
int f32_fir_sub_rows() { return fir::f32::kSubRows; }
int fixed_fir_rows(int n_accum) {
  return n_accum == 4 ? fir::fixedtc::Shape<4>::kRows
                      : fir::fixedtc::Shape<1>::kRows;
}
// The tiles that share a band where a fixed launch (n_accum, its widest
// band's K-slices, n_blocks, P, B) holds its bands resident, else 0.
int fixed_fir_band_tiles(int n_accum, int slices, int n_blocks, int P,
                         int B) {
  return n_accum == 4 ? resident_band_tiles<4>(slices, n_blocks, P, B)
                      : resident_band_tiles<1>(slices, n_blocks, P, B);
}
// The tiles that share a band where a D-plane int8 launch (its widest
// band's K-slices, n_blocks, P, B) holds its bands resident, else 0.
int int8_fir_band_tiles(int D, int slices, int n_blocks, int P, int B) {
  return D == 4   ? int8_band_tiles<4>(slices, n_blocks, P, B)
         : D == 3 ? int8_band_tiles<3>(slices, n_blocks, P, B)
         : D == 2 ? int8_band_tiles<2>(slices, n_blocks, P, B)
         : D == 1 ? int8_band_tiles<1>(slices, n_blocks, P, B)
                  : 0;
}

const char* streamed_fir_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Each entry point launches on `stream`, does not synchronise, and returns
// cudaGetLastError() of the launch (0 on success).
// taps int32[P, R / 16, 2] (each 16-row sub-band's nonzero taps);
// w f32[P, K, R], 16-byte aligned.
int streamed_fir_f32(const void* hist, const void* x, void* y,
                     const void* taps, const void* w, int H, int T, int B,
                     int R, int K, int P, int n_blocks, int shift, int num,
                     int den, int f0, void* stream) {
  cudaGetLastError();
  if (reinterpret_cast<uintptr_t>(w) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  static std::atomic<unsigned> smem_set{0};
  const cudaError_t attr = fir::set_once(smem_set, [] {
    const cudaError_t e = fir::f32::allow_smem(f32_kernels[0]);
    return e != cudaSuccess ? e : fir::f32::allow_smem(f32_kernels[1]);
  });
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const fir::Launch g = fir::make_launch(hist, x, y, taps, H, T, B, R, K, P);
  return static_cast<int>(launch_ordered(
      f32_kernels, n_blocks * (R / kRowTile),
      (B + fir::f32::kLanes - 1) / fir::f32::kLanes, 4ll * P * K * R,
      fir::f32::kThreads, fir::f32::kSmemBytes,
      static_cast<cudaStream_t>(stream), g,
      fir::make_origin(shift, num, den, f0), static_cast<const float*>(w)));
}

// planes bf16[3, P, K, R] (hi, mid, lo), 16-byte aligned.
int streamed_fir_split5(const void* hist, const void* x, void* y,
                        const void* taps, const void* planes, int H, int T,
                        int B, int R, int K, int P, int n_blocks, int shift,
                        int num, int den, int f0, void* stream) {
  cudaGetLastError();
  if (reinterpret_cast<uintptr_t>(planes) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  static std::atomic<unsigned> smem_set{0};
  const cudaError_t attr = fir::set_once(smem_set, [] {
    const cudaError_t e = fir::split5::allow_smem(split5_kernels[0]);
    return e != cudaSuccess ? e : fir::split5::allow_smem(split5_kernels[1]);
  });
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const fir::Launch g = fir::make_launch(hist, x, y, taps, H, T, B, R, K, P);
  return static_cast<int>(launch_ordered(
      split5_kernels, n_blocks * (R / kRowTile),
      (B + kLaneTile - 1) / kLaneTile, 6ll * P * K * R, kThreads,
      fir::split5::kSmemBytes, static_cast<cudaStream_t>(stream), g,
      fir::make_origin(shift, num, den, f0),
      static_cast<const __nv_bfloat16*>(planes)));
}

// planes int8[D, P, R, K] (K % 32 == 0, each 32-tap group permuted:
// int8_wgmma.cuh), 16-byte aligned; bias f32[P, R]; 1 <= D <= 4; taps
// int32[P, R / 64, 2]; slices: the most 32-tap K-slices a row tile's band
// spans in taps (1 <= slices <= K / 32; a band wider than it traps in the
// resident walk).  *ctas: the CTAs launched (0 where none was);
// *band_tiles: the tiles that share a band where the persistent CTAs hold
// bands resident, else 0.
int streamed_fir_int8(const void* hist, const void* x, void* y,
                      const void* taps, const void* planes, const void* bias,
                      int D, float s0, float s1, float s2, float s3,
                      int slices, int H, int T, int B, int R, int K, int P,
                      int n_blocks, int shift, int num, int den, int f0,
                      void* stream, int* ctas, int* band_tiles) {
  cudaGetLastError();
  *ctas = 0;
  *band_tiles = 0;
  if (reinterpret_cast<uintptr_t>(planes) % 16 || K % 32)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (slices < 1 || slices > K / 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const fir::Launch g = fir::make_launch(hist, x, y, taps, H, T, B, R, K, P);
  const Origin o = fir::make_origin(shift, num, den, f0);
  const auto* p8 = static_cast<const int8_t*>(planes);
  const auto* b32 = static_cast<const float*>(bias);
  const float4 s = make_float4(s0, s1, s2, s3);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (D == 4)
    err = launch_int8<4>(g, o, p8, b32, s, n_blocks, slices, st, ctas,
                         band_tiles);
  if (D == 3)
    err = launch_int8<3>(g, o, p8, b32, s, n_blocks, slices, st, ctas,
                         band_tiles);
  if (D == 2)
    err = launch_int8<2>(g, o, p8, b32, s, n_blocks, slices, st, ctas,
                         band_tiles);
  if (D == 1)
    err = launch_int8<1>(g, o, p8, b32, s, n_blocks, slices, st, ctas,
                         band_tiles);
  if (err != cudaSuccess) *ctas = *band_tiles = 0;
  return static_cast<int>(err);
}

// planes int8[2, P, n_accum * R, K] (K % 32 == 0, each 32-tap group
// permuted: fixed_wgmma.cuh), 16-byte aligned; bias int32[P, n_accum * R];
// coef int32[P, 4, R] (NULL for n_accum 1); taps int32[P, R / rows, 2]
// (rows: fixed_fir_rows); slices: the most 32-tap K-slices a row tile's
// band spans in taps (1 <= slices <= K / 32; a band wider than it traps in
// the resident walk).  *ctas: the CTAs launched (0 where none was);
// *band_tiles: the tiles that share a band where the persistent CTAs hold
// bands resident, else 0.
int streamed_fir_fixed(const void* hist, const void* x, void* y,
                       const void* taps, const void* planes, const void* bias,
                       const void* coef, int n_accum, int slices, int H,
                       int T, int B, int R, int K, int P, int n_blocks,
                       int shift, int num, int den, int f0, void* stream,
                       int* ctas, int* band_tiles) {
  cudaGetLastError();
  *ctas = 0;
  *band_tiles = 0;
  if (reinterpret_cast<uintptr_t>(planes) % 16 || K % 32)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (slices < 1 || slices > K / 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const fir::Launch g = fir::make_launch(hist, x, y, taps, H, T, B, R, K, P);
  const Origin o = fir::make_origin(shift, num, den, f0);
  const auto* p8 = static_cast<const int8_t*>(planes);
  const auto* b32 = static_cast<const int32_t*>(bias);
  const auto* c32 = static_cast<const int32_t*>(coef);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (n_accum == 4)
    err = launch_fixed<4>(g, o, p8, b32, c32, n_blocks, slices, st, ctas,
                          band_tiles);
  if (n_accum == 1)
    err = launch_fixed<1>(g, o, p8, b32, c32, n_blocks, slices, st, ctas,
                          band_tiles);
  if (err != cudaSuccess) *ctas = *band_tiles = 0;
  return static_cast<int>(err);
}

}  // extern "C"
