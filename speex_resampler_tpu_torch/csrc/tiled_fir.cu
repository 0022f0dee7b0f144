// Phase-tiled polyphase FIR launch for Hopper (sm_90a), schemes "highest",
// "int8", "fixed" (n_accum 1 and 4) and "split5".
//
// Replaces speex_resampler_tpu/ops/pallas_fir.py resample_conv_tm_pallas_v3
// / _kernel_v3 (the TPU kernel of the batched serving path).  It computes
// the same function: output block k (R rows, all lanes) is
//
//     y_k = epilogue( W[k % P]^T [R, K] @ patch_k [K, B] ),
//     patch_k = rows v0 .. v0+K-1 of the virtual axis hist ++ x,
//     v0      = (k / P) * S + offsets[k % P],
//
// with time-major int16 [rows, B] buffers and lanes minor.  The TPU kernel
// assembled each patch in VMEM from static copy plans over overlapping
// chunk views; here every CTA computes its own origin v0 and reads tap row
// v0+t from hist when v0+t < H, else from x.  Offsets are a device array,
// so one compiled kernel serves every fractional phase f0 a flush rebuilds.
//
// What bounds it on the H100.  One flagship launch (44.1k->48k q7, B =
// 2048) reads ~38 MB of real int16 rows and writes 42 MB, ~25 us at 3.35
// TB/s; it needs 2.7 G multiply-adds (filt_len 128 per output; 5.5 G over
// the dense K = 264): ~80 us at the 33.5 T FMA/s of the CUDA cores in f32,
// 16 us at the int8 tensor cores' 1,979 TOP/s for the 2*D int8 products of
// "int8" (D = 3).  Every scheme's CTA walks only the nonzero tap band of
// its weight columns (a block's R outputs start ~R*num/den rows apart, so
// one 64-row tile needs filt_len + 64*num/den of the K taps, ~70% at the
// flagship).  The grid runs over (block, row tile) fastest, but for
// "int8": the whole weight cycle is 2.7 MB and stays in L2.
//
// Scheme "int8" (K1b, what "auto" serves at the flagship; _kernel_v3 with
// _dot_int8) runs on the int8 tensor cores (int8_wgmma.cuh): xh / xl as
// the register operand, 2*D exact int32 dots in one walk of the band, the
// f32 epilogue in digit order.  Its planes are K-major, int8[D, P, R,
// K_pad] (K padded to a multiple of 32, each 32-tap group permuted; JAX's
// are [D, P, K, R]).  Every block of phase m applies the same weights, so
// tiled_fir_int8_kernel<D, kVec> gives a CTA one (phase, 64-row tile) and
// kGroup of the n_blocks / P x ceil(B / 64) output tiles that share its
// digit band: the band is copied into shared memory once, and only x
// streams, each warpgroup through its own ring (int8tc::fir_tile_resident;
// kVec: 16-byte x copies, where B % 8 == 0 and hist and x are 16-byte
// aligned, else 2-byte loads).  Where a band does not fit its shared
// memory (D x 64 rows x span bytes; the span is the host's, computed once
// per step), tiled_fir_int8_long_kernel runs K2b's fir_tile with the tiled
// origin, a CTA an output tile.
//
// Scheme "highest" (K1a) has its own product, shared with the streamed
// kernel (f32_fir.cuh): a 3-stage cp.async ring of 16-tap stages, x
// converted to f32 once a stage, an 8 x 8 register tile a thread, and each
// warp multiplying only the 8-tap slices that meet its 16 rows' nonzero
// band (a table of 16-row sub-bands), every output still one FMA chain in
// tap order.  Its lane tile is f32::kLanes.
//
// Scheme "fixed" (the Q15 universe; K1's fixed branch, _kernel_v3 with
// _dot_fixed and the fixed_math epilogues; K1e at n_accum 4, K1d at 1)
// runs on the int8 tensor cores (fixed_wgmma.cuh, shared with the streamed
// kernel): _dot_fixed's four int8 dots and bias, all n_accum weight column
// sets (C = 4R = 512 at 44.1k->48k q7) in one walk of the band, x split
// once per K-slice.  Its planes are K-major, int8[2, P, C, K_pad] (wh,
// wl0; K padded to a multiple of 32, each 32-tap group permuted: JAX's
// tiled planes are [2, P, C, K]); its CTA takes fixedtc::Shape's rows and
// int8tc::kLanes lanes, and its tap table those rows.  Its flagship launch
// needs 10.7 G int16 multiply-adds (filt_len x 4 per output): 86 G int8
// tensor-core operations (4 int8 products, 8 ops, per int16 MAC), ~43 us,
// above the ~25 us of its bytes, so operations bound it; the CUDA cores'
// IMAD would take >= 0.86 ms for the 14.4 G the 64-row tiles walk.
//
// Scheme "split5" (K1c; _kernel_v3 with _dot_scheme "split5": five bf16
// products per multiply-add, summed in f32) is what "auto" resolves where
// the int8 certificate fails, e.g. 96 kHz -> 8 kHz q10 (filt_len 3072,
// K 4600, P 1).  One launch at B = 2048 needs 16.1 G multiply-adds: 161 G
// bf16 tensor-core FLOP at 5 products each, ~0.16 ms, above the ~0.045 ms
// of its ~151 MB, so operations bound it, and only the tensor cores come
// near: the CUDA cores' f32 FMA would take 2.4 ms for the five passes.
// So it runs on them (split5_wgmma.cuh): wgmma m64n64k16 with x_hi / x_lo
// as the register operand, five f32 accumulators over one walk of the
// band (3840 taps a tile), the weights and x rows copied three stages
// ahead, and each K-slice's x split while the previous slice's wgmmas run.

#include "f32_fir.cuh"
#include "fir_common.cuh"
#include "fixed_wgmma.cuh"
#include "int8_wgmma.cuh"
#include "split5_wgmma.cuh"

namespace {

using fir::kRowTile;
using fir::kLaneTile;
using fir::kThreads;

// Block k and row tile of this CTA, and its patch origin.
__device__ __forceinline__ fir::Tile tiled_tile(const fir::Launch& g,
                                                const int32_t* offsets,
                                                int S) {
  const int row_tiles = g.R / kRowTile;
  const int k = blockIdx.x / row_tiles;
  return fir::Tile(g, k, blockIdx.x % row_tiles, blockIdx.y,
                   (k / g.P) * S + offsets[k % g.P]);
}

// grid (n_blocks * R / kRowTile, ceil(B / f32::kLanes))
__global__ void __launch_bounds__(fir::f32::kThreads, fir::f32::kMinBlocks)
tiled_fir_f32_kernel(fir::Launch g, const int32_t* __restrict__ offsets,
                     int S, const float* __restrict__ w) {
  const int row_tiles = g.R / kRowTile;
  const int k = blockIdx.x / row_tiles;
  fir::f32::fir_tile(g, k, blockIdx.x % row_tiles,
                     blockIdx.y * fir::f32::kLanes,
                     (k / g.P) * S + offsets[k % g.P], g.R, w);
}

// grid P * (R / kRowTile) * groups, groups = ceil(n_periods * lane_tiles /
// kGroup): CTA ((m * row_tiles + rt) * groups + group) takes items group *
// kGroup .. of phase m's work list (int8tc::fir_tile_resident), so the
// CTAs of one phase sit next to each other.  kVec: x rows 16-byte aligned.
template <int kD, bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
tiled_fir_int8_kernel(fir::Launch g, const int32_t* __restrict__ offsets,
                      int S, int n_periods, int max_slices,
                      const int8_t* __restrict__ planes,
                      const float* __restrict__ bias, float4 scales) {
  using fir::int8tc::kGroup;
  const int lane_tiles = (g.B + fir::int8tc::kLanes - 1) / fir::int8tc::kLanes;
  const int items = n_periods * lane_tiles;
  const int groups = (items + kGroup - 1) / kGroup;
  const int mr = blockIdx.x / groups, item0 = blockIdx.x % groups * kGroup;
  const int m = mr / (g.R / kRowTile);
  fir::int8tc::fir_tile_resident<kD, kVec>(
      g, m, mr % (g.R / kRowTile), item0, min(kGroup, items - item0),
      lane_tiles, offsets[m], S, planes, bias, scales, max_slices);
}

// Bands past the resident kernel's shared memory: a CTA per output tile,
// grid (n_blocks * R / kRowTile, ceil(B / int8tc::kLanes)).
template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
tiled_fir_int8_long_kernel(fir::Launch g, const int32_t* __restrict__ offsets,
                           int S, const int8_t* __restrict__ planes,
                           const float* __restrict__ bias, float4 scales) {
  const int row_tiles = g.R / kRowTile;
  const int k = blockIdx.x / row_tiles;
  fir::int8tc::fir_tile<kD>(
      g,
      fir::Tile(g, k, blockIdx.x % row_tiles, blockIdx.y,
                (k / g.P) * S + offsets[k % g.P], fir::int8tc::kLanes),
      planes, bias, scales);
}

// The most K-slices a resident kD-plane band may span.
template <int kD>
constexpr int resident_slices() {
  using namespace fir::int8tc;
  return (kMaxSmem - resident_smem<kD>(0)) / (kD * kTileBytes);
}

// Launches the resident kD-plane int8 kernel with 16-byte (kVec) or 2-byte
// x copies (its shared memory set once a device).
template <int kD, bool kVec>
cudaError_t launch_resident(const fir::Launch& g, const int32_t* offsets,
                            int S, const int8_t* planes, const float* bias,
                            float4 scales, int max_slices, int n_blocks,
                            cudaStream_t stream) {
  using namespace fir::int8tc;
  static std::atomic<unsigned> smem_set{0};
  const cudaError_t attr = fir::set_once(smem_set, [] {
    return allow_smem(tiled_fir_int8_kernel<kD, kVec>, kMaxSmem);
  });
  if (attr != cudaSuccess) return attr;
  const int n_periods = n_blocks / g.P;
  const int lane_tiles = (g.B + kLanes - 1) / kLanes;
  const int groups = (n_periods * lane_tiles + kGroup - 1) / kGroup;
  tiled_fir_int8_kernel<kD, kVec><<<g.P * (g.R / kRowTile) * groups, kThreads,
                                    resident_smem<kD>(max_slices), stream>>>(
      g, offsets, S, n_periods, max_slices, planes, bias, scales);
  return cudaGetLastError();
}

// Launches the kD-plane int8 kernel: the resident one where a band of
// max_slices K-slices fits, else the long one (each kernel's shared memory
// set once a device).
template <int kD>
cudaError_t launch_int8(const fir::Launch& g, const int32_t* offsets, int S,
                        const int8_t* planes, const float* bias,
                        float4 scales, int max_slices, int n_blocks,
                        cudaStream_t stream) {
  using namespace fir::int8tc;
  if (max_slices <= resident_slices<kD>()) {
    const bool vec = g.B % 8 == 0 &&
                     (reinterpret_cast<uintptr_t>(g.hist) |
                      reinterpret_cast<uintptr_t>(g.x)) % 16 == 0;
    return vec ? launch_resident<kD, true>(g, offsets, S, planes, bias,
                                           scales, max_slices, n_blocks,
                                           stream)
               : launch_resident<kD, false>(g, offsets, S, planes, bias,
                                            scales, max_slices, n_blocks,
                                            stream);
  }
  static std::atomic<unsigned> smem_set{0};
  const cudaError_t attr = fir::set_once(
      smem_set, [] { return allow_smem(tiled_fir_int8_long_kernel<kD>); });
  if (attr != cudaSuccess) return attr;
  const dim3 grid(n_blocks * (g.R / kRowTile),
                  (g.B + kLanes - 1) / kLanes);
  tiled_fir_int8_long_kernel<kD><<<grid, kThreads, kSmemBytes, stream>>>(
      g, offsets, S, planes, bias, scales);
  return cudaGetLastError();
}

// grid (n_blocks * R / Shape<kAccum>::kRows, ceil(B / int8tc::kLanes))
template <int kAccum>
__global__ void __launch_bounds__(kThreads,
                                  fir::fixedtc::Shape<kAccum>::kMinBlocks)
tiled_fir_fixed_kernel(fir::Launch g, const int32_t* __restrict__ offsets,
                       int S, const int8_t* __restrict__ planes,
                       const int32_t* __restrict__ bias,
                       const int32_t* __restrict__ coef) {
  constexpr int kRows = fir::fixedtc::Shape<kAccum>::kRows;
  const int row_tiles = g.R / kRows;
  const int k = blockIdx.x / row_tiles;
  fir::fixedtc::fir_tile<kAccum>(
      g,
      fir::Tile(g, k, blockIdx.x % row_tiles, blockIdx.y,
                (k / g.P) * S + offsets[k % g.P], fir::int8tc::kLanes, kRows),
      planes, bias, coef);
}

// Launches the n_accum kAccum fixed kernel (its shared memory set once a
// device).
template <int kAccum>
cudaError_t launch_fixed(const fir::Launch& g, const int32_t* offsets, int S,
                         const int8_t* planes, const int32_t* bias,
                         const int32_t* coef, int n_blocks,
                         cudaStream_t stream) {
  using Shape = fir::fixedtc::Shape<kAccum>;
  static std::atomic<unsigned> smem_set{0};
  const cudaError_t attr = fir::set_once(smem_set, [] {
    return fir::fixedtc::allow_smem<kAccum>(tiled_fir_fixed_kernel<kAccum>);
  });
  if (attr != cudaSuccess) return attr;
  const dim3 grid(n_blocks * (g.R / Shape::kRows),
                  (g.B + fir::int8tc::kLanes - 1) / fir::int8tc::kLanes);
  tiled_fir_fixed_kernel<kAccum><<<grid, kThreads, Shape::kSmemBytes,
                                   stream>>>(g, offsets, S, planes, bias,
                                             coef);
  return cudaGetLastError();
}

__global__ void __launch_bounds__(kThreads, 1)
tiled_fir_split5_kernel(fir::Launch g, const int32_t* __restrict__ offsets,
                        int S, const __nv_bfloat16* __restrict__ planes) {
  fir::split5::fir_tile(g, tiled_tile(g, offsets, S), planes);
}

dim3 grid_of(int n_blocks, int R, int B) {
  return dim3(n_blocks * (R / kRowTile), (B + kLaneTile - 1) / kLaneTile);
}

}  // namespace

extern "C" {

// Tile sizes the host wrapper must honour (R % row_tile == 0; taps table;
// the "highest" table's sub-bands of sub_rows rows; the fixed tables' rows
// at n_accum 1 and 4).
int tiled_fir_row_tile() { return kRowTile; }
int f32_fir_sub_rows() { return fir::f32::kSubRows; }
int fixed_fir_rows(int n_accum) {
  return n_accum == 4 ? fir::fixedtc::Shape<4>::kRows
                      : fir::fixedtc::Shape<1>::kRows;
}

const char* tiled_fir_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Each entry point launches on `stream`, does not synchronise, and returns
// cudaGetLastError() of the launch (0 on success).
// taps int32[P, R / sub_rows, 2] (each 16-row sub-band's nonzero taps);
// w f32[P, K, R], 16-byte aligned.
int tiled_fir_f32(const void* hist, const void* x, void* y, const void* offsets,
                  const void* taps, const void* w, int H, int T, int B, int R,
                  int K, int P, int S, int n_blocks, void* stream) {
  cudaGetLastError();
  if (reinterpret_cast<uintptr_t>(w) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  static std::atomic<unsigned> smem_set{0};
  const cudaError_t attr = fir::set_once(smem_set, [] {
    return fir::f32::allow_smem(tiled_fir_f32_kernel);
  });
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const fir::Launch g = fir::make_launch(hist, x, y, taps, H, T, B, R, K, P);
  const dim3 grid(n_blocks * (R / kRowTile),
                  (B + fir::f32::kLanes - 1) / fir::f32::kLanes);
  tiled_fir_f32_kernel<<<grid, fir::f32::kThreads, fir::f32::kSmemBytes,
                         static_cast<cudaStream_t>(stream)>>>(
      g, static_cast<const int32_t*>(offsets), S, static_cast<const float*>(w));
  return static_cast<int>(cudaGetLastError());
}

// planes bf16[3, P, K, R] (hi, mid, lo), 16-byte aligned.
int tiled_fir_split5(const void* hist, const void* x, void* y,
                     const void* offsets, const void* taps, const void* planes,
                     int H, int T, int B, int R, int K, int P, int S,
                     int n_blocks, void* stream) {
  cudaGetLastError();
  if (reinterpret_cast<uintptr_t>(planes) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  static std::atomic<unsigned> smem_set{0};
  const cudaError_t attr = fir::set_once(smem_set, [] {
    return fir::split5::allow_smem(tiled_fir_split5_kernel);
  });
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const fir::Launch g = fir::make_launch(hist, x, y, taps, H, T, B, R, K, P);
  tiled_fir_split5_kernel<<<grid_of(n_blocks, R, B), kThreads,
                            fir::split5::kSmemBytes,
                            static_cast<cudaStream_t>(stream)>>>(
      g, static_cast<const int32_t*>(offsets), S,
      static_cast<const __nv_bfloat16*>(planes));
  return static_cast<int>(cudaGetLastError());
}

// planes int8[D, P, R, K] (K % 32 == 0, each 32-tap group permuted:
// int8_wgmma.cuh) and bias f32[P, R], 16-byte aligned; 1 <= D <= 4;
// max_slices: the most 32-tap K-slices any row tile's band spans (from
// its t_lo rounded down to 32; tiled_fir.band_slices).
int tiled_fir_int8(const void* hist, const void* x, void* y,
                   const void* offsets, const void* taps, const void* planes,
                   const void* bias, int D, float s0, float s1, float s2,
                   float s3, int max_slices, int H, int T, int B, int R,
                   int K, int P, int S, int n_blocks, void* stream) {
  cudaGetLastError();
  if ((reinterpret_cast<uintptr_t>(planes) |
       reinterpret_cast<uintptr_t>(bias)) % 16 || K % 32)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (max_slices < 0 || max_slices > K / 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const fir::Launch g = fir::make_launch(hist, x, y, taps, H, T, B, R, K, P);
  const auto* off = static_cast<const int32_t*>(offsets);
  const auto* p8 = static_cast<const int8_t*>(planes);
  const auto* b32 = static_cast<const float*>(bias);
  const float4 s = make_float4(s0, s1, s2, s3);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (D == 4) err = launch_int8<4>(g, off, S, p8, b32, s, max_slices, n_blocks, st);
  if (D == 3) err = launch_int8<3>(g, off, S, p8, b32, s, max_slices, n_blocks, st);
  if (D == 2) err = launch_int8<2>(g, off, S, p8, b32, s, max_slices, n_blocks, st);
  if (D == 1) err = launch_int8<1>(g, off, S, p8, b32, s, max_slices, n_blocks, st);
  return static_cast<int>(err);
}

// The most K-slices a band may span for the resident int8 kernel with D
// digit planes (0 for another D): longer bands take the long kernel.
int tiled_fir_int8_max_slices(int D) {
  return D == 1 ? resident_slices<1>() : D == 2 ? resident_slices<2>()
       : D == 3 ? resident_slices<3>() : D == 4 ? resident_slices<4>() : 0;
}

// planes int8[2, P, n_accum * R, K] (K % 32 == 0, each 32-tap group
// permuted: fixed_wgmma.cuh), 16-byte aligned; bias int32[P, n_accum * R];
// coef int32[P, 4, R] (NULL for n_accum 1); taps int32[P, R / rows, 2]
// (rows: fixed_fir_rows).
int tiled_fir_fixed(const void* hist, const void* x, void* y,
                    const void* offsets, const void* taps, const void* planes,
                    const void* bias, const void* coef, int n_accum, int H,
                    int T, int B, int R, int K, int P, int S, int n_blocks,
                    void* stream) {
  cudaGetLastError();
  if (reinterpret_cast<uintptr_t>(planes) % 16 || K % 32)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const fir::Launch g = fir::make_launch(hist, x, y, taps, H, T, B, R, K, P);
  const auto* off = static_cast<const int32_t*>(offsets);
  const auto* p8 = static_cast<const int8_t*>(planes);
  const auto* b32 = static_cast<const int32_t*>(bias);
  const auto* c32 = static_cast<const int32_t*>(coef);
  const auto st = static_cast<cudaStream_t>(stream);
  if (n_accum == 4)
    return static_cast<int>(
        launch_fixed<4>(g, off, S, p8, b32, c32, n_blocks, st));
  if (n_accum == 1)
    return static_cast<int>(
        launch_fixed<1>(g, off, S, p8, b32, c32, n_blocks, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
