// Streamed-weight polyphase FIR launch for Hopper (sm_90a), schemes
// "highest", "int8" (D <= 4 digit planes), "fixed" (n_accum 1 and 4) and
// "split5".
//
// Replaces speex_resampler_tpu/ops/pallas_fir.py resample_conv_tm_pallas_v4
// / _kernel_v4 (with _v4_hist_plans), the TPU kernel of the large-P
// configurations: every 48 kHz -> 44.1 kHz conversion (P = 147 weight
// phases, 38.5 MB of f32 weights at q10) and 44.1 kHz -> 16 kHz at q7.  It
// computes the same function: output block k (R rows, all lanes) is
//
//     y_k = epilogue( W[k % P]^T [R, K] @ patch_k [K, B] ),
//     patch_k = rows v0 .. v0+K-1 of the virtual axis hist ++ x,
//     v0      = floor16((f0 + k*R*num) / den + shift)   (in 64 bits),
//
// the closed form of _kernel_v4, equal to K1's (k / P) * S + offsets[k % P].
// The TPU kernel DMA'd each block's [R, K] weights and [K, lanes] patch into
// double-buffered VMEM scratch and patched the first blocks, whose window
// starts inside hist, with synchronous copies; here every CTA reads tap row
// v0+t from hist when v0+t < H, else from x, as the tiled kernel does.  The
// weights are the port's own layout [P, K, R] (JAX streams [P, R, K]; the
// int8 planes are K-major, below); the staging, product and epilogues are
// fir_common.cuh's ("highest": f32_fir.cuh's; split5: split5_wgmma.cuh's,
// both shared with tiled_fir.cu, so those kernels round identically; int8:
// int8_wgmma.cuh's, the same exact sums and epilogue as the tiled int8
// kernel's).
//
// What bounds it on the H100: the multiply-adds.  One 48k->44.1k q10 launch
// at B = 2048 (n_blocks 147, R 128, K 512, filt_len 280) must move ~183 MB
// (x 85 MB, y 77 MB, the nonzero f32 weights 21 MB): ~55 us at 3.35 TB/s;
// it needs 10.8 G multiply-adds (filt_len per output): ~322 us at the
// 33.5 T FMA/s of the CUDA cores in f32; under "int8" 2*D int8 products
// each, 87 us at the 1,979 TOP/s of the int8 tensor cores for D = 4.  The
// 64-row tiles walk 13.4 G of them, each tile's
// nonzero tap band; the "highest" kernel's warps 11.7 G, each 16-row
// sub-band's 8-tap slices (f32_fir.cuh).
// What the TPU design was for (weights too large for VMEM) does not apply:
// the H100 reads weights through its 50 MB L2 either way.  The Hopper risk
// is re-reading them from HBM once per lane tile (16 x 38.5 MB per launch
// at B = 2048).  So the grid runs over lane tiles fastest: the CTAs that
// share block k's weight columns are scheduled together, HBM serves each
// weight tile once and L2 the other lane tiles (the counterpart of v4's
// "widest lane tile" rule).
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
// tile is int8tc::kLanes.
//
// Scheme "fixed" (K2d; v4's fixed branch: _dot_fixed, then the fixed_math
// epilogues) runs on the int8 tensor cores too (fixed_wgmma.cuh, shared
// with the tiled kernel): _dot_fixed's four int8 dots and bias, all
// n_accum column sets in one walk.  Its planes are K-major, int8[2, P,
// n_accum * R, K_pad] (wh, wl0; 77 MB at q10, n_accum 4; JAX streams [P,
// 2, C, K_pad]), each 32-tap group permuted as int8's; its CTA takes
// fixedtc::Shape's rows and int8tc::kLanes lanes.  A q10 launch needs 43.2
// G int16 multiply-adds (filt_len x 4 per output): 345 G int8 tensor-core
// operations, ~174 us, above the ~61 us of its bytes, so operations bound
// it.
//
// Scheme "split5" (K2c; v4's split5 branch, five bf16 products per
// multiply-add summed in f32) reads bf16 planes [3, P, K_pad, R] (JAX
// streams [P, 3, R, K_pad]).  At 48k->44.1k q10 it needs the 10.8 G
// multiply-adds of "highest": 108 G bf16 tensor-core FLOP, ~0.11 ms, above
// the ~58 us of its bytes, so operations bound it.  It runs on the bf16
// tensor cores (split5_wgmma.cuh, shared with the tiled kernel): five f32
// accumulators, one walk of each tile's ~350-tap band in 32-tap stages
// copied three stages ahead.  Its tiles are short (11 stages), so a CTA's
// pipeline fill and epilogue weigh more than at 96k->8k.

#include "f32_fir.cuh"
#include "fir_common.cuh"
#include "fixed_wgmma.cuh"
#include "int8_wgmma.cuh"
#include "split5_wgmma.cuh"

namespace {

using fir::kRowTile;
using fir::kLaneTile;
using fir::kThreads;

// Closed-form patch origins of one launch.
struct Origin {
  int shift, num, den, f0;
};

// Block k's patch origin.
__device__ __forceinline__ int origin(const fir::Launch& g, Origin o, int k) {
  const long long t = o.f0 + (long long)k * g.R * o.num;
  return (int)((t / o.den + o.shift) / 16 * 16);
}

// CTA index = (block k, row tile) * lane_tiles + lane tile.
__device__ __forceinline__ fir::Tile streamed_tile(const fir::Launch& g,
                                                   Origin o) {
  const int lane_tiles = (g.B + kLaneTile - 1) / kLaneTile;
  const int row_tiles = g.R / kRowTile;
  const int kr = blockIdx.x / lane_tiles;
  const int k = kr / row_tiles;
  return fir::Tile(g, k, kr % row_tiles, blockIdx.x % lane_tiles,
                   origin(g, o, k));
}

// The same order over f32::kLanes-lane tiles.
__global__ void __launch_bounds__(fir::f32::kThreads, fir::f32::kMinBlocks)
streamed_fir_f32_kernel(fir::Launch g, Origin o, const float* __restrict__ w) {
  const int lane_tiles = (g.B + fir::f32::kLanes - 1) / fir::f32::kLanes;
  const int row_tiles = g.R / kRowTile;
  const int kr = blockIdx.x / lane_tiles;
  const int k = kr / row_tiles;
  fir::f32::fir_tile(g, k, kr % row_tiles,
                     (blockIdx.x % lane_tiles) * fir::f32::kLanes,
                     origin(g, o, k), g.R, w);
}

// The same order over int8tc::kLanes-lane tiles; kD digit planes, split
// between the warpgroups by digit (kDigits: int8tc::digit_split) or by row.
template <int kD, bool kDigits>
__global__ void __launch_bounds__(kThreads, 1)
streamed_fir_int8_kernel(fir::Launch g, Origin o,
                         const int8_t* __restrict__ planes,
                         const float* __restrict__ bias, float4 scales) {
  const int lane_tiles = (g.B + fir::int8tc::kLanes - 1) / fir::int8tc::kLanes;
  const int row_tiles = g.R / kRowTile;
  const int kr = blockIdx.x / lane_tiles;
  const int k = kr / row_tiles;
  fir::int8tc::fir_tile<kD, kDigits>(
      g,
      fir::Tile(g, k, kr % row_tiles, blockIdx.x % lane_tiles,
                origin(g, o, k), fir::int8tc::kLanes),
      planes, bias, scales);
}

// Launches the kD-plane int8 kernel (its shared memory set once a device).
template <int kD>
cudaError_t launch_int8(const fir::Launch& g, Origin o, const int8_t* planes,
                        const float* bias, float4 scales, int n_blocks,
                        cudaStream_t stream) {
  constexpr bool kDigits = fir::int8tc::digit_split(kD);
  static std::atomic<unsigned> smem_set{0};
  const cudaError_t attr = fir::set_once(smem_set, [] {
    return fir::int8tc::allow_smem(streamed_fir_int8_kernel<kD, kDigits>);
  });
  if (attr != cudaSuccess) return attr;
  const dim3 grid(n_blocks * (g.R / kRowTile) *
                  ((g.B + fir::int8tc::kLanes - 1) / fir::int8tc::kLanes));
  streamed_fir_int8_kernel<kD, kDigits><<<grid, kThreads,
                                          fir::int8tc::kSmemBytes, stream>>>(
      g, o, planes, bias, scales);
  return cudaGetLastError();
}

// The same order over fixedtc::Shape<kAccum>::kRows-row, int8tc::kLanes-
// lane tiles.
template <int kAccum>
__global__ void __launch_bounds__(kThreads,
                                  fir::fixedtc::Shape<kAccum>::kMinBlocks)
streamed_fir_fixed_kernel(fir::Launch g, Origin o,
                          const int8_t* __restrict__ planes,
                          const int32_t* __restrict__ bias,
                          const int32_t* __restrict__ coef) {
  constexpr int kRows = fir::fixedtc::Shape<kAccum>::kRows;
  const int lane_tiles = (g.B + fir::int8tc::kLanes - 1) / fir::int8tc::kLanes;
  const int row_tiles = g.R / kRows;
  const int kr = blockIdx.x / lane_tiles;
  const int k = kr / row_tiles;
  fir::fixedtc::fir_tile<kAccum>(
      g,
      fir::Tile(g, k, kr % row_tiles, blockIdx.x % lane_tiles,
                origin(g, o, k), fir::int8tc::kLanes, kRows),
      planes, bias, coef);
}

// Launches the n_accum kAccum fixed kernel (its shared memory set once a
// device).
template <int kAccum>
cudaError_t launch_fixed(const fir::Launch& g, Origin o, const int8_t* planes,
                         const int32_t* bias, const int32_t* coef,
                         int n_blocks, cudaStream_t stream) {
  using Shape = fir::fixedtc::Shape<kAccum>;
  static std::atomic<unsigned> smem_set{0};
  const cudaError_t attr = fir::set_once(smem_set, [] {
    return fir::fixedtc::allow_smem<kAccum>(streamed_fir_fixed_kernel<kAccum>);
  });
  if (attr != cudaSuccess) return attr;
  const dim3 grid(n_blocks * (g.R / Shape::kRows) *
                  ((g.B + fir::int8tc::kLanes - 1) / fir::int8tc::kLanes));
  streamed_fir_fixed_kernel<kAccum><<<grid, kThreads, Shape::kSmemBytes,
                                      stream>>>(g, o, planes, bias, coef);
  return cudaGetLastError();
}

__global__ void __launch_bounds__(kThreads, 1)
streamed_fir_split5_kernel(fir::Launch g, Origin o,
                           const __nv_bfloat16* __restrict__ planes) {
  fir::split5::fir_tile(g, streamed_tile(g, o), planes);
}

dim3 grid_of(int n_blocks, int R, int B) {
  return dim3(n_blocks * (R / kRowTile) * ((B + kLaneTile - 1) / kLaneTile));
}

}  // namespace

extern "C" {

// Tile sizes the host wrapper must honour (R % row_tile == 0; taps table).
int streamed_fir_row_tile() { return kRowTile; }

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
    return fir::f32::allow_smem(streamed_fir_f32_kernel);
  });
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const fir::Launch g = fir::make_launch(hist, x, y, taps, H, T, B, R, K, P);
  const dim3 grid(n_blocks * (R / kRowTile) *
                  ((B + fir::f32::kLanes - 1) / fir::f32::kLanes));
  streamed_fir_f32_kernel<<<grid, fir::f32::kThreads, fir::f32::kSmemBytes,
                            static_cast<cudaStream_t>(stream)>>>(
      g, Origin{shift, num, den, f0}, static_cast<const float*>(w));
  return static_cast<int>(cudaGetLastError());
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
    return fir::split5::allow_smem(streamed_fir_split5_kernel);
  });
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const fir::Launch g = fir::make_launch(hist, x, y, taps, H, T, B, R, K, P);
  streamed_fir_split5_kernel<<<grid_of(n_blocks, R, B), kThreads,
                               fir::split5::kSmemBytes,
                               static_cast<cudaStream_t>(stream)>>>(
      g, Origin{shift, num, den, f0},
      static_cast<const __nv_bfloat16*>(planes));
  return static_cast<int>(cudaGetLastError());
}

// planes int8[D, P, R, K] (K % 16 == 0, each 32-tap group permuted:
// int8_wgmma.cuh), 16-byte aligned; bias f32[P, R]; 1 <= D <= 4.
int streamed_fir_int8(const void* hist, const void* x, void* y,
                      const void* taps, const void* planes, const void* bias,
                      int D, float s0, float s1, float s2, float s3, int H,
                      int T, int B, int R, int K, int P, int n_blocks,
                      int shift, int num, int den, int f0, void* stream) {
  cudaGetLastError();
  if (reinterpret_cast<uintptr_t>(planes) % 16 || K % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const fir::Launch g = fir::make_launch(hist, x, y, taps, H, T, B, R, K, P);
  const Origin o{shift, num, den, f0};
  const auto* p8 = static_cast<const int8_t*>(planes);
  const auto* b32 = static_cast<const float*>(bias);
  const float4 s = make_float4(s0, s1, s2, s3);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (D == 4) err = launch_int8<4>(g, o, p8, b32, s, n_blocks, st);
  if (D == 3) err = launch_int8<3>(g, o, p8, b32, s, n_blocks, st);
  if (D == 2) err = launch_int8<2>(g, o, p8, b32, s, n_blocks, st);
  if (D == 1) err = launch_int8<1>(g, o, p8, b32, s, n_blocks, st);
  return static_cast<int>(err);
}

// planes int8[2, P, n_accum * R, K] (K % 32 == 0, each 32-tap group
// permuted: fixed_wgmma.cuh), 16-byte aligned; bias int32[P, n_accum * R];
// coef int32[P, 4, R] (NULL for n_accum 1); taps int32[P, R / rows, 2]
// (rows: fixed_fir_rows).
int streamed_fir_fixed(const void* hist, const void* x, void* y,
                       const void* taps, const void* planes, const void* bias,
                       const void* coef, int n_accum, int H, int T, int B,
                       int R, int K, int P, int n_blocks, int shift, int num,
                       int den, int f0, void* stream) {
  cudaGetLastError();
  if (reinterpret_cast<uintptr_t>(planes) % 16 || K % 32)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const fir::Launch g = fir::make_launch(hist, x, y, taps, H, T, B, R, K, P);
  const Origin o{shift, num, den, f0};
  const auto* p8 = static_cast<const int8_t*>(planes);
  const auto* b32 = static_cast<const int32_t*>(bias);
  const auto* c32 = static_cast<const int32_t*>(coef);
  const auto st = static_cast<cudaStream_t>(stream);
  if (n_accum == 4)
    return static_cast<int>(launch_fixed<4>(g, o, p8, b32, c32, n_blocks, st));
  if (n_accum == 1)
    return static_cast<int>(launch_fixed<1>(g, o, p8, b32, c32, n_blocks, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
