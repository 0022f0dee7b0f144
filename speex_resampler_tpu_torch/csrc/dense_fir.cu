// Dense padded-weight FIR launch for Hopper (sm_90a), schemes "highest" and
// "fixed" (below).
//
// Replaces speex_resampler_tpu/ops/pallas_fir.py resample_conv_tm_pallas /
// _kernel (K3), the TPU kernel of the dense geometry: launch quanta below
// one tiled or streamed unit, e.g. the voip preset's hard 20 ms cap
// (44.1 kHz -> 48 kHz q3: group 1, stride 147, R 160, L_pad 294, 6 blocks
// of 882 -> 960 frames).  It computes the same function: block b (R rows,
// all lanes) is
//
//     y_b = WORD2INT( W^T [R, L_pad] @ X[b*stride .. b*stride + L_pad) ),
//
// X the virtual axis hist ++ x ++ zeros, f32 sums (FMA, no TF32).  The TPU
// kernel split W into A = L_pad / stride chunks against stride-row views of
// a concatenated, padded x; here every CTA reads tap row b*stride + t from
// hist when it lies there, else from x, else zero, so the step builds no
// concatenation.
//
// What bounds it on the H100: the voip launch at B = 2048 needs 94 M
// multiply-adds (filt_len 48 per output): ~2.8 us at the 33.5 T FMA/s of
// the CUDA cores, against ~7.8 MB of rows in and out, ~2.3 us at 3.35 TB/s.
// Both are far below a launch's fixed cost, so what matters is not walking
// the zeros (K3 multiplies all L_pad rows, ~6x the needed work at voip) and
// a short pipeline fill: each CTA's band is ~110 taps, 7 stages.
//
// The product is f32_fir.cuh's, as in the tiled and streamed "highest"
// kernels: a cp.async ring of 16-tap stages, x converted to f32 once a
// stage, register tiles, and warps that skip the 8-tap slices outside
// their 16 rows' nonzero band; every output stays one __fmaf_rn chain from
// 0 in ascending tap order, the chain of the first dense kernel, so the
// bits are unchanged.  What the dense geometry adds: one weight phase
// (P = 1); the block origin b*stride, which need not be a multiple of 16
// (the ring copies x a tap row at a time, 16-byte aligned by lane, so no
// origin alignment is assumed); and R = group*den of any width: the host
// pads W to R_pad = round64(R) zero columns (ops/dense_fir.py), the
// 16-row sub-band table covers R_pad, and no row at or past R is stored.
//
// Its CTAs are narrower than the other f32 kernels': 64 lanes in 8-row x
// 4-lane thread tiles (128 threads, 26 KB), twice the CTAs (576 at voip)
// each with half the work, so more of every short band's pipeline fill
// overlaps.  On the H100 that ran 1.2x faster at voip than 128-lane CTAs,
// with 16- or 8-tap stages (PERF.md, tools/dense_ablate.py).  It is the
// slower one where the bands are long and R is large: at R 2000 (32 MB of
// weights, a dense launch of the GPU tests) 0.083 ms a launch in a CUDA
// graph against 0.064 ms for 128-lane CTAs, still about 2x faster than the
// first dense kernel (0.160 ms).  A configuration whose latency cap sends
// launches of that size to the dense geometry would take its CTA width
// from R in the launcher.
//
// Scheme "fixed" (the Q15 universe; the JAX package's resample_conv_tm_fixed,
// speex_resampler_tpu/ops/fir_matmul.py, an XLA program outside Pallas):
// dense_fir_fixed_kernel<kAccum> runs fixed_wgmma.cuh's tile (the tiled and
// streamed fixed kernels' _dot_fixed as four int8 wgmmas a 32-tap K-slice
// plus a bias, wrapping in uint32, then the Q15 epilogues) under this
// launcher: one weight phase, block origin b*stride, rows read from hist,
// then x, then zero, so the step concatenates nothing.  Its planes are
// int8[2, 1, kAccum * R_pad, K_pad], each set's R columns padded with zero
// columns to R_pad, a multiple of the CTA's rows (32 for kAccum 4, 64 for
// 1; ops/dense_fir.device_weights_fixed); a block stores its first R rows.
// The voip preset's fixed launch (R 160, K_pad 320, n_accum 4, B = 2048)
// needs 377.5 M int16 multiply-adds, 3.0 G int8 operations: 1.5 us at the
// 1,979 TOP/s peak, below its ~8 MB of rows, 2.4 us at 3.35 TB/s, and both
// below a launch's fixed cost.
#include "f32_fir.cuh"
#include "fixed_wgmma.cuh"

namespace {

constexpr int kLanes = 64;   // lanes of a CTA
constexpr int kTN = 4;       // lanes of a thread
constexpr int kThreads = fir::f32::threads_for(kLanes, kTN);

// grid (n_blocks * R_pad / kRowTile, ceil(B / kLanes))
__global__ void __launch_bounds__(kThreads, fir::f32::kMinBlocks)
dense_fir_f32_kernel(fir::Launch g, int stride, int rows,
                     const float* __restrict__ w) {
  const int n_rt = g.R / fir::kRowTile;
  const int b = blockIdx.x / n_rt;
  fir::f32::fir_tile<kLanes, kTN>(g, b, blockIdx.x % n_rt,
                                  blockIdx.y * kLanes, b * stride, rows, w);
}

// grid (n_blocks * R_pad / Shape<kAccum>::kRows, ceil(B / int8tc::kLanes))
template <int kAccum>
__global__ void __launch_bounds__(fir::kThreads,
                                  fir::fixedtc::Shape<kAccum>::kMinBlocks)
dense_fir_fixed_kernel(fir::Launch g, int stride, int rows,
                       const int8_t* __restrict__ planes,
                       const int32_t* __restrict__ bias,
                       const int32_t* __restrict__ coef) {
  constexpr int kRows = fir::fixedtc::Shape<kAccum>::kRows;
  const int row_tiles = g.R / kRows;
  const int b = blockIdx.x / row_tiles;
  fir::fixedtc::fir_tile<kAccum>(
      g,
      fir::Tile(g, b, blockIdx.x % row_tiles, blockIdx.y, b * stride,
                fir::int8tc::kLanes, kRows),
      planes, bias, coef, rows);
}

// Launches the n_accum kAccum fixed kernel (its shared memory set once a
// device).
template <int kAccum>
cudaError_t launch_fixed(const fir::Launch& g, int stride, int rows,
                         const int8_t* planes, const int32_t* bias,
                         const int32_t* coef, int n_blocks,
                         cudaStream_t stream) {
  using Shape = fir::fixedtc::Shape<kAccum>;
  if (g.R % Shape::kRows || rows > g.R || g.R - rows >= Shape::kRows)
    return cudaErrorInvalidValue;
  static std::atomic<unsigned> smem_set{0};
  const cudaError_t attr = fir::set_once(smem_set, [] {
    return fir::fixedtc::allow_smem<kAccum>(dense_fir_fixed_kernel<kAccum>);
  });
  if (attr != cudaSuccess) return attr;
  const dim3 grid(n_blocks * (g.R / Shape::kRows),
                  (g.B + fir::int8tc::kLanes - 1) / fir::int8tc::kLanes);
  dense_fir_fixed_kernel<kAccum><<<grid, fir::kThreads, Shape::kSmemBytes,
                                   stream>>>(g, stride, rows, planes, bias,
                                             coef);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Tile size the host wrapper must honour (R_pad % row_tile == 0; the
// table's sub-bands are f32_fir_sub_rows() rows, streamed_fir.cu).
int dense_fir_row_tile() { return fir::kRowTile; }

const char* dense_fir_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// w f32[K, R_pad] (K = L_pad, R_pad a multiple of row_tile, zero columns
// past R), 16-byte aligned; taps int32[1, R_pad / 16, 2] (each 16-row
// sub-band's nonzero taps).  y int16[n_blocks * R, B].  Launches on
// `stream`, does not synchronise, and returns cudaGetLastError() of the
// launch (0 on success).
int dense_fir_f32(const void* hist, const void* x, void* y, const void* taps,
                  const void* w, int H, int T, int B, int R_pad, int K,
                  int stride, int n_blocks, int R, void* stream) {
  cudaGetLastError();
  if (reinterpret_cast<uintptr_t>(w) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (R_pad % fir::kRowTile || R > R_pad || R_pad - R >= fir::kRowTile)
    return static_cast<int>(cudaErrorInvalidValue);
  static std::atomic<unsigned> smem_set{0};
  const cudaError_t attr = fir::set_once(smem_set, [] {
    return fir::f32::allow_smem(dense_fir_f32_kernel);
  });
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const fir::Launch g =
      fir::make_launch(hist, x, y, taps, H, T, B, R_pad, K, 1);
  const dim3 grid(n_blocks * (R_pad / fir::kRowTile),
                  (B + kLanes - 1) / kLanes);
  dense_fir_f32_kernel<<<grid, kThreads, fir::f32::smem_bytes(kLanes),
                         static_cast<cudaStream_t>(stream)>>>(
      g, stride, R, static_cast<const float*>(w));
  return static_cast<int>(cudaGetLastError());
}

// planes int8[2, 1, n_accum * R_pad, K] (K % 32 == 0, each 32-tap group
// permuted: fixed_wgmma.cuh), 16-byte aligned; bias int32[1, n_accum *
// R_pad]; coef int32[1, 4, R_pad] (NULL for n_accum 1); taps int32[1, R_pad
// / rows, 2] (rows: fixed_fir_rows).  y int16[n_blocks * R, B].  Launches
// on `stream`, does not synchronise, and returns cudaGetLastError() of the
// launch (0 on success).
int dense_fir_fixed(const void* hist, const void* x, void* y, const void* taps,
                    const void* planes, const void* bias, const void* coef,
                    int n_accum, int H, int T, int B, int R_pad, int K,
                    int stride, int n_blocks, int R, void* stream) {
  cudaGetLastError();
  if (reinterpret_cast<uintptr_t>(planes) % 16 || K % 32)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const fir::Launch g =
      fir::make_launch(hist, x, y, taps, H, T, B, R_pad, K, 1);
  const auto* p8 = static_cast<const int8_t*>(planes);
  const auto* b32 = static_cast<const int32_t*>(bias);
  const auto* c32 = static_cast<const int32_t*>(coef);
  const auto st = static_cast<cudaStream_t>(stream);
  if (n_accum == 4)
    return static_cast<int>(
        launch_fixed<4>(g, stride, R, p8, b32, c32, n_blocks, st));
  if (n_accum == 1)
    return static_cast<int>(
        launch_fixed<1>(g, stride, R, p8, b32, c32, n_blocks, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
