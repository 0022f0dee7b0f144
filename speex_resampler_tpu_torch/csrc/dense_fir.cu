// Dense padded-weight FIR launch for Hopper (sm_90a), scheme "highest".
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
// concatenation.  The staging, product and epilogue are fir_common.cuh's
// (the tiled kernel's with one weight phase, origin b*stride, K = L_pad);
// R = group*den is any width, so the last row tile is partial and masked.
//
// What bounds it on the H100: the voip launch at B = 2048 needs 94 M
// multiply-adds (filt_len 48 per output): ~2.8 us at the 33.5 T FMA/s of
// the CUDA cores, against ~7.8 MB of rows in and out, ~2.3 us at 3.35 TB/s;
// both are far below a launch's fixed cost, so what matters is not
// walking the zeros.  W is zero outside each column's filt_len taps (K3
// multiplies all L_pad rows, ~6x the needed work at voip); each 64-column
// tile walks only its nonzero tap band, and W, up to the 32 MB dense cap,
// is staged 16 tap rows at a time.
#include "fir_common.cuh"

namespace {

using fir::kLaneTile;
using fir::kThreads;

__global__ void __launch_bounds__(kThreads)
dense_fir_f32_kernel(fir::Launch g, int stride, const float* __restrict__ w) {
  const int n_rt = fir::row_tiles(g.R);
  const int b = blockIdx.x / n_rt;
  fir::fir_tile_f32(g, fir::Tile(g, b, blockIdx.x % n_rt, blockIdx.y,
                                 b * stride),
                    w);
}

}  // namespace

extern "C" {

// Tile size the host wrapper must honour (its taps table).
int dense_fir_row_tile() { return fir::kRowTile; }

const char* dense_fir_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// w f32[K, R] (K = L_pad), taps int32[1, ceil(R / row_tile), 2].  Launches
// on `stream`, does not synchronise, and returns cudaGetLastError() of the
// launch (0 on success).
int dense_fir_f32(const void* hist, const void* x, void* y, const void* taps,
                  const void* w, int H, int T, int B, int R, int K, int stride,
                  int n_blocks, void* stream) {
  cudaGetLastError();
  const fir::Launch g = fir::make_launch(hist, x, y, taps, H, T, B, R, K, 1);
  const dim3 grid(n_blocks * fir::row_tiles(R), (B + kLaneTile - 1) / kLaneTile);
  dense_fir_f32_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      g, stride, static_cast<const float*>(w));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
