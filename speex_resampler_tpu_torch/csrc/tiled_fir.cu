// The resident int8 launch of the "tiled" geometry for Hopper (sm_90a):
// K1b, what "auto" serves at the flagship (44.1 kHz -> 48 kHz q7).
//
// Replaces speex_resampler_tpu/ops/pallas_fir.py resample_conv_tm_pallas_v3
// / _kernel_v3 with _dot_int8 (the TPU kernel of the batched serving path)
// where a row tile's digit band fits shared memory; every other
// phase-tiled launch, the tiled geometry's other schemes and its int8
// bands past that memory included, is streamed_fir.cu's.  It computes the
// same function: output block k (R rows, all lanes) is
//
//     y_k = epilogue( W[k % P]^T [R, K] @ patch_k [K, B] ),
//     patch_k = rows v0 .. v0+K-1 of the virtual axis hist ++ x,
//     v0      = floor16((f0 + k*R*num) / den + shift)
//             = (k / P) * S + origin(k % P),   S = P*R*num / den,
//
// with time-major int16 [rows, B] buffers and lanes minor (fir_common.cuh's
// closed-form origin; S, a multiple of 16, is the input rows of one weight
// period).  The TPU kernel assembled each patch in VMEM from static copy
// plans over overlapping chunk views; here every CTA computes its phase's
// origin once and reads tap row v0+t from hist when v0+t < H, else from x,
// so one compiled kernel serves every fractional phase f0 a flush
// rebuilds.
//
// What bounds it on the H100.  One flagship launch (B = 2048) reads ~38 MB
// of real int16 rows and writes 42 MB, ~25 us at 3.35 TB/s; it needs 2.7 G
// multiply-adds (filt_len 128 per output; 5.5 G over the dense K = 264),
// 16 us at the int8 tensor cores' 1,979 TOP/s for the 2*D int8 products of
// D = 3.  A CTA walks only the nonzero tap band of its weight columns (a
// block's R outputs start ~R*num/den rows apart, so one 64-row tile needs
// filt_len + 64*num/den of the K taps, ~70% at the flagship).
//
// It runs on the int8 tensor cores (int8_wgmma.cuh): xh / xl as the
// register operand, 2*D exact int32 dots in one walk of the band, the f32
// epilogue in digit order.  Its planes are K-major, int8[D, P, R, K_pad]
// (K padded to a multiple of 32, each 32-tap group permuted; JAX's are [D,
// P, K, R]).  Every block of phase m applies the same weights, so
// tiled_fir_int8_kernel<D, kVec> gives a CTA one (phase, 64-row tile) and
// kGroup of the n_blocks / P x ceil(B / 64) output tiles that share its
// digit band: the band is copied into shared memory once, and only x
// streams, each warpgroup through its own ring (int8tc::fir_tile_resident;
// kVec: 16-byte x copies, where B % 8 == 0 and hist and x are 16-byte
// aligned, else 2-byte loads).  Where a band does not fit its shared
// memory (D x 64 rows x span bytes; the span is the host's, computed once
// per step, which then launches streamed_fir_int8_kernel instead),
// tiled_fir_int8 refuses the launch.

#include "fir_common.cuh"
#include "int8_wgmma.cuh"

namespace {

using fir::kRowTile;
using fir::kThreads;

// grid P * (R / kRowTile) * groups, groups = ceil(n_periods * lane_tiles /
// kGroup): CTA ((m * row_tiles + rt) * groups + group) takes items group *
// kGroup .. of phase m's work list (int8tc::fir_tile_resident), so the
// CTAs of one phase sit next to each other.  kVec: x rows 16-byte aligned.
template <int kD, bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
tiled_fir_int8_kernel(fir::Launch g, fir::Origin o, int S, int n_periods,
                      int max_slices, const int8_t* __restrict__ planes,
                      const float* __restrict__ bias, float4 scales) {
  using fir::int8tc::kGroup;
  const int lane_tiles = (g.B + fir::int8tc::kLanes - 1) / fir::int8tc::kLanes;
  const int items = n_periods * lane_tiles;
  const int groups = (items + kGroup - 1) / kGroup;
  const int mr = blockIdx.x / groups, item0 = blockIdx.x % groups * kGroup;
  const int m = mr / (g.R / kRowTile);
  fir::int8tc::fir_tile_resident<kD, kVec>(
      g, m, mr % (g.R / kRowTile), item0, min(kGroup, items - item0),
      lane_tiles, fir::origin(g, o, m), S, planes, bias, scales, max_slices);
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
cudaError_t launch_resident(const fir::Launch& g, fir::Origin o, int S,
                            const int8_t* planes, const float* bias,
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
      g, o, S, n_periods, max_slices, planes, bias, scales);
  return cudaGetLastError();
}

// Launches the resident kD-plane int8 kernel where a band of max_slices
// K-slices fits it, else refuses.
template <int kD>
cudaError_t launch_int8(const fir::Launch& g, fir::Origin o, int S,
                        const int8_t* planes, const float* bias,
                        float4 scales, int max_slices, int n_blocks,
                        cudaStream_t stream) {
  if (max_slices > resident_slices<kD>()) return cudaErrorInvalidValue;
  const bool vec = g.B % 8 == 0 &&
                   (reinterpret_cast<uintptr_t>(g.hist) |
                    reinterpret_cast<uintptr_t>(g.x)) % 16 == 0;
  return vec ? launch_resident<kD, true>(g, o, S, planes, bias, scales,
                                         max_slices, n_blocks, stream)
             : launch_resident<kD, false>(g, o, S, planes, bias, scales,
                                          max_slices, n_blocks, stream);
}

}  // namespace

extern "C" {

// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() of the launch (0 on success; streamed_fir_error_string
// names it).  planes int8[D, P, R, K] (K % 32 == 0, each 32-tap group
// permuted: int8_wgmma.cuh) and bias f32[P, R], 16-byte aligned; 1 <= D <=
// 4; taps int32[P, R / 64, 2]; max_slices: the most 32-tap K-slices any row
// tile's band spans (from its t_lo rounded down to 32; tiled_fir.band_slices),
// at most tiled_fir_int8_max_slices(D); the origin's shift, num, den and f0
// as streamed_fir.cu's, n_blocks a multiple of P, and P*R*num / den a
// multiple of 16.
int tiled_fir_int8(const void* hist, const void* x, void* y,
                   const void* taps, const void* planes, const void* bias,
                   int D, float s0, float s1, float s2, float s3,
                   int max_slices, int H, int T, int B, int R, int K, int P,
                   int n_blocks, int shift, int num, int den, int f0,
                   void* stream) {
  cudaGetLastError();
  if ((reinterpret_cast<uintptr_t>(planes) |
       reinterpret_cast<uintptr_t>(bias)) % 16 || K % 32)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const long long period = (long long)P * R * num;
  const long long S = den > 0 ? period / den : 0;
  if (max_slices < 0 || max_slices > K / 32 || den <= 0 || period % den ||
      S % 16 || S > INT32_MAX || n_blocks % P)
    return static_cast<int>(cudaErrorInvalidValue);
  const fir::Launch g = fir::make_launch(hist, x, y, taps, H, T, B, R, K, P);
  const fir::Origin o = fir::make_origin(shift, num, den, f0);
  const auto* p8 = static_cast<const int8_t*>(planes);
  const auto* b32 = static_cast<const float*>(bias);
  const float4 s = make_float4(s0, s1, s2, s3);
  const auto st = static_cast<cudaStream_t>(stream);
  const int S32 = static_cast<int>(S), ms = max_slices, nb = n_blocks;
  cudaError_t err = cudaErrorInvalidValue;
  if (D == 4) err = launch_int8<4>(g, o, S32, p8, b32, s, ms, nb, st);
  if (D == 3) err = launch_int8<3>(g, o, S32, p8, b32, s, ms, nb, st);
  if (D == 2) err = launch_int8<2>(g, o, S32, p8, b32, s, ms, nb, st);
  if (D == 1) err = launch_int8<1>(g, o, S32, p8, b32, s, ms, nb, st);
  return static_cast<int>(err);
}

// The most K-slices a band may span for the resident int8 kernel with D
// digit planes (0 for another D): a step with a longer band launches
// streamed_fir_int8_kernel.
int tiled_fir_int8_max_slices(int D) {
  return D == 1 ? resident_slices<1>() : D == 2 ? resident_slices<2>()
       : D == 3 ? resident_slices<3>() : D == 4 ? resident_slices<4>() : 0;
}

}  // extern "C"
