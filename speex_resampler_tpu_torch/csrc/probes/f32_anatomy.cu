// Probe P6 on Hopper: the tiled f32 block on the CUDA cores split into its
// parts.  It replaces the Pallas kernel of experiments/kernel_anatomy.py
// (make :43, its pallas_call :63): with the phase-tiled weights W [P, K, R]
// of 44.1 kHz -> 48 kHz q7 (P 20, R 128, K 264, S 2352, no history) and x
// int16 [T, B], output block (period j, phase m) is
//
//   full     WORD2INT(W_m . float(x[j * S + off_m : + K]))   (f32)
//   nodot    WORD2INT(the patch's column sums), the same in all R rows
//            (exact in f32: |sum| <= 264 * 32768 < 2^24)
//   noslice  full with every block reading rows 0 .. K
//   nocvt    full, x handed over as float32 [T, B]
//
// full and noslice are the served highest body, fir::f32::fir_tile (the
// kernel of tiled_fir_f32, K1a), with the patch origin of the block or a
// constant one; a CTA is 64 rows x 128 lanes, a ring of 16-tap stages, x
// converted to f32 once a stage, an 8 x 8 register tile a thread, each warp
// running only the 8-tap slices of its 16 rows' nonzero band.  The other two
// (f32_anatomy.cuh's tile) are fir_tile with what the TPU variant drops
// taken out:
//
// - nodot: no weights and no FFMA chain against them; the CTA walks all K
//   taps of the patch (the TPU variant sums all of them) through the same
//   ring and conversion, and a thread adds its 8 lanes' column sums (an
//   FADD a lane and tap, where full has 8 FFMAs).
// - nocvt: x rows copied as f32 (twice the bytes) into the stage buffers
//   and multiplied from there: no conversion stage and no f32 buffers.
//
// What bounds it: full's 80 * 128 * 264 * 2048 = 5.54 G multiply-adds over
// the CUDA cores' 67 TFLOP/s (0.165 ms); nodot the bytes of x and y.
#include "f32_anatomy.cuh"

namespace probes {
namespace f32a {

// grid (n_blocks * R / 64, ceil(B / 128))
template <int kVar>
__global__ void __launch_bounds__(f::kThreads, f::kMinBlocks)
    f32_anatomy_kernel(fir::Launch g, const int32_t* __restrict__ offsets,
                       int S, const float* __restrict__ w,
                       const float* __restrict__ xf32) {
  const int row_tiles = g.R / fir::kRowTile;
  const int k = blockIdx.x / row_tiles, rt = blockIdx.x % row_tiles;
  const int lane0 = blockIdx.y * f::kLanes;
  const int v0 = kVar == kNoslice ? 0 : (k / g.P) * S + offsets[k % g.P];
  if constexpr (kVar == kFull || kVar == kNoslice)
    f::fir_tile(g, k, rt, lane0, v0, g.R, w);
  else
    tile<kVar>(g, k, rt, lane0, v0, w, xf32);
}

template <typename F>
int dispatch(int variant, F fn) {
#define PROBE_F32A_CASE(V) \
  if (variant == V) return fn(std::integral_constant<int, V>{});
  PROBE_F32A_CASE(kFull) PROBE_F32A_CASE(kNodot) PROBE_F32A_CASE(kNoslice)
  PROBE_F32A_CASE(kNocvt)
#undef PROBE_F32A_CASE
  return -static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace f32a
}  // namespace probes

extern "C" {

// Dynamic shared memory of one CTA of a variant.
int probe_f32_anatomy_smem(int variant) {
  return probes::f32a::dispatch(variant, [](auto v) {
    return probes::f32a::smem_bytes<decltype(v)::value>();
  });
}

// variant 0 full, 1 nodot, 2 noslice (int16 x [T, B]), 3 nocvt (f32 x [T,
// B]); y int16 [n_blocks * R, B]; w f32 [P, K, R]; taps int32 [P, R / 16,
// 2] (each 16-row sub-band's nonzero taps); offsets int32 [P]; B % 8 == 0,
// x, y and w 16-byte aligned, R % 64 == 0.  Launches on `stream`; returns
// cudaGetLastError() (0 on success).
int probe_f32_anatomy(const void* x, void* y, const void* offsets,
                      const void* taps, const void* w, int variant, int T,
                      int B, int R, int K, int P, int S, int n_blocks,
                      void* stream) {
  cudaGetLastError();
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
       reinterpret_cast<uintptr_t>(w)) % 16 ||
      B % 8 || B <= 0 || R % fir::kRowTile || P <= 0 || n_blocks % P)
    return static_cast<int>(cudaErrorInvalidValue);
  return probes::f32a::dispatch(variant, [&](auto v) {
    constexpr int kV = decltype(v)::value;
    auto kernel = probes::f32a::f32_anatomy_kernel<kV>;
    const int smem = probes::f32a::smem_bytes<kV>();
    // once a device: a CUDA graph captured after a first launch (P12's
    // step, probes/v3_bench.py) then holds no attribute call
    static std::atomic<unsigned> smem_set{0};
    const cudaError_t err = fir::set_once(smem_set, [&] {
      cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
      return e;
    });
    if (err != cudaSuccess) return static_cast<int>(err);
    const bool f32x = kV == probes::f32a::kNocvt;
    const fir::Launch g = fir::make_launch(f32x ? nullptr : x, f32x ? nullptr : x,
                                           y, taps, 0, T, B, R, K, P);
    const dim3 grid(n_blocks * (R / fir::kRowTile),
                    (B + fir::f32::kLanes - 1) / fir::f32::kLanes);
    kernel<<<grid, fir::f32::kThreads, smem,
             static_cast<cudaStream_t>(stream)>>>(
        g, static_cast<const int32_t*>(offsets), S,
        static_cast<const float*>(w), static_cast<const float*>(x));
    return static_cast<int>(cudaGetLastError());
  });
}

}  // extern "C"
