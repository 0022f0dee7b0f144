// Probe P9 on Hopper: the two float schemes' arithmetic at the flagship's
// geometry without the halo.  It replaces the Pallas kernels of
// experiments/v5_int8_bench.py, conv_int8 (:76, its pallas_call :77, body
// kern_int8 :45) and conv_split5 (:94, pallas_call :95, body kern_split5
// :62): with the phase-tiled weights of 44.1 kHz -> 48 kHz q7 (P 20, R 128,
// K 264, S 2352, no history), 4 periods (80 blocks) and x int16 [T, B],
// output block (period j, phase m) is R rows of every lane from the K-row
// patch x[j * S + offsets[m] : + K]:
//
//   int8    _dot_int8 (pallas_fir.py:108-118), D = 3 digit planes (sw 23):
//           I_d = 256 <w_d, xh> + <w_d, xl> (uint32), acc = acc +
//           float(I_d) * scale_d (__fadd_rn / __fmul_rn), then
//           WORD2INT(acc + bias[m])
//   split5  _dot_scheme's split5 (pallas_fir.py:177-184): the five bf16
//           dots <w_hi, xh>, <w_hi, xl>, <w_mid, xh>, <w_mid, xl>, <w_lo,
//           xh> in f32, summed in that order, then WORD2INT
//
// The bodies are the served ones, not copies: int8 is
// fir::int8tc::fir_tile_resident<3, true> (K1b's body, int8_wgmma.cuh: a
// CTA keeps one (phase, 64-row tile)'s digit band in shared memory and
// walks 8 output tiles of 64 lanes through two x rings, m64n64k32 s8
// wgmmas); split5 is fir::split5::fir_tile (K1c's body, split5_wgmma.cuh:
// a CTA per (block, 64-row tile, 128 lanes), five f32 accumulators over
// one walk of the band, m64n64k16 bf16 wgmmas, d_1 promoted every 64
// taps).  What differs from the served launches is only the origin: no
// history (H = 0), so row v of the virtual axis is row v of x, the TPU
// probe's plain [T, B] array, as P6's f32_anatomy.cu reads it.  The split5
// body takes K = 264 (not a multiple of its 16-tap K-slice: weight rows
// past K are zero-filled) and R = 128 (two row tiles).
//
// What bounds it: int8 the launch's bytes, ~83 MB at 3.35 TB/s (0.025 ms;
// its 6 int8 products a needed multiply-add take 0.016 ms at 1,979 TOP/s);
// split5 its 10 bf16 FLOP a needed multiply-add, 26.8 GFLOP at 989 TFLOP/s
// (0.027 ms).
#include "probe_common.cuh"
#include "split5_wgmma.cuh"

namespace probes {
namespace v5 {

constexpr int kInt8 = 0, kSplit5 = 1;
constexpr int kD = 3;                     // the int8 digit planes (sw 23)

// The resident int8 body's CTA: phase m, row tile rt, items group * kGroup
// .. of the phase's work list (tiled_fir_int8_kernel's order), the block
// origin of item i j * S + offsets[m] (j = i / lane_tiles) in x alone.
__global__ void __launch_bounds__(fir::kThreads, 1)
    v5_int8_kernel(fir::Launch g, const int32_t* __restrict__ offsets, int S,
                   int n_periods, int max_slices,
                   const int8_t* __restrict__ planes,
                   const float* __restrict__ bias, float4 scales) {
  using fir::int8tc::kGroup;
  const int lane_tiles = (g.B + fir::int8tc::kLanes - 1) / fir::int8tc::kLanes;
  const int items = n_periods * lane_tiles;
  const int groups = (items + kGroup - 1) / kGroup;
  const int mr = blockIdx.x / groups, item0 = blockIdx.x % groups * kGroup;
  const int m = mr / (g.R / fir::kRowTile);
  fir::int8tc::fir_tile_resident<kD, true>(
      g, m, mr % (g.R / fir::kRowTile), item0, min(kGroup, items - item0),
      lane_tiles, offsets[m], S, planes, bias, scales, max_slices);
}

// grid (n_blocks * R / 64, ceil(B / 128)): block k, row tile, lane tile.
__global__ void __launch_bounds__(fir::kThreads, 1)
    v5_split5_kernel(fir::Launch g, const int32_t* __restrict__ offsets,
                     int S, const __nv_bfloat16* __restrict__ planes) {
  const int row_tiles = g.R / fir::kRowTile;
  const int k = blockIdx.x / row_tiles;
  fir::split5::fir_tile(
      g,
      fir::Tile(g, k, blockIdx.x % row_tiles, blockIdx.y,
                (k / g.P) * S + offsets[k % g.P]),
      planes);
}

// The most K-slices a resident band may span (tiled_fir.cu's
// resident_slices<3>).
constexpr int max_slices() {
  using namespace fir::int8tc;
  return (kMaxSmem - resident_smem<kD>(0)) / (kD * kTileBytes);
}

}  // namespace v5
}  // namespace probes

extern "C" {

// scheme 0 int8: planes int8 [3, P, R, K] (K % 32 == 0, each 32-tap group
// K_PERM: the tiled int8 device planes), bias f32 [P, R], the digit scales
// s0..s2, max_slices the most K-slices a row tile's band spans (at most the
// resident body's); scheme 1 split5: planes bf16 [3, P, K, R] (bias and
// scales unused).  x int16 [T, B] (rows past T read as zero), y int16
// [n_blocks * R, B], offsets int32 [P], taps int32 [P, R / 64, 2]; B % 8 ==
// 0, x, y, planes and bias 16-byte aligned, R % 64 == 0.  Launches on
// `stream`; returns cudaGetLastError() (0 on success).
int probe_v5_bench(const void* x, void* y, const void* offsets,
                   const void* taps, const void* planes, const void* bias,
                   int scheme, float s0, float s1, float s2, int max_slices,
                   int T, int B, int R, int K, int P, int S, int n_blocks,
                   void* stream) {
  cudaGetLastError();
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
       reinterpret_cast<uintptr_t>(planes) |
       reinterpret_cast<uintptr_t>(bias)) % 16 ||
      B % 8 || B <= 0 || R % fir::kRowTile || P <= 0 || n_blocks % P ||
      (scheme == probes::v5::kInt8 &&
       (K % 32 || max_slices < 0 || max_slices > K / 32 ||
        max_slices > probes::v5::max_slices())) ||
      (scheme != probes::v5::kInt8 && scheme != probes::v5::kSplit5))
    return static_cast<int>(cudaErrorInvalidValue);
  const fir::Launch g = fir::make_launch(nullptr, x, y, taps, 0, T, B, R, K, P);
  const auto* off = static_cast<const int32_t*>(offsets);
  const auto st = static_cast<cudaStream_t>(stream);
  if (scheme == probes::v5::kInt8) {
    using namespace fir::int8tc;
    static std::atomic<unsigned> smem_set{0};
    const cudaError_t attr = fir::set_once(smem_set, [] {
      return allow_smem(probes::v5::v5_int8_kernel, kMaxSmem);
    });
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const int n_periods = n_blocks / P;
    const int lane_tiles = (B + kLanes - 1) / kLanes;
    const int groups = (n_periods * lane_tiles + kGroup - 1) / kGroup;
    probes::v5::v5_int8_kernel<<<P * (R / fir::kRowTile) * groups,
                                 fir::kThreads,
                                 resident_smem<probes::v5::kD>(max_slices),
                                 st>>>(
        g, off, S, n_periods, max_slices, static_cast<const int8_t*>(planes),
        static_cast<const float*>(bias), make_float4(s0, s1, s2, 0.0f));
    return static_cast<int>(cudaGetLastError());
  }
  static std::atomic<unsigned> smem_set{0};
  const cudaError_t attr = fir::set_once(smem_set, [] {
    return fir::split5::allow_smem(probes::v5::v5_split5_kernel);
  });
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(n_blocks * (R / fir::kRowTile),
                  (B + fir::kLaneTile - 1) / fir::kLaneTile);
  probes::v5::v5_split5_kernel<<<grid, fir::kThreads,
                                 fir::split5::kSmemBytes, st>>>(
      g, off, S, static_cast<const __nv_bfloat16*>(planes));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
