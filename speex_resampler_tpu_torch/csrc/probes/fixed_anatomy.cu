// Probe P2 on Hopper: the fixed interpolated block (K1e's arithmetic, and
// K2d's) as a ladder of rungs.  It replaces the Pallas kernels of
// experiments/fixed_interp_anatomy.py (run, pallas_call :68; bodies k_mxu
// :105, k_comb :124, twice, and k_full :140): at R, K, LB = 128, 264, 128
// and C = 4R = 512 accumulator-major plane rows (row c*R + r: column set
// c), a grid step sums body(r) over r = 0..3 in int16 (wrapping) and
// writes the sum to out[i % 16] (int16 [R, LB]).  Each body salts x's
// element [0, 0] with +r in x's own type (wrapping), then:
//
//   mxu_only  xs = xh + salt, xs2 = xs + 1 (int8); acc = wh.xs + wh.xs2 +
//             wl.xs + wl.xs2; acc[:R] cast to int16
//   +combine  _dot_fixed(planes, bias, xh as int16 + salt)[:R] to int16
//   +extract  the same with x16 + salt
//   full      _fixed_mix_rows(_dot_fixed(planes, bias, x16 + salt), coef)
//
// where _dot_fixed (speex_resampler_tpu/ops/pallas_fir.py:149) is
// 65536*<wh, xh> + 256*(<wh, xl> + <wl, xh>) + <wl, xl> + bias mod 2^32
// with xh = x >> 8, xl = (x & 255) - 128, and _fixed_mix_rows sums
// MULT16_32_Q15(coef[c][r], acc_c >> 1) over the four sets in uint32 and
// applies SATURATE32PSHR(., 15, 32767).  +combine and +extract are one
// kernel with two inputs, as on the TPU.
//
// Built from the served code: fixed_wgmma.cuh's four-pass s8 wgmma form
// (fir::fixedtc) at K1e's tile, Shape<4>: a warpgroup takes 16 rows x 4
// column sets (N = 64, set-major), a CTA two warpgroups (32 rows) and 64
// lanes; x through int8tc::load_split (mxu_only: the int8 xh rows through
// probes::load_pairs, xs2 by one byte-wise add a register); planes
// K-major, each 32-tap group K_PERM, K padded with zero taps to a
// multiple of 32 (264 -> 288); fir::mult16_32_q15 and fir::sat32pshr15
// for the mix.
//
// Resident operands: a CTA copies its planes' rows, its x lanes, its
// biases and coefficients into shared memory once.  A rep's salt is one
// shared store of x[0][0] (by the CTA holding lane 0) between two
// barriers, so the x it reads is the body's.  The rep sums stay in
// registers; a grid step's tile leaves as int16 stores to slot i % 16.
//
// What bounds it: the tensor cores, 8 int8 operations a multiply-add of
// the four dots (4 * C * K * LB multiply-adds a block, 0.56 G at K = 264),
// plus the epilogue's integer work on [C, LB]; tools/tc_probes.py prints
// each rung's time a block and the deltas beside K1e's and K2d's own time a
// block.
#include "probe_common.cuh"

#include "fixed_wgmma.cuh"

namespace probes {
namespace anat16 {

constexpr int kMxu = 0, kCombine = 1, kFull = 2;
using Sh = fir::fixedtc::Shape<4>;
constexpr int kTileRows = 2 * Sh::kN;  // B rows a K-slice tile: 2 warpgroups
constexpr int kThreads = 2 * kWgThreads;
static_assert(Sh::kN == 64 && Sh::kRows == 32 && Sh::kPer == 8,
              "K1e's tile: 16 rows x 4 column sets a warpgroup");

struct Args {
  const int8_t* planes;  // [2, C, K]: wh, wl; each 32-tap group K_PERM
  const int32_t* bias;   // [C]
  const int32_t* coef;   // [4, R]
  const uint8_t* x;      // mxu_only: int8 [K, LB]; else int16 [K, LB]
  int16_t* out;          // [16, R, LB]
  int16_t* scratch;      // [n_ctas - n_units, 32, 64]: the copies' tiles
  int R, K, LB, iters, salt;
};

// Dynamic shared memory: two planes' tiles, the x rows, alignment.
template <int kRung>
__host__ __device__ constexpr int smem_bytes(int K) {
  return 2 * kTileRows * K + K * (kRung == kMxu ? kPitch8 : kPitch16) + 128;
}

template <int kRung>
__global__ void __launch_bounds__(kThreads) fixed_anatomy_kernel(
    const Args g) {
  constexpr bool kMx = kRung == kMxu;
  constexpr int kPitch = kMx ? kPitch8 : kPitch16;
  extern __shared__ uint8_t anat16_smem[];
  __shared__ int32_t bias_s[4][Sh::kRows], coef_s[4][Sh::kRows];
  const uint32_t wsm = (fir::smem_addr(anat16_smem) + 127) & ~127u;
  const int tid = threadIdx.x, h = tid / kWgThreads;
  const int w = tid % kWgThreads / 32, l = tid % 32;
  const int n_lt = g.LB / kLanes;
  const int n_units = n_lt * (g.R / Sh::kRows);
  const int u = blockIdx.x % n_units;
  const bool first = blockIdx.x < n_units;
  int16_t* own = g.scratch + (size_t)(blockIdx.x - n_units) * Sh::kRows * kLanes;
  const int lt = u % n_lt, rt = u / n_lt;
  const int n_sl = g.K / kK;
  const uint32_t plane_bytes = kTileRows * g.K;
  const uint32_t xsm = wsm + 2 * plane_bytes;

  // B row 64h' + 16c + j of a tile: plane row c*R + 32rt + 16h' + j
  for (int p = 0; p < 2; ++p)
    for (int hc = 0; hc < 8; ++hc) {
      const int hh = hc / 4, c = hc % 4;
      stage_w(wsm + p * plane_bytes,
              reinterpret_cast<const uint8_t*>(g.planes) +
                  ((size_t)p * 4 * g.R + c * g.R + rt * Sh::kRows +
                   hh * Sh::kWgRows) * g.K,
              g.K, Sh::kWgRows, g.K, tid, kThreads, kTileRows,
              hh * Sh::kN + c * Sh::kWgRows);
    }
  stage_rows(xsm, kPitch, g.x + (size_t)lt * kLanes * (kMx ? 1 : 2),
             (size_t)g.LB * (kMx ? 1 : 2), g.K, kLanes * (kMx ? 1 : 2), tid,
             kThreads);
  if (tid < 4 * Sh::kRows) {
    const int c = tid / Sh::kRows, r = tid % Sh::kRows;
    bias_s[c][r] = g.bias[c * g.R + rt * Sh::kRows + r];
    coef_s[c][r] = g.coef[c * g.R + rt * Sh::kRows + r];
  }
  staged();
  const bool salter = lt == 0 && tid == 0;
  int orig = 0;
  if (salter) {
    if (kMx)
      asm volatile("ld.shared.s8 %0, [%1];\n" : "=r"(orig) : "r"(xsm));
    else
      asm volatile("ld.shared.s16 %0, [%1];\n" : "=r"(orig) : "r"(xsm));
  }

  // this thread's ldmatrix row in a K-slice (load_pairs, load_split)
  const uint32_t frag = kMx ? l * kPitch8 + 16 * w
                            : (8 * (l / 16) + l % 8) * kPitch16 +
                                  (16 * w + 8 * ((l / 8) % 2)) * 2;
  int acc[3][Sh::kAcc];  // hh, mid, ll (mxu_only: acc[0] alone)
  uint32_t xa[2][4], xb[2][4];  // xh and xl, or xs and xs2
  uint32_t xs, ws;
  // K-slice sl, one commit group, its fragments in set j (as tc_rate.cu)
  auto slice = [&](auto set, int sl) {
    constexpr int j = decltype(set)::value;
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    fir::int8tc::pin(xa[j]);
    fir::int8tc::pin(xb[j]);
    if constexpr (kMx) {
      load_pairs(xs + sl * kK * kPitch, xa[j]);
#pragma unroll
      for (int r = 0; r < 4; ++r) xb[j][r] = __vadd4(xa[j][r], 0x01010101u);
    } else {
      fir::int8tc::load_split(xs + sl * kK * kPitch, xa[j], xb[j]);
    }
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    const uint64_t bh = fir::int8tc::descriptor(ws + sl * kTileRows * kK);
    const uint64_t bl =
        fir::int8tc::descriptor(ws + plane_bytes + sl * kTileRows * kK);
    if constexpr (kMx) {
      fir::fixedtc::mma(acc[0], xa[j], bh, sl > 0);
      fir::fixedtc::mma(acc[0], xb[j], bh, 1);
      fir::fixedtc::mma(acc[0], xa[j], bl, 1);
      fir::fixedtc::mma(acc[0], xb[j], bl, 1);
    } else {
      fir::fixedtc::mma(acc[0], xa[j], bh, sl > 0);
      fir::fixedtc::mma(acc[1], xb[j], bh, sl > 0);
      fir::fixedtc::mma(acc[1], xa[j], bl, 1);
      fir::fixedtc::mma(acc[2], xb[j], bl, sl > 0);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  };
#pragma unroll 1
  for (int it = 0; it < g.iters; ++it) {
    const uint32_t salt = (uint32_t)it & (uint32_t)g.salt;
    xs = xsm + frag + salt;
    ws = wsm + h * (Sh::kN / 8) * 256 + salt;
    uint32_t sum[Sh::kPer];
#pragma unroll
    for (int e = 0; e < Sh::kPer; ++e) sum[e] = 0;
#pragma unroll 1
    for (int rep = 0; rep < 4; ++rep) {
      // every read of the last rep's x is done; then the salted x[0][0]
      __syncthreads();
      if (salter) {
        if (kMx)
          asm volatile("st.shared.u8 [%0], %1;\n" ::"r"(xsm), "r"(orig + rep)
                       : "memory");
        else
          asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(xsm),
                       "h"((uint16_t)(orig + rep))
                       : "memory");
      }
      __syncthreads();
      // whole pairs, then an odd last slice (tc_rate.cu)
#pragma unroll 1
      for (int s = 0; s + 1 < n_sl; s += 2) {
        slice(std::integral_constant<int, 0>{}, s);
        slice(std::integral_constant<int, 1>{}, s + 1);
      }
      if (n_sl % 2) slice(std::integral_constant<int, 0>{}, n_sl - 1);
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
      for (int k = 0; k < (kMx ? 1 : 3); ++k) fir::int8tc::pin(acc[k]);
      // register set * kPer + e: column set `set`, tile row r (below)
#pragma unroll
      for (int e = 0; e < Sh::kPer; ++e) {
        const int r = h * Sh::kWgRows + 8 * (e / 4) + 2 * (l % 4) + e % 2;
        if constexpr (kRung == kMxu) {
          sum[e] += (uint32_t)acc[0][e];
        } else if constexpr (kRung == kCombine) {
          sum[e] += 65536u * (uint32_t)acc[0][e] + 256u * (uint32_t)acc[1][e] +
                    (uint32_t)acc[2][e] + (uint32_t)bias_s[0][r];
        } else {
          uint32_t mix = 0;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int i = c * Sh::kPer + e;
            const uint32_t dot = 65536u * (uint32_t)acc[0][i] +
                                 256u * (uint32_t)acc[1][i] +
                                 (uint32_t)acc[2][i] + (uint32_t)bias_s[c][r];
            mix += fir::mult16_32_q15(coef_s[c][r], (int)dot >> 1);
          }
          sum[e] += (uint32_t)(uint16_t)fir::sat32pshr15((int)mix);
        }
      }
    }
    int16_t* slot = g.out + (size_t)(it % kSlots) * g.R * g.LB;
#pragma unroll
    for (int e = 0; e < Sh::kPer; ++e) {
      const int r = h * Sh::kWgRows + 8 * (e / 4) + 2 * (l % 4) + e % 2;
      const int lane = tile_lane<kMx>(w, l, e);
      if (first)
        slot[(size_t)(rt * Sh::kRows + r) * g.LB + lt * kLanes + lane] =
            (int16_t)sum[e];
      else
        own[r * kLanes + lane] = (int16_t)sum[e];
    }
  }
}

template <int kRung>
int launch(const Args& g, int n_ctas, cudaStream_t stream) {
  const int smem = smem_bytes<kRung>(g.K);
  auto kernel = fixed_anatomy_kernel<kRung>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<n_ctas, kThreads, smem, stream>>>(g);
  return static_cast<int>(cudaGetLastError());
}

template <typename F>
int dispatch(int rung, F f) {
  if (rung == kMxu) return f(std::integral_constant<int, kMxu>{});
  if (rung == kCombine) return f(std::integral_constant<int, kCombine>{});
  if (rung == kFull) return f(std::integral_constant<int, kFull>{});
  return -static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace anat16
}  // namespace probes

extern "C" {

// Dynamic shared memory of one CTA (tiled in ops: probes/fixed_interp_anatomy.py).
int probe_fixed_anatomy_smem(int rung, int K) {
  return probes::anat16::dispatch(rung, [&](auto r) {
    return probes::anat16::smem_bytes<decltype(r)::value>(K);
  });
}

// The rows and lanes of one CTA's tile.
int probe_fixed_anatomy_rows() { return probes::anat16::Sh::kRows; }

int probe_fixed_anatomy_fill(int rung, int R, int K, int LB) {
  return probes::anat16::dispatch(rung, [&](auto r) {
    constexpr int kR = decltype(r)::value;
    return probes::fill(probes::anat16::fixed_anatomy_kernel<kR>,
                        probes::anat16::kThreads,
                        probes::anat16::smem_bytes<kR>(K),
                        (R / probes::anat16::Sh::kRows) *
                            (LB / probes::kLanes));
  });
}

// rung 0 mxu_only (x int8 [K, LB]: xh), 1 +combine / +extract, 2 full (x
// int16 [K, LB]); planes int8 [2, 4R, K] (wh, wl; each 32-tap group K_PERM),
// bias int32 [4R], coef int32 [4, R]; planes and x 16-byte aligned; R % 32
// == 0, LB % 64 == 0, K % 32 == 0; out int16 [16, R, LB]; scratch int16
// [n_ctas - units, 32, 64] where n_ctas > the units (R / 32) * (LB / 64)
// (n_ctas >= the units); salt 0.  Launches on `stream`; returns
// cudaGetLastError() (0 on success).
int probe_fixed_anatomy(const void* planes, const void* bias,
                        const void* coef, const void* x, void* out,
                        void* scratch, int rung,
                        int R, int K, int LB, int n_ctas, int iters, int salt,
                        void* stream) {
  cudaGetLastError();
  if ((reinterpret_cast<uintptr_t>(planes) | reinterpret_cast<uintptr_t>(x)) %
          16 ||
      R % probes::anat16::Sh::kRows || LB % probes::kLanes || K % 32 ||
      n_ctas < (R / probes::anat16::Sh::kRows) * (LB / probes::kLanes) ||
      probe_fixed_anatomy_smem(rung, K) > probes::kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const probes::anat16::Args g{
      static_cast<const int8_t*>(planes), static_cast<const int32_t*>(bias),
      static_cast<const int32_t*>(coef), static_cast<const uint8_t*>(x),
      static_cast<int16_t*>(out), static_cast<int16_t*>(scratch), R, K, LB,
      iters, salt};
  return probes::anat16::dispatch(rung, [&](auto r) {
    return probes::anat16::launch<decltype(r)::value>(
        g, n_ctas, static_cast<cudaStream_t>(stream));
  });
}

}  // extern "C"
