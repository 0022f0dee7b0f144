// Probe P1 on Hopper: the streamed int8 block at D = 4 (K2b's arithmetic)
// split into its parts.  It replaces the Pallas kernels of
// experiments/v4_overhead_anatomy.py (bench, pallas_call :53; bodies
// k_mxu :77, k_ex32 :89, k_full :99): at R, K, LB = 128, 512, 1024 a grid
// step writes out[i % 16] (int32 [R, LB]) with
//
//   mxu_only       sum_d w8[2d] . x8[0] + w8[2d+1] . x8[1]
//   extract_i32+2  w8[0] . xh + w8[1] . xl
//   full           sum_d w8[2d] . xh + w8[2d+1] . xl
//
// where xh = x16 >> 8 and xl = (x16 & 255) - 128 (the low byte ^ 0x80), all
// exact int32 sums (|sum| <= 8 * 512 * 128 * 128 < 2^31).
//
// Built from K2b's parts (int8_wgmma.cuh): the W planes K-major with each
// 32-tap group in K_PERM order (tiled_fir.int8_k_major), the descriptor
// operand; the lanes as M and x as the register operand: int16 x rows
// through int8tc::load_split (xh and xl in one ldmatrix pair and byte
// permutes, the extraction), or, for mxu_only, the pre-split int8 planes
// through probes::load_pairs (an ldmatrix.trans and byte permutes a plane,
// no arithmetic); wgmma m64nNk32 .s32.s8.s8 by int8tc::mma at N = 32 rows
// (K2b's tile) or 64.  All dots of a block go into one accumulator.
//
// Resident operands, as the TPU probe's: a CTA (one warpgroup, kN rows x
// 64 lanes) copies its planes' rows and its x lanes into shared memory
// once, then runs `iters` iterations of its block part and stores it to
// slot iteration % 16.  Eight planes of 64 rows are 256 KB at K = 512, so
// the taps are split over `groups` CTAs (K / groups each), whose partial
// tiles partial_sum adds after the loop.  Every address of an iteration
// adds `it & salt`, salt 0 at run time.
//
// What bounds it: the tensor cores (2 * 8 * R * K * LB = 1.07 G int8
// operations a block for mxu_only and full, 0.54 ms at 1,979 TOP/s a
// thousand blocks); full - mxu_only is the split's cost on top of the
// fragment loads, which tools/tc_probes.py prints beside K2b's own time a
// block.
#include "probe_common.cuh"

namespace probes {
namespace anat8 {

constexpr int kMxu = 0, kExtract = 1, kFull = 2;
constexpr int kDigits = 4;

struct Args {
  const int8_t* w;   // [8, R, K], each 32-tap group K_PERM
  const uint8_t* x;  // mxu_only: int8 [2, K, LB]; else int16 [K, LB]
  uint32_t* out;     // [groups, 16, R, LB]
  uint32_t* scratch; // [n_ctas - n_units, kN, 64]: the copies' tiles
  int R, K, LB, groups, iters, salt;
};

template <int kVar>
__host__ __device__ constexpr int planes() {
  return kVar == kExtract ? 2 : 2 * kDigits;
}

// Dynamic shared memory at kb = K / groups taps a CTA.
template <int kVar, int kN>
__host__ __device__ constexpr int smem_bytes(int kb) {
  return planes<kVar>() * kN * kb +
         (kVar == kMxu ? 2 * kb * kPitch8 : kb * kPitch16) + 128;
}

template <int kVar, int kN>
__global__ void __launch_bounds__(kWgThreads) int8_anatomy_kernel(
    const Args g) {
  constexpr int kP = planes<kVar>();
  constexpr int kRegs = kN / 2;
  extern __shared__ uint8_t anat8_smem[];
  const uint32_t wsm = (fir::smem_addr(anat8_smem) + 127) & ~127u;
  const int tid = threadIdx.x, w = tid / 32, l = tid % 32;
  const int n_lt = g.LB / kLanes, n_rt = g.R / kN;
  const int n_units = n_lt * n_rt * g.groups;
  const int u = blockIdx.x % n_units;
  const bool first = blockIdx.x < n_units;
  const int lt = u % n_lt, rt = u / n_lt % n_rt, grp = u / (n_lt * n_rt);
  const int kb = g.K / g.groups, t0 = grp * kb;
  const int n_sl = kb / kK;
  const uint32_t plane_bytes = kN * kb;
  const uint32_t xsm = wsm + kP * plane_bytes;

  for (int p = 0; p < kP; ++p)
    stage_w(wsm + p * plane_bytes,
            reinterpret_cast<const uint8_t*>(g.w) +
                ((size_t)p * g.R + rt * kN) * g.K + t0,
            g.K, kN, kb, tid, kWgThreads);
  if (kVar == kMxu) {
    for (int p = 0; p < 2; ++p)
      stage_rows(xsm + p * kb * kPitch8, kPitch8,
                 g.x + ((size_t)p * g.K + t0) * g.LB + lt * kLanes, g.LB, kb,
                 kLanes, tid, kWgThreads);
  } else {
    stage_rows(xsm, kPitch16, g.x + ((size_t)t0 * g.LB + lt * kLanes) * 2,
               (size_t)g.LB * 2, kb, kLanes * 2, tid, kWgThreads);
  }
  staged();

  // this thread's ldmatrix row in a K-slice (load_pairs, load_split)
  const uint32_t frag = kVar == kMxu ? l * kPitch8 + 16 * w
                                     : (8 * (l / 16) + l % 8) * kPitch16 +
                                           (16 * w + 8 * ((l / 8) % 2)) * 2;
  constexpr int kSliceX = kVar == kMxu ? kK * kPitch8 : kK * kPitch16;
  uint32_t* out = g.out + (size_t)grp * kSlots * g.R * g.LB;
  uint32_t* own = g.scratch + (size_t)(blockIdx.x - n_units) * kN * kLanes;
  int acc[kRegs];
#pragma unroll
  for (int i = 0; i < kRegs; ++i) acc[i] = 0;
  uint32_t xa[2][4], xb[2][4];  // xh and xl, or the planes x8[0], x8[1]
  uint32_t xs, ws;
  // K-slice sl, one commit group, its fragments in set j (as tc_rate.cu)
  auto slice = [&](auto set, int sl) {
    constexpr int j = decltype(set)::value;
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    fir::int8tc::pin(xa[j]);
    fir::int8tc::pin(xb[j]);
    if (kVar == kMxu) {
      load_pairs(xs + sl * kSliceX, xa[j]);
      load_pairs(xs + kb * kPitch8 + sl * kSliceX, xb[j]);
    } else {
      fir::int8tc::load_split(xs + sl * kSliceX, xa[j], xb[j]);
    }
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    const uint32_t wt = ws + sl * kN * kK;
#pragma unroll
    for (int d = 0; d < kP / 2; ++d) {
      fir::int8tc::mma(acc, xa[j],
                       fir::int8tc::descriptor(wt + 2 * d * plane_bytes),
                       sl > 0 || d > 0);
      fir::int8tc::mma(acc, xb[j],
                       fir::int8tc::descriptor(wt + (2 * d + 1) * plane_bytes),
                       1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  };
#pragma unroll 1
  for (int it = 0; it < g.iters; ++it) {
    const uint32_t salt = (uint32_t)it & (uint32_t)g.salt;
    xs = xsm + frag + salt;
    ws = wsm + salt;
    // whole pairs, then an odd last slice (tc_rate.cu)
#pragma unroll 1
    for (int s = 0; s + 1 < n_sl; s += 2) {
      slice(std::integral_constant<int, 0>{}, s);
      slice(std::integral_constant<int, 1>{}, s + 1);
    }
    if (n_sl % 2) slice(std::integral_constant<int, 0>{}, n_sl - 1);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fir::int8tc::pin(acc);
    uint32_t* slot = out + (size_t)(it % kSlots) * g.R * g.LB;
#pragma unroll
    for (int i = 0; i < kRegs; ++i) {
      const int lane = tile_lane<kVar == kMxu>(w, l, i), col = tile_col(l, i);
      if (first)
        slot[(size_t)(rt * kN + col) * g.LB + lt * kLanes + lane] =
            (uint32_t)acc[i];
      else
        own[col * kLanes + lane] = (uint32_t)acc[i];
    }
  }
}

template <int kVar, int kN>
int launch(const void* w, const void* x, void* out, void* partial,
           void* scratch, int R, int K, int LB, int groups, int n_ctas,
           int iters, int salt, cudaStream_t stream) {
  const int smem = smem_bytes<kVar, kN>(K / groups);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = int8_anatomy_kernel<kVar, kN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args g{static_cast<const int8_t*>(w), static_cast<const uint8_t*>(x),
               static_cast<uint32_t*>(groups > 1 ? partial : out),
               static_cast<uint32_t*>(scratch), R, K, LB, groups, iters, salt};
  kernel<<<n_ctas, kWgThreads, smem, stream>>>(g);
  err = cudaGetLastError();
  if (err == cudaSuccess && groups > 1)
    err = partial_sum(partial, out, groups, (long long)kSlots * R * LB,
                      stream);
  return static_cast<int>(err);
}

template <typename F>
int dispatch(int variant, int n, F f) {
#define PROBE_ANAT8_CASE(V, N) \
  if (variant == V && n == N) return f(std::integral_constant<int, V>{}, \
                                       std::integral_constant<int, N>{});
  PROBE_ANAT8_CASE(kMxu, 32) PROBE_ANAT8_CASE(kMxu, 64)
  PROBE_ANAT8_CASE(kExtract, 32) PROBE_ANAT8_CASE(kExtract, 64)
  PROBE_ANAT8_CASE(kFull, 32) PROBE_ANAT8_CASE(kFull, 64)
#undef PROBE_ANAT8_CASE
  return -static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace anat8
}  // namespace probes

extern "C" {

// Dynamic shared memory of one CTA (tiled in ops: probes/v4_overhead_anatomy.py).
int probe_int8_anatomy_smem(int variant, int n, int K, int groups) {
  return probes::anat8::dispatch(variant, n, [&](auto v, auto nn) {
    return probes::anat8::smem_bytes<decltype(v)::value, decltype(nn)::value>(
        K / groups);
  });
}

int probe_int8_anatomy_fill(int variant, int n, int R, int K, int LB,
                            int groups) {
  return probes::anat8::dispatch(variant, n, [&](auto v, auto nn) {
    constexpr int kV = decltype(v)::value, kN = decltype(nn)::value;
    return probes::fill(probes::anat8::int8_anatomy_kernel<kV, kN>,
                        probes::kWgThreads,
                        probes::anat8::smem_bytes<kV, kN>(K / groups),
                        (R / kN) * (LB / probes::kLanes) * groups);
  });
}

// variant 0 mxu_only (x int8 [2, K, LB]), 1 extract_i32+2, 2 full (x int16
// [K, LB]); w int8 [8, R, K] (extract_i32+2 reads planes 0-1), each 32-tap
// group K_PERM; both 16-byte aligned; n 32 or 64 (the wgmma's N); R % n ==
// 0, LB % 64 == 0, K % (32 * groups) == 0; out int32 [16, R, LB]; partial
// int32 [groups, 16, R, LB] where groups > 1; scratch int32 [n_ctas -
// units, n, 64] where n_ctas > the units (R / n) * (LB / 64) * groups
// (n_ctas >= the units); salt 0.  Launches on `stream`; returns
// cudaGetLastError() (0 on success).
int probe_int8_anatomy(const void* w, const void* x, void* out, void* partial,
                       void* scratch, int variant, int n, int R, int K, int LB,
                       int groups, int n_ctas, int iters, int salt,
                       void* stream) {
  cudaGetLastError();
  if ((reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(x)) % 16 ||
      n <= 0 || R % n || LB % probes::kLanes || groups <= 0 ||
      K % (32 * groups) || n_ctas < (R / n) * (LB / probes::kLanes) * groups)
    return static_cast<int>(cudaErrorInvalidValue);
  return probes::anat8::dispatch(variant, n, [&](auto v, auto nn) {
    return probes::anat8::launch<decltype(v)::value, decltype(nn)::value>(
        w, x, out, partial, scratch, R, K, LB, groups, n_ctas, iters, salt,
        static_cast<cudaStream_t>(stream));
  });
}

}  // extern "C"
