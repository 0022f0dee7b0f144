// Probe P8 on Hopper: the FIR dot at each precision of the matrix unit.  It
// replaces the Pallas kernel of experiments/prec_bench.py (kern :43, conv
// :53, its pallas_call :55): the padded weights of 44.1 kHz -> 48 kHz q7
// (W [L = 294, R = 160], two 147-row halves), x int16 [T, B] and 64
// output blocks, block j being
//
//   y[j] = WORD2INT(W . x[j * 147 : j * 147 + 294])
//
// with the products taken as each TPU precision takes them:
//
//   HIGHEST  f32 x f32 (mode 0): the dense kernel's body (K3,
//            fir::f32::fir_tile on the CUDA cores: one FFMA chain in tap
//            order per output, 64 lanes a CTA, 4 a thread)
//   DEFAULT  bf16(W) . bf16(x), f32 sums (mode 1): one bf16 wgmma a K-slice
//   HIGH     XLA's bf16_3x (mode 2): a = a_hi + a_lo, a_hi = bf16(a), a_lo
//            = bf16(a - a_hi) for W and x, and W_hi . x_hi + W_hi . x_lo +
//            W_lo . x_hi in f32: three bf16 wgmmas a K-slice
//   TF32     tf32(W) . tf32(x), f32 sums (mode 3): Hopper's own middle
//            mode, one tf32 wgmma a K-slice; both operands rounded by
//            cvt.rna.tf32.f32 (nearest, ties away from zero), W on the host
//            (probes/prec_bench.py tf32_rna), x in the kernel, so no low bit
//            is left for the wgmma to drop
//
// Modes 1-3 follow split5_wgmma.cuh (K1c's header): a CTA is fir::Tile's 64
// rows x 128 lanes, warpgroup h on lanes 64h .., the lanes as M and x the
// register operand (ldmatrix.trans of the int16 rows), the weights the
// shared-memory one; a ring of kStages 32-tap stages copied kLead ahead by
// cp.async; every dot its own accumulator (mixed into one, the small dots
// would round at the large one's scale), and the first, the largest,
// restarted every kPromote stages into a __fadd_rn total, as split5 does.
// bf16 weights are [planes, K, R_pad] tap rows, read N-major through the
// 128-byte swizzle (split5::descriptor, split5::mma); tf32 takes no
// transposed operand, so its weights are [R_pad, K] K-major (no swizzle,
// int8tc::descriptor: an 8-tap K-slice is 32 bytes a row, as an int8
// one), each 8 taps in the order the fragment reads them: an
// ldmatrix.x2.trans gives a thread taps 2t and 2t + 1 of its lanes, which
// the m64nNk8 tf32 A fragment holds at K positions t and t + 4, so K
// position p holds tap 2p (p < 4) or 2(p - 4) + 1.
//
// What bounds it: 6.17 G multiply-adds: HIGHEST 0.184 ms at 67 TFLOP/s;
// DEFAULT 12.5 us at 989 TFLOP/s, under its 81.7 MB of bytes (0.0244 ms);
// HIGH 37.4 us; TF32 24.9 us at 495 TFLOP/s.
#include <cuda_bf16.h>

#include "f32_fir.cuh"
#include "int8_wgmma.cuh"
#include "split5_wgmma.cuh"

namespace probes {
namespace prec {

namespace s5 = fir::split5;

constexpr int kHighest = 0, kDefault = 1, kHigh = 2, kTf32 = 3;
constexpr int kDenseLanes = 64, kDenseTN = 4;     // the dense kernel's CTA
constexpr int kStageTaps = 32;
constexpr int kLead = 3;
constexpr int kStages = kLead + 2;
constexpr int kPromote = 2;
constexpr int kRawPitch = s5::kRawPitch;          // 128 int16 lanes, padded
constexpr int kRawBytes = kStageTaps * kRawPitch;
constexpr int kTf32Tile = 8 * 4 * fir::kRowTile;  // [64 rows x 8 taps] f32

template <int kMode>
__host__ __device__ constexpr int dots() {
  return kMode == kHigh ? 3 : 1;
}
template <int kMode>
__host__ __device__ constexpr int slice_taps() {
  return kMode == kTf32 ? 8 : 16;
}
// a stage's weight bytes: bf16 planes (hi; hi and lo) of two 16-tap
// swizzled tiles, or four 8-tap tf32 tiles
template <int kMode>
__host__ __device__ constexpr int w_bytes() {
  return kMode == kTf32 ? 4 * kTf32Tile
                        : (kMode == kHigh ? 2 : 1) * 2 * s5::kTileBytes;
}
template <int kMode>
__host__ __device__ constexpr int stage_bytes() {
  return (w_bytes<kMode>() + kRawBytes + 1023) / 1024 * 1024;
}
template <int kMode>
constexpr int smem_bytes() {
  return kMode == kHighest ? fir::f32::smem_bytes(kDenseLanes)
                           : kStages * stage_bytes<kMode>() + 1024;
}

// d (+)= A . B, m64n64k8 f32 += tf32 x tf32: A [64 lanes x 8 taps] in
// registers, B [8 taps x 64 rows] K-major in shared memory.
__device__ __forceinline__ void mma_tf32(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// An int16 as tf32, nearest with ties away from zero (cvt.rna).
__device__ __forceinline__ uint32_t tf32(uint32_t bits16) {
  const float v = (float)(int16_t)(bits16 & 0xFFFF);
  uint32_t t;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(t) : "f"(v));
  return t;
}

// The tf32 A fragment of the 8-tap K-slice whose first x row `at` is this
// thread's ldmatrix row for lanes 16w + 8*((l/8)%2) .. (threads 0-15's
// addresses): register p of the x2.trans holds taps 2t, 2t + 1 of lane g +
// 8p; a0 / a1 take tap 2t of lanes g / g + 8 (K position t), a2 / a3 tap
// 2t + 1 (K position t + 4).
__device__ __forceinline__ void load_tf32(uint32_t at, uint32_t (&a)[4]) {
  uint32_t m0, m1;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(m0), "=r"(m1)
      : "r"(at)
      : "memory");
  a[0] = tf32(m0);
  a[1] = tf32(m1);
  a[2] = tf32(m0 >> 16);
  a[3] = tf32(m1 >> 16);
}

__device__ __forceinline__ void pin(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// HIGHEST: the dense kernel.  grid (n_blocks * R_pad / 64, ceil(B / 64))
__global__ void __launch_bounds__(fir::f32::threads_for(kDenseLanes, kDenseTN),
                                  fir::f32::kMinBlocks)
    prec_f32_kernel(fir::Launch g, int stride, int rows,
                    const float* __restrict__ w) {
  const int n_rt = g.R / fir::kRowTile;
  const int b = blockIdx.x / n_rt;
  fir::f32::fir_tile<kDenseLanes, kDenseTN>(g, b, blockIdx.x % n_rt,
                                            blockIdx.y * kDenseLanes,
                                            b * stride, rows, w);
}

// DEFAULT, HIGH, TF32: the output tile (block k, row tile rt of 64 rows,
// lanes lane0 .. + 127) of g (P 1, R the stored rows), from weights w (bf16
// [dots > 1 ? 2 : 1, K, R_pad], or f32 [R_pad, K] for tf32) and the 64-row
// tap table g.taps [1, R_pad / 64, 2].  grid (n_blocks * R_pad / 64,
// ceil(B / 128)), 256 threads, smem_bytes<kMode>().
template <int kMode>
__global__ void __launch_bounds__(fir::kThreads)
    prec_tc_kernel(fir::Launch g, int stride, int R_pad,
                   const void* __restrict__ w) {
  constexpr int kDots = dots<kMode>(), kSliceTaps = slice_taps<kMode>();
  constexpr int kSlices = kStageTaps / kSliceTaps;
  constexpr int kWBytes = w_bytes<kMode>();
  constexpr bool kTf = kMode == kTf32;
  extern __shared__ uint8_t prec_smem[];
  const uint32_t ring = (fir::smem_addr(prec_smem) + 1023) & ~1023u;
  const int tid = threadIdx.x, h = tid / 128;
  const int w_ = (tid % 128) / 32, l = tid % 32;
  const int n_rt = R_pad / fir::kRowTile;
  const int k = blockIdx.x / n_rt, rt = blockIdx.x % n_rt;
  const int lane0 = blockIdx.y * fir::kLaneTile;
  const int v0 = k * stride;
  const int t_lo = g.taps[rt * 2], t_hi = g.taps[rt * 2 + 1];
  const int t_begin = t_lo & ~(kSliceTaps - 1);
  const int n_stages =
      t_hi > t_begin ? (t_hi - t_begin + kStageTaps - 1) / kStageTaps : 0;
  const bool vec = g.B % 8 == 0 && reinterpret_cast<uintptr_t>(g.x) % 16 == 0;
  const uint32_t frag = (8 * (l / 16) + l % 8) * kRawPitch +
                        (64 * h + 16 * w_ + 8 * ((l / 8) % 2)) * 2;
  auto stage_at = [&](int s) { return ring + (s % kStages) * stage_bytes<kMode>(); };

  auto copy_stage = [&](int s) {
    if (s < n_stages) {
      const uint32_t buf = stage_at(s);
      const int ts = t_begin + s * kStageTaps;
      if (kTf) {   // [64 rows x 8 taps] tiles, 16-byte chunks (4 taps)
        const float* wf = static_cast<const float*>(w);
#pragma unroll
        for (int r = 0; r < 4 * fir::kRowTile * 2 / fir::kThreads; ++r) {
          const int e = tid + r * fir::kThreads;
          const int c = e % 2, n = e / 2 % fir::kRowTile, i = e / (2 * fir::kRowTile);
          const int t = ts + i * 8 + c * 4;
          fir::copy16(buf + i * kTf32Tile + fir::int8tc::core_offset(n, c),
                      t < g.K ? wf + (size_t)(rt * fir::kRowTile + n) * g.K + t
                              : wf,
                      t < g.K ? 16 : 0);
        }
      } else {     // tap rows of 64 bf16 rows, swizzled (split5)
        const auto* wb = static_cast<const __nv_bfloat16*>(w);
        const int tr = tid / 8, wc = tid % 8, t = ts + tr;
#pragma unroll
        for (int p = 0; p < (kDots > 1 ? 2 : 1); ++p)
          fir::copy16(buf + (p * 2 + tr / 16) * s5::kTileBytes +
                          s5::swizzle(tr % 16, wc),
                      t < g.K ? wb + ((size_t)p * g.K + t) * R_pad +
                                    rt * fir::kRowTile + wc * 8
                              : wb,
                      t < g.K ? 16 : 0);
      }
      const int xt = tid / 16, xl = (tid % 16) * 8;
#pragma unroll
      for (int j = 0; j < kStageTaps / 16; ++j)
        fir::copy_x8(g, v0 + ts + j * 16 + xt, lane0 + xl, vec,
                     buf + kWBytes + (j * 16 + xt) * kRawPitch + xl * 2, w);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  auto stage_ready = [&]() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kLead - 1) : "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
  };

  float acc[kDots][32], total[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    total[i] = 0.0f;
#pragma unroll
    for (int d = 0; d < kDots; ++d) acc[d][i] = 0.0f;
  }
  if (n_stages > 0) {
#pragma unroll
    for (int s = 0; s < kLead; ++s) copy_stage(s);
    stage_ready();
  }
  uint32_t a_hi[2][4], a_lo[2][4];
#pragma unroll 1
  for (int s = 0; s < n_stages; ++s) {
    const uint32_t buf = stage_at(s);
#pragma unroll
    for (int j = 0; j < kSlices; ++j) {
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      s5::pin(a_hi[j % 2]);
      if (kDots > 1) s5::pin(a_lo[j % 2]);
      const uint32_t at = buf + kWBytes + j * kSliceTaps * kRawPitch + frag;
      if (kTf)
        load_tf32(at, a_hi[j % 2]);
      else
        s5::load_split(at, a_hi[j % 2], a_lo[j % 2]);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      const bool restart = j == 0 && s % kPromote == 0;
      if (kTf) {
        mma_tf32(acc[0], a_hi[j % 2],
                 fir::int8tc::descriptor(buf + j * kTf32Tile), !restart);
      } else {
        const uint64_t w_hi = s5::descriptor(buf + j * s5::kTileBytes);
        s5::mma(acc[0], a_hi[j % 2], w_hi, !restart);
        if constexpr (kDots > 1) {
          const uint64_t w_lo = s5::descriptor(buf + (2 + j) * s5::kTileBytes);
          s5::mma(acc[1], a_lo[j % 2], w_hi, 1);
          s5::mma(acc[2], a_hi[j % 2], w_lo, 1);
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      if (j == 0) copy_stage(s + kLead);
    }
    if ((s + 1) % kPromote == 0 || s + 1 == n_stages) {
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
      for (int d = 0; d < kDots; ++d) pin(acc[d]);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        s5::pin(a_hi[q]);
        if (kDots > 1) s5::pin(a_lo[q]);
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) total[i] = __fadd_rn(total[i], acc[0][i]);
    }
    stage_ready();
  }

  // split5's epilogue: (total + d_2) + d_3, WORD2INT, through shared memory
  // to 16-byte row stores of the rows below R
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    float y = total[i];
#pragma unroll
    for (int d = 1; d < kDots; ++d) y = __fadd_rn(y, acc[d][i]);
    const int lane = 64 * h + 16 * w_ + l / 4 + 8 * ((i / 2) % 2);
    const int row = 8 * (i / 4) + 2 * (l % 4) + i % 2;
    asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(ring + row * kRawPitch +
                                                   lane * 2),
                 "h"(fir::word2int(y))
                 : "memory");
  }
  __syncthreads();
  const bool vec_y = g.B % 8 == 0 && reinterpret_cast<uintptr_t>(g.y) % 16 == 0;
#pragma unroll
  for (int r = 0; r < fir::kRowTile * fir::kLaneTile / 8 / fir::kThreads; ++r) {
    const int chunk = tid + r * fir::kThreads;
    const int row = chunk / (fir::kLaneTile / 8);
    const int cl = chunk % (fir::kLaneTile / 8) * 8;
    const int lane = lane0 + cl;
    if (rt * fir::kRowTile + row >= g.R || lane >= g.B) continue;
    uint32_t v[4];
    asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
                 : "r"(ring + row * kRawPitch + cl * 2)
                 : "memory");
    int16_t* out =
        g.y + ((size_t)k * g.R + rt * fir::kRowTile + row) * g.B + lane;
    if (vec_y) {
      *reinterpret_cast<uint4*>(out) = make_uint4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int b = 0; b < 8; ++b)
        if (lane + b < g.B) out[b] = (int16_t)(v[b / 2] >> (16 * (b & 1)));
    }
  }
}

template <typename F>
int dispatch(int mode, F f) {
#define PROBE_PREC_CASE(M) \
  if (mode == M) return f(std::integral_constant<int, M>{});
  PROBE_PREC_CASE(kHighest) PROBE_PREC_CASE(kDefault) PROBE_PREC_CASE(kHigh)
  PROBE_PREC_CASE(kTf32)
#undef PROBE_PREC_CASE
  return -static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace prec
}  // namespace probes

extern "C" {

// Dynamic shared memory of one CTA of a mode.
int probe_prec_fir_smem(int mode) {
  return probes::prec::dispatch(mode, [](auto m) {
    return probes::prec::smem_bytes<decltype(m)::value>();
  });
}

// mode 0 HIGHEST (w f32 [1, K, R_pad], taps int32 [1, R_pad / 16, 2]), 1
// DEFAULT (w bf16 [1, K, R_pad]), 2 HIGH (w bf16 [2, K, R_pad]: hi, lo),
// 3 TF32 (w f32 [R_pad, K], tf32 values, each 8 taps in fragment order);
// modes 1-3 with taps int32 [1, R_pad / 64, 2].  x int16 [T, B], y int16
// [n_blocks * R, B]; block j reads K rows of x from j * stride (rows past
// T read as zero); R_pad % 64 == 0, R <= R_pad; K % 8 == 0 for TF32; w
// 16-byte aligned.  Launches on `stream`; returns cudaGetLastError() (0 on
// success).
int probe_prec_fir(const void* x, void* y, const void* taps, const void* w,
                   int mode, int T, int B, int R, int R_pad, int K, int stride,
                   int n_blocks, void* stream) {
  cudaGetLastError();
  if (reinterpret_cast<uintptr_t>(w) % 16 || R_pad % fir::kRowTile ||
      R > R_pad || B <= 0 || (mode == probes::prec::kTf32 && K % 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  return probes::prec::dispatch(mode, [&](auto m) {
    constexpr int kM = decltype(m)::value;
    const int smem = probes::prec::smem_bytes<kM>();
    cudaError_t err;
    if constexpr (kM == probes::prec::kHighest) {
      err = fir::f32::allow_smem(probes::prec::prec_f32_kernel);
      if (err != cudaSuccess) return static_cast<int>(err);
      const fir::Launch g =
          fir::make_launch(x, x, y, taps, 0, T, B, R_pad, K, 1);
      const dim3 grid(n_blocks * (R_pad / fir::kRowTile),
                      (B + probes::prec::kDenseLanes - 1) /
                          probes::prec::kDenseLanes);
      probes::prec::prec_f32_kernel<<<
          grid, fir::f32::threads_for(probes::prec::kDenseLanes,
                                      probes::prec::kDenseTN),
          smem, st>>>(g, stride, R, static_cast<const float*>(w));
    } else {
      auto kernel = probes::prec::prec_tc_kernel<kM>;
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      const fir::Launch g = fir::make_launch(x, x, y, taps, 0, T, B, R, K, 1);
      const dim3 grid(n_blocks * (R_pad / fir::kRowTile),
                      (B + fir::kLaneTile - 1) / fir::kLaneTile);
      kernel<<<grid, fir::kThreads, smem, st>>>(g, stride, R_pad, w);
    }
    return static_cast<int>(cudaGetLastError());
  });
}

}  // extern "C"
