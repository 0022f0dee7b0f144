// The gather launch for Hopper (sm_90a): per-output tap-row dots, float
// and fixed.
//
// Replaces speex_resampler_tpu/ops/fir_matmul.py resample_gather (float,
// an f32 HIGHEST einsum) and resample_gather_fixed (exact int32 multiply
// and sum), which the JAX package runs outside Pallas, each one jitted XLA
// program.  The gather geometry serves ratios whose reduced denominator is
// so large that no padded or phase-tiled weight set fits (clock drift,
// 44100 -> 44101: one launch is one 44100-frame block, 44101 outputs, each
// with its own phase).  Output o, lane b is
//
//   float: y[o, b] = WORD2INT(f32(sum_{n<N} taps[o, n] * x[starts[o] + n, b]))
//          (the f32 sum itself with `raw`, the float-sample API)
//   fixed: acc_c = sum_{n<N} taps[o, c, n] * x[starts[o] + n, b] mod 2^32
//          for the kAccum tap rows c of output o; kAccum 1 (direct):
//          y = SATURATE32PSHR(acc_0, 15, 32767); kAccum 4 (interpolated):
//          y = SATURATE32PSHR(sum_c MULT16_32_Q15(coef[o, c], acc_c >> 1))
//          (fir_common.cuh; resample.c:474-479)
//
// The rows are those of the virtual axis hist ++ x (hist's H rows, then
// x's; the batched step's history and chunk, read in place, so the step
// copies neither into one buffer; the single-stream route has no hist).
// starts[] are non-decreasing (clamped at the tail), so M consecutive
// outputs read the rows starts[o0] .. starts[o0 + M - 1] + N - 1: a CTA
// takes M outputs x 64 lanes, stages those rows (in x's own type) and the
// M tap rows (float: as double; fixed: as int32) in shared memory once,
// then each thread walks its outputs' dots.  M, a tap chunk KC and the
// rows a CTA stages at once come from the host (ops/fir_matmul.gather_plan,
// computed from the starts when the step is built, never at launch) so
// they fit shared memory; taps past KC are walked in further chunks,
// restaged.  Where a chunk's rows (the start spread + KC) outnumber the
// plan's, as in a steep decimation whose 8 outputs' windows lie far
// apart, they are staged and walked a piece of `rows` at a time.
//
// A warp holds kO consecutive outputs (M = 8 kO), a thread two adjacent
// lanes.  It runs over the rows v its outputs' windows cover, in order:
// it loads row v's two samples once, then for each of its outputs whose
// window holds v adds tap (v - that output's offset) times them.  So every
// output's dot runs in tap order, each sample is read from shared memory
// once per thread, and every tap load is one broadcast to the warp.
//
// Float: the products of f32 taps and int16 (or f32) samples are exact in
// double, and the dot is a double FMA chain in tap order, rounded once to
// f32 at the end, as the plain version's float64 matmul is: the two agree
// bit for bit unless a float64 sum lands within its own rounding error of
// an f32 rounding boundary.  Fixed: the products and the sums are taken in
// uint32, whose wrap is defined; the sum mod 2^32 does not depend on the
// order, so the kernel and the plain version agree bit for bit.
//
// What bounds it on the H100: drift at B = 2048 needs 11.56 G multiply-adds
// (44101 outputs x 128 taps x 2048 lanes) against ~385 MB of x, y and taps:
// 0.345 ms at the 67 TFLOP/s of the f32 CUDA cores, 0.115 ms of bytes.  This
// kernel runs on the FP64 units (64 DFMA a clock an SM, half the f32 rate),
// and the fixed one on IMAD (4 x 11.56 G at 64 a clock an SM, ~2.8 ms), so
// both sit well above that bound: a banded tensor-core form (a [M, M + N]
// tap band times the staged [M + N, lanes] window) is the way down.
#include "fir_common.cuh"

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 64;  // lanes of a CTA, two a thread
// Shared memory a CTA may take: two CTAs an SM (2 x (112 KB + the 1 KB the
// system keeps a CTA) <= 228 KB).  The host's plan stays within it.
constexpr int kSmemMax = 112 * 1024;

struct Gather {
  const void* h;  // hist[v, b], v < H, at h + v * hst + b * hsb (elements)
  long long hst, hsb;
  const void* x;  // row H + v of the axis, x[v, b], at x + v * st + b * sb
  long long st, sb;
  int H, T, B;  // T: rows of hist ++ x
  const int32_t* starts;  // [n_out], non-decreasing
  int n_out, N;
  int KC, rows;  // taps a chunk; x rows a CTA stages for one chunk
  void* y;       // [n_out, B]
};

// Two adjacent lanes of a staged row, in x's type.
__device__ __forceinline__ short2 load2(const int16_t* p) {
  return *reinterpret_cast<const short2*>(p);
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// One step of a dot: double FMA (float), uint32 multiply-add (fixed).
__device__ __forceinline__ double mac(double w, double x, double a) {
  return fma(w, x, a);
}
__device__ __forceinline__ unsigned mac(unsigned w, unsigned x, unsigned a) {
  return a + w * x;
}

// Runs store(i, load(i)) for i < n over the CTA's threads, kU loads in
// flight a thread before their stores, so their latencies overlap.
template <int kU, typename Load, typename Store>
__device__ __forceinline__ void copy_batched(int n, Load load, Store store) {
  using V = decltype(load(0));
  for (int i0 = threadIdx.x; i0 < n; i0 += kThreads * kU) {
    V v[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u)
      if (i0 + u * kThreads < n) v[u] = load(i0 + u * kThreads);
#pragma unroll
    for (int u = 0; u < kU; ++u)
      if (i0 + u * kThreads < n) store(i0 + u * kThreads, v[u]);
  }
}

// Whether rows of p (strides st, sb) take 16-byte loads of kV lanes.
template <int kV>
__device__ __forceinline__ bool vector_rows(const void* p, long long st,
                                            long long sb) {
  return sb == 1 && st % kV == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Rows base + r, r < n, of hist ++ x, lanes lane0 .. lane0 + 63, into
// xs[r][64] (zeros past T and past B): 16-byte loads where both operands'
// lanes are contiguous and aligned, else one sample a load.
template <typename XT>
__device__ __forceinline__ void stage_x(const Gather& g, int base, int n,
                                        int lane0, XT* xs) {
  const XT* h = static_cast<const XT*>(g.h);
  const XT* x = static_cast<const XT*>(g.x);
  // the element of row v, lane b (v < T)
  auto at = [&](int v, int b) {
    return v < g.H ? h + v * g.hst + b * g.hsb
                   : x + (v - g.H) * g.st + b * g.sb;
  };
  constexpr int kV = 16 / sizeof(XT);  // lanes a 16-byte chunk
  constexpr int kC = kLanes / kV;      // chunks a row
  if (g.B % kV == 0 && vector_rows<kV>(x, g.st, g.sb) &&
      (g.H == 0 || vector_rows<kV>(h, g.hst, g.hsb))) {
    copy_batched<4>(
        n * kC,
        [&](int i) {
          const int v = base + i / kC, b = lane0 + i % kC * kV;
          return v < g.T && b < g.B
                     ? __ldg(reinterpret_cast<const uint4*>(at(v, b)))
                     : make_uint4(0, 0, 0, 0);
        },
        [&](int i, uint4 val) {
          *reinterpret_cast<uint4*>(xs + i / kC * kLanes + i % kC * kV) = val;
        });
    return;
  }
  copy_batched<8>(
      n * kLanes,
      [&](int i) {
        const int v = base + i / kLanes, b = lane0 + i % kLanes;
        return v < g.T && b < g.B ? *at(v, b) : XT(0);
      },
      [&](int i, XT val) { xs[i] = val; });
}

// The dots of the CTA's kM = 8 kO outputs from o0 over lanes lane0 ..
// lane0 + 63: acc[j][c][e] is tap row c of output o0 + warp * kO + j at
// lane lane0 + 2 * (thread % 32) + e.  Acc is the sum's type (double, or
// uint32), tap row c of chunk [t0, t0 + kc) of the CTA's output j is staged
// by stage_taps at ts[(j * KC + t) * kAccum + c], t < kc.
template <typename XT, typename Acc, int kAccum, int kO, typename StageTaps>
__device__ __forceinline__ void walk(const Gather& g, int o0, int lane0,
                                     StageTaps stage_taps,
                                     Acc (&acc)[kO][kAccum][2]) {
  constexpr int kM = kWarps * kO;
  extern __shared__ __align__(16) unsigned char gather_smem[];
  Acc* ts = reinterpret_cast<Acc*>(gather_smem);
  XT* xs = reinterpret_cast<XT*>(gather_smem +
                                 (size_t)kM * g.KC * kAccum * sizeof(Acc));
  const int warp = threadIdx.x / 32, p = threadIdx.x % 32;
  const int last = min(o0 + kM, g.n_out) - 1;
  const int base = g.starts[o0];
  // this warp's outputs' window offsets from base (outputs past n_out
  // repeat the last one: computed, never stored)
  int d[kO];
#pragma unroll
  for (int j = 0; j < kO; ++j)
    d[j] = g.starts[min(o0 + warp * kO + j, last)] - base;
  int d_min = d[0], d_max = d[0];
#pragma unroll
  for (int j = 1; j < kO; ++j) {
    d_min = min(d_min, d[j]);
    d_max = max(d_max, d[j]);
  }
  const int span = g.starts[last] - base;
#pragma unroll
  for (int j = 0; j < kO; ++j)
#pragma unroll
    for (int c = 0; c < kAccum; ++c) acc[j][c][0] = acc[j][c][1] = Acc(0);

  for (int t0 = 0; t0 < g.N; t0 += g.KC) {
    const int kc = min(g.KC, g.N - t0);
    // the chunk's rows r0 .. r0 + n_rows - 1 (from base + t0), a piece of at
    // most g.rows at a time: one piece unless the plan stages fewer rows
    // than the start spread + kc
    for (int r0 = 0; r0 < span + kc; r0 += g.rows) {
      const int n_rows = min(span + kc - r0, g.rows);
      __syncthreads();  // every read of the previous piece is done
      if (r0 == 0) stage_taps(ts, t0, kc);
      stage_x<XT>(g, base + t0 + r0, n_rows, lane0, xs);
      __syncthreads();
      // Row v (from base + t0) is tap v - d[j] of output j.  At the edges,
      // v < max d or v >= min d + kc, some outputs' windows miss it and each
      // is checked; in between every output takes it, unchecked and four
      // rows an iteration.  Only the piece's rows are walked.
      const int lo = max(d_min, r0), hi = min(d_max + kc, r0 + n_rows);
      const int in_lo = max(d_max, lo), in_hi = min(d_min + kc, hi);
      auto row = [&](int v, auto all) {
        const auto xv = load2(xs + (v - r0) * kLanes + 2 * p);
        const Acc x0 = static_cast<Acc>(xv.x), x1 = static_cast<Acc>(xv.y);
#pragma unroll
        for (int j = 0; j < kO; ++j) {
          const int t = v - d[j];
          if constexpr (!decltype(all)::value) {
            if (static_cast<unsigned>(t) >= static_cast<unsigned>(kc)) continue;
          }
          Acc w[kAccum];
          const Acc* src = ts + ((warp * kO + j) * g.KC + t) * kAccum;
          if constexpr (kAccum == 4) {
            const uint4 q = *reinterpret_cast<const uint4*>(src);
            w[0] = q.x, w[1] = q.y, w[2] = q.z, w[3] = q.w;
          } else {
#pragma unroll
            for (int c = 0; c < kAccum; ++c) w[c] = src[c];
          }
#pragma unroll
          for (int c = 0; c < kAccum; ++c) {
            acc[j][c][0] = mac(w[c], x0, acc[j][c][0]);
            acc[j][c][1] = mac(w[c], x1, acc[j][c][1]);
          }
        }
      };
      using Checked = std::false_type;
      using All = std::true_type;
      int v = lo;
      for (; v < min(in_lo, hi); ++v) row(v, Checked());
      for (; v + 4 <= in_hi; v += 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u) row(v + u, All());
      }
      for (; v < in_hi; ++v) row(v, All());
      for (; v < hi; ++v) row(v, Checked());
    }
  }
}

// grid: one CTA a (tile of 8 kO outputs, 64 lanes), lane tiles fastest
template <typename XT, int kO>
__global__ void __launch_bounds__(kThreads, 2)
gather_fir_f32_kernel(Gather g, const float* __restrict__ taps, int raw) {
  const int lane_tiles = (g.B + kLanes - 1) / kLanes;
  const int o0 = blockIdx.x / lane_tiles * (kWarps * kO);
  const int lane0 = blockIdx.x % lane_tiles * kLanes;
  double acc[kO][1][2];
  walk<XT, double, 1, kO>(
      g, o0, lane0,
      [&](double* ts, int t0, int kc) {
        // 16-byte loads of four taps where rows and chunks allow
        if (g.N % 4 == 0 && g.KC % 4 == 0 &&
            reinterpret_cast<uintptr_t>(taps) % 16 == 0) {
          const int q = kc / 4;
          copy_batched<4>(
              kWarps * kO * q,
              [&](int i) {
                const int o = o0 + i / q;
                return o < g.n_out
                           ? __ldg(reinterpret_cast<const float4*>(
                                 taps + (size_t)o * g.N + t0 + i % q * 4))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
              },
              [&](int i, float4 v) {
                double* d = ts + i / q * g.KC + i % q * 4;
                d[0] = v.x, d[1] = v.y, d[2] = v.z, d[3] = v.w;
              });
          return;
        }
        copy_batched<8>(
            kWarps * kO * kc,
            [&](int i) {
              const int o = o0 + i / kc;
              return o < g.n_out ? taps[(size_t)o * g.N + t0 + i % kc] : 0.f;
            },
            [&](int i, float v) { ts[i / kc * g.KC + i % kc] = v; });
      },
      acc);
  const int warp = threadIdx.x / 32, b = lane0 + 2 * (threadIdx.x % 32);
#pragma unroll
  for (int j = 0; j < kO; ++j) {
    const int o = o0 + warp * kO + j;
    if (o >= g.n_out) continue;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (b + e >= g.B) continue;
      const float f = __double2float_rn(acc[j][0][e]);
      const size_t at = (size_t)o * g.B + b + e;
      if (raw)
        static_cast<float*>(g.y)[at] = f;
      else
        static_cast<int16_t*>(g.y)[at] = fir::word2int(f);
    }
  }
}

template <int kAccum, int kO>
__global__ void __launch_bounds__(kThreads, kO <= 4 ? 2 : 1)
gather_fir_fixed_kernel(Gather g, const int16_t* __restrict__ taps,
                        const int32_t* __restrict__ coef) {
  const int lane_tiles = (g.B + kLanes - 1) / kLanes;
  const int o0 = blockIdx.x / lane_tiles * (kWarps * kO);
  const int lane0 = blockIdx.x % lane_tiles * kLanes;
  unsigned acc[kO][kAccum][2];
  walk<int16_t, unsigned, kAccum, kO>(
      g, o0, lane0,
      [&](unsigned* ts, int t0, int kc) {
        // tap row c of output j: taps[o][c][t0 ..), 16-byte loads of eight
        // taps where rows and chunks allow
        if (g.N % 8 == 0 && g.KC % 8 == 0 &&
            reinterpret_cast<uintptr_t>(taps) % 16 == 0) {
          const int q = kc / 8;
          copy_batched<4>(
              kWarps * kO * kAccum * q,
              [&](int i) {
                const int jc = i / q, o = o0 + jc / kAccum;
                return o < g.n_out
                           ? __ldg(reinterpret_cast<const uint4*>(
                                 taps + ((size_t)o * kAccum + jc % kAccum) *
                                            g.N +
                                 t0 + i % q * 8))
                           : make_uint4(0, 0, 0, 0);
              },
              [&](int i, uint4 v) {
                const int jc = i / q, t = i % q * 8;
                unsigned* d = ts + (jc / kAccum * g.KC + t) * kAccum +
                              jc % kAccum;
                const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
                for (int e = 0; e < 8; ++e)
                  d[e * kAccum] =
                      (unsigned)(int)(int16_t)(w[e / 2] >> (16 * (e % 2)));
              });
          return;
        }
        copy_batched<8>(
            kWarps * kO * kAccum * kc,
            [&](int i) {
              const int jc = i / kc, o = o0 + jc / kAccum;
              return o < g.n_out
                         ? (int)taps[((size_t)o * kAccum + jc % kAccum) * g.N +
                                     t0 + i % kc]
                         : 0;
            },
            [&](int i, int v) {
              const int jc = i / kc;
              ts[(jc / kAccum * g.KC + i % kc) * kAccum + jc % kAccum] =
                  (unsigned)v;
            });
      },
      acc);
  const int warp = threadIdx.x / 32, b = lane0 + 2 * (threadIdx.x % 32);
#pragma unroll
  for (int j = 0; j < kO; ++j) {
    const int o = o0 + warp * kO + j;
    if (o >= g.n_out) continue;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (b + e >= g.B) continue;
      unsigned s = acc[j][0][e];
      if constexpr (kAccum == 4) {
        s = 0;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          s += fir::mult16_32_q15(coef[(size_t)o * 4 + c],
                                  (int)acc[j][c][e] >> 1);
      }
      static_cast<int16_t*>(g.y)[(size_t)o * g.B + b + e] =
          fir::sat32pshr15((int)s);
    }
  }
}

// Launches `kernel` (its shared-memory ceiling set once a device) on one
// CTA a (tile of outputs, 64 lanes).
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel* kernel, std::atomic<unsigned>& smem_set,
                   const Gather& g, int M, size_t smem, cudaStream_t stream,
                   Args... args) {
  const cudaError_t attr = fir::set_once(smem_set, [kernel] {
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  });
  if (attr != cudaSuccess) return attr;
  const unsigned tiles = (g.n_out + M - 1) / M;
  const unsigned lane_tiles = (g.B + kLanes - 1) / kLanes;
  kernel<<<tiles * lane_tiles, kThreads, smem, stream>>>(g, args...);
  return cudaGetLastError();
}

template <typename XT, int kO>
cudaError_t launch_f32(const Gather& g, const float* taps, int raw,
                       size_t smem, cudaStream_t stream) {
  static std::atomic<unsigned> smem_set{0};
  return launch(gather_fir_f32_kernel<XT, kO>, smem_set, g, kWarps * kO,
                smem, stream, taps, raw);
}

template <int kAccum, int kO>
cudaError_t launch_fixed(const Gather& g, const int16_t* taps,
                         const int32_t* coef, size_t smem,
                         cudaStream_t stream) {
  static std::atomic<unsigned> smem_set{0};
  return launch(gather_fir_fixed_kernel<kAccum, kO>, smem_set, g,
                kWarps * kO, smem, stream, taps, coef);
}

// The plan's geometry, or cudaErrorInvalidValue: M = 8 kO outputs a CTA
// (kO 1, 2, 4 or 8), KC >= 1 taps a chunk, `rows` x rows, within kSmemMax.
cudaError_t check_plan(const Gather& g, int M, size_t tap_bytes,
                       size_t x_bytes, size_t* smem) {
  *smem = (size_t)M * g.KC * tap_bytes + (size_t)g.rows * kLanes * x_bytes;
  if ((M != 8 && M != 16 && M != 32 && M != 64) || g.KC < 1 || g.rows < 1 ||
      g.n_out < 1 || g.N < 1 || g.B < 1 || *smem > (size_t)kSmemMax)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

Gather make_gather(const void* h, long long hst, long long hsb, int H,
                   const void* x, long long st, long long sb, int T, int B,
                   const void* starts, int n_out, int N, int KC, int rows,
                   void* y) {
  return Gather{h,     hst, hsb, x, st, sb, H, H + T, B,
                static_cast<const int32_t*>(starts),
                n_out, N, KC, rows, y};
}

}  // namespace

extern "C" {

const char* gather_fir_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The shared memory a CTA may take (ops/fir_matmul.GATHER_SMEM_BYTES).
int gather_fir_smem_max() { return kSmemMax; }

// The axis is hist ++ x: hist's H rows read as h[v * hst + b * hsb] (H 0:
// none, h unused), then x's T rows as x[v * st + b * sb], int16 (x_f32 0)
// or f32 (x_f32 1), both of one type; taps f32[n_out, N]; starts
// int32[n_out], non-decreasing, on the axis; y [n_out, B], f32 when raw,
// else int16.  M outputs a CTA, KC taps a chunk, `rows` axis rows staged
// at once (ops/fir_matmul.gather_plan).  Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() of the launch (0 on
// success).
int gather_fir_f32(const void* h, long long hst, long long hsb, int H,
                   const void* x, long long st, long long sb, int x_f32,
                   const void* taps, const void* starts, void* y, int T,
                   int B, int n_out, int N, int M, int KC, int rows, int raw,
                   void* stream) {
  cudaGetLastError();
  const Gather g = make_gather(h, hst, hsb, H, x, st, sb, T, B, starts, n_out,
                               N, KC, rows, y);
  size_t smem = 0;
  cudaError_t err = check_plan(g, M, sizeof(double), x_f32 ? 4 : 2, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* t = static_cast<const float*>(taps);
  const auto st_ = static_cast<cudaStream_t>(stream);
  const int kO = M / kWarps;
  if (x_f32) {
    err = kO == 8   ? launch_f32<float, 8>(g, t, raw, smem, st_)
          : kO == 4 ? launch_f32<float, 4>(g, t, raw, smem, st_)
          : kO == 2 ? launch_f32<float, 2>(g, t, raw, smem, st_)
                    : launch_f32<float, 1>(g, t, raw, smem, st_);
  } else {
    err = kO == 8   ? launch_f32<int16_t, 8>(g, t, raw, smem, st_)
          : kO == 4 ? launch_f32<int16_t, 4>(g, t, raw, smem, st_)
          : kO == 2 ? launch_f32<int16_t, 2>(g, t, raw, smem, st_)
                    : launch_f32<int16_t, 1>(g, t, raw, smem, st_);
  }
  return static_cast<int>(err);
}

// hist and x int16 as above; taps int16[n_out, n_accum, N]; coef
// int32[n_out, 4] (NULL for n_accum 1); y int16[n_out, B].
int gather_fir_fixed(const void* h, long long hst, long long hsb, int H,
                     const void* x, long long st, long long sb,
                     const void* taps, const void* starts, const void* coef,
                     void* y, int n_accum, int T, int B, int n_out, int N,
                     int M, int KC, int rows, void* stream) {
  cudaGetLastError();
  if (n_accum != 1 && n_accum != 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const Gather g = make_gather(h, hst, hsb, H, x, st, sb, T, B, starts, n_out,
                               N, KC, rows, y);
  size_t smem = 0;
  cudaError_t err = check_plan(g, M, 4 * n_accum, 2, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* t = static_cast<const int16_t*>(taps);
  const auto* c = static_cast<const int32_t*>(coef);
  const auto st_ = static_cast<cudaStream_t>(stream);
  const int kO = M / kWarps;
  if (n_accum == 4) {
    err = kO == 8   ? launch_fixed<4, 8>(g, t, c, smem, st_)
          : kO == 4 ? launch_fixed<4, 4>(g, t, c, smem, st_)
          : kO == 2 ? launch_fixed<4, 2>(g, t, c, smem, st_)
                    : launch_fixed<4, 1>(g, t, c, smem, st_);
  } else {
    err = kO == 8   ? launch_fixed<1, 8>(g, t, c, smem, st_)
          : kO == 4 ? launch_fixed<1, 4>(g, t, c, smem, st_)
          : kO == 2 ? launch_fixed<1, 2>(g, t, c, smem, st_)
                    : launch_fixed<1, 1>(g, t, c, smem, st_);
  }
  return static_cast<int>(err);
}

}  // extern "C"
