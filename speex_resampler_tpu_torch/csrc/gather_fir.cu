// The gather launch for Hopper (sm_90a): per-output tap-row dots, float
// and fixed, in three forms that the host's plan chooses between when a
// step is built (ops/fir_matmul.gather_plan): "rows", per-output dots on
// the CUDA cores; "band", a banded product on the tensor cores with the
// band resident in shared memory; "stream", the same product with the band
// streamed through shared memory, where it does not fit there.
//
// Replaces speex_resampler_tpu/ops/fir_matmul.py resample_gather (:120;
// float, an f32 HIGHEST einsum) and resample_gather_fixed (:270; exact
// int32 multiply and sum), which the JAX package runs outside Pallas, each
// one jitted XLA program.  The gather geometry serves ratios whose reduced
// denominator is so large that no padded or phase-tiled weight set fits
// (clock drift, 44100 -> 44101: one launch is one 44100-frame block, 44101
// outputs, each with its own phase; a steep decimation, 96000 -> 401: 401
// outputs, 239.4 rows apart, N 11496).  Output o, lane b is
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
// starts[] are non-decreasing (clamped at the tail).
//
// Rows form (gather_fir_f32_kernel; float only: a fixed step takes the
// band or stream form).  M consecutive outputs read the rows starts[o0] ..
// starts[o0 + M - 1] + N - 1: a CTA takes M outputs x 64 lanes, stages
// those rows (in x's own type) and the M tap rows (as double) in shared
// memory once, then each thread walks its outputs' dots.  M, a tap chunk
// KC and the rows a CTA stages at once come from the host's plan so they
// fit shared memory; taps past KC are walked in further chunks, restaged.
// Where a chunk's rows (the start spread + KC) outnumber the plan's, as in
// a steep decimation whose 8 outputs' windows lie far apart, they are
// staged and walked a piece of `rows` at a time.  A warp holds kO
// consecutive outputs (M = 8 kO), a thread two adjacent lanes.  It runs
// over the rows v its outputs' windows cover, in order: it loads row v's
// two samples once, then for each of its outputs whose window holds v adds
// tap (v - that output's offset) times them.  So every output's dot runs
// in tap order, each sample is read from shared memory once per thread,
// and every tap load is one broadcast to the warp.
//
// Band form.  Where consecutive outputs' windows overlap (drift: 44101
// outputs advance < 1 row each), G consecutive outputs' taps, each placed
// at its offset starts[o] - starts[o0] from the group's first, form a
// dense [G, K] band (K: the group's start spread + N, padded), and the
// group's dots are that band times the [K, lanes] window from row
// starts[o0]: a matrix product with zeros where an output's window misses
// a row.  The host builds the band when it builds the step
// (ops/fir_matmul.gather_band).
//   - Fixed, gather_fir_fixed_band_kernel<kAccum> on fixed_wgmma.cuh's
//     product (int8 wgmma m64nNk32, x the register operand, four int8
//     dots and the bias 128 * sum w a column, uint32 sums): G = 32
//     outputs (kAccum 4: a warpgroup 16 outputs x 4 column sets) or 64
//     (kAccum 1).  The band is split into balanced int8 planes int8[2,
//     groups, kAccum * G, K] (K-major, each 32-tap group permuted by
//     tiled_fir.K_PERM, column c * G + j for set c of output j), with the
//     bias int32[groups, kAccum * G].  A CTA keeps its group's planes
//     resident in shared memory and walks kFixedLaneTiles 64-lane tiles, each
//     warpgroup through its own ring of x stages (as int8_wgmma.cuh's
//     fir_tile_resident), then the existing Q15 epilogue.  The K origin,
//     starts[o0], needs no alignment: x is the register operand.  The sum
//     mod 2^32 does not depend on the order and zero band entries add 0,
//     so the kernel equals the plain version bit for bit.
//   - Float, gather_fir_f64mma_kernel<XT> on the FP64 tensor cores
//     (mma.sync m16n8k8 .f64, SASS DMMA): a warp takes 16 consecutive
//     outputs (M, their f64 band [16, K], K: the 16 outputs' spread + N
//     rounded up to 8) and 32 lanes as four 8-lane slices (N), with its
//     own K origin starts[o0].  A CTA (8 warps) takes 64 outputs x 64
//     lanes: four 16-output tiles, two warps each; it keeps the tiles'
//     bands resident (f64, as built) and walks kF64LaneTiles lane tiles,
//     staging each tile's window (x's own type) while the previous one is
//     multiplied; B fragments are converted to f64 as they are loaded.
//     Products of f32 taps and int16 (or f32) samples are exact in f64;
//     the sum is f64 in the tensor cores' order, rounded once to f32: the
//     contract of the rows form.  (Unlike the rows form, a band multiplies
//     every staged row, so a non-finite sample outside an output's window
//     but inside its band would reach it through a zero tap.)
//
// Stream form.  At a steep decimation the band is dense (16 outputs: K
// 15104, N / K 0.76) but far too wide to be resident (1.9 MB a float
// tile, 4.8 MB of planes a fixed group, against 227 KB).  Its kernels take
// one band tile a CTA, over several lane tiles, and stream the tile's band
// and its lanes' x rows through a ring of stages a few stages ahead of the
// products; int16 samples only (the batched step's).
//   - Float, gather_fir_f64mma_stream_kernel<short>: the band kernel's
//     product (16 outputs x 32 lanes a warp, four DMMAs a k-step of 8)
//     over a 16-output tile and 256 lanes a CTA; the band is f32
//     (f32[tiles * 16, K], half the f64 band's bytes), its A fragments
//     widened as they load, as the B fragments are.
//   - Fixed, gather_fir_fixed_stream_kernel<kAccum>: fir_tile's pipeline
//     (fixed_wgmma.cuh) over a G = 16 (kAccum 4) or 32 (kAccum 1) output
//     group, planes int8[2, groups, kAccum * G, K] as the band form's; each
//     warpgroup takes its own 64-lane tile against the CTA's one staged
//     band slice.
// Where the CTAs do not fill one wave of the card (401 outputs: 26 tiles),
// a launch splits K over several CTAs a tile (stream_split, from the
// card's multiprocessors and the kernel's occupancy); the last CTA of a
// tile and lane chunk adds the partial sums in split order (float f64,
// then one f32 rounding; fixed uint32, whose sum does not depend on the
// order) and stores.  This removes the two costs of the rows form at this
// ratio, whose eight outputs a CTA lie 1676 rows apart: each warp walked
// all the rows the CTA staged for its one output (busy 0.35 float, 0.21
// fixed of them), and every piece of rows was staged between two barriers
// with no overlap (7.0 / 11.5 GB from L2 a launch; on the H100 the
// staging alone took 2.6 / 8.5 ms and the walk alone 4.2 / 7.4 ms of the
// rows kernels' 6.1 / 15.4, PERF.md section 6).  What holds the stream
// kernels is what they stage: ~1.8 GB (float: x 1.6, band 0.2) and ~2.4
// GB (fixed: x 1.6, planes 0.8) a launch at B = 2048, 2.7-3.2 TB/s at
// their measured times.
//
// Rows: the products are exact in double, and the dot is a double FMA
// chain in tap order, rounded once to f32 at the end, as the plain
// version's float64 matmul is: the two agree bit for bit unless a float64
// sum lands within its own rounding error of an f32 rounding boundary.
//
// What bounds it on the H100: drift at B = 2048 needs 11.56 G multiply-adds
// (44101 outputs x 128 taps x 2048 lanes) against ~385 MB of x, y and taps:
// 0.345 ms at the 67 TFLOP/s of the f32 CUDA cores (and of the FP64 tensor
// cores), 0.115 ms of bytes; fixed (4 tap rows, 4 int8 products each)
// 0.187 ms at the int8 tensor cores' peak.  The rows form runs on the FP64
// units (64 DFMA a clock an SM) and on IMAD (4 x 11.56 G at 64 a clock an
// SM, ~2.8 ms), well above that; the band form walks its padded band
// (fixed: 1379 groups x 128 columns x 160 taps x 2048 lanes, 57.8 G; float:
// 44101 x 144 x 2048, 13.0 G) on the tensor cores.  The steep decimation
// needs 9.44 G multiply-adds (0.282 ms, ops) float and 37.76 G fixed (0.153
// ms at the int8 peak) against ~460 MB (0.137 ms); the stream form walks
// 26 tiles x 16 x 15104 x 2048 = 12.9 G f64 multiply-adds (float) and 26
// groups x 64 columns x 15104 x 2048 = 51.5 G band multiply-adds, four
// int8 products each (fixed, kAccum 4).
#include "fir_common.cuh"
#include "fixed_wgmma.cuh"

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

// One step of a dot: double FMA.
__device__ __forceinline__ double mac(double w, double x, double a) {
  return fma(w, x, a);
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
// lane0 + 63: acc[j][0][e] is output o0 + warp * kO + j at lane lane0 + 2
// * (thread % 32) + e, in Acc (double); tap t of chunk [t0, t0 + kc) of
// the CTA's output j is staged by stage_taps at ts[j * KC + t], t < kc.
// (kAccum, the tap rows an output, is 1.)
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
#pragma unroll
          for (int c = 0; c < kAccum; ++c) w[c] = src[c];
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

// -- band form ---------------------------------------------------------------

namespace i8 = fir::int8tc;

constexpr int kMaxSmem = i8::kMaxSmem;  // a CTA's most on the H100
constexpr int kWgThreads = kThreads / 2;
// 64-lane tiles a band CTA walks with its band resident, by kernel
// (tools/gather_ablate.py on the H100: of 8, 16 and 32, the fixed kernel
// was fastest at 16, the float one at 8)
constexpr int kFixedLaneTiles = 16;
constexpr int kF64LaneTiles = 8;

// Whether hist and x rows take 16-byte loads of 16 / sizeof(XT) lanes.
template <typename XT>
__device__ __forceinline__ bool vector_axis(const Gather& g) {
  constexpr int kV = 16 / sizeof(XT);
  return g.B % kV == 0 && vector_rows<kV>(g.x, g.st, g.sb) &&
         (g.H == 0 || vector_rows<kV>(g.h, g.hst, g.hsb));
}

// The element of axis row v (< T), lane b (< B).
template <typename XT>
__device__ __forceinline__ const XT* axis_at(const Gather& g, int v, int b) {
  return v < g.H ? static_cast<const XT*>(g.h) + v * g.hst + b * g.hsb
                 : static_cast<const XT*>(g.x) + (v - g.H) * g.st + b * g.sb;
}

// 16 bytes of axis row v from lane b (16 / sizeof(XT) lanes; zeros past T
// and past B) to shared dst: one cp.async where vec, else element loads
// and one shared store.
template <typename XT>
__device__ __forceinline__ void copy_axis16(const Gather& g, int v, int b,
                                            bool vec, uint32_t dst) {
  constexpr int kV = 16 / sizeof(XT);
  const bool in = v < g.T && b < g.B;
  if (vec) {
    fir::copy16(dst,
                in ? static_cast<const void*>(axis_at<XT>(g, v, b)) : g.starts,
                in ? 16 : 0);
    return;
  }
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int e = 0; e < kV; ++e) {
    if (!in || b + e >= g.B) continue;
    const XT val = *axis_at<XT>(g, v, b + e);
    if constexpr (sizeof(XT) == 2)
      w[e / 2] |= (uint32_t)(uint16_t)val << (16 * (e & 1));
    else
      w[e] = __float_as_uint(val);
  }
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
               "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3])
               : "memory");
}

// The CTAs a band tile (a group of outputs) takes: ceil(B / 64) lane
// tiles, `per` a CTA.
__host__ __device__ inline int band_chunks(int B, int per) {
  const int all = (B + kLanes - 1) / kLanes;
  return (all + per - 1) / per;
}

// CTA blockIdx.x of a band launch: band tile `tile` and its lane tiles
// lt0 .. lt0 + n_lt - 1, `per` a CTA.
struct BandCta {
  int tile, lt0, n_lt;
  __device__ BandCta(const Gather& g, int per) {
    const int chunks = band_chunks(g.B, per);
    tile = blockIdx.x / chunks;
    lt0 = blockIdx.x % chunks * per;
    n_lt = min(per, (g.B + kLanes - 1) / kLanes - lt0);
  }
};

// Fixed band: G = fixedtc::Shape<kAccum>::kRows outputs a group.  planes
// int8[2, groups, kAccum * G, K] (K % 32 == 0, 16-byte aligned), bias
// int32[groups, kAccum * G], coef int32[n_out, 4] (kAccum 4).
struct FixedBand {
  const int8_t* planes;
  const int32_t* bias;
  const int32_t* coef;
  int K;
};

// Dynamic shared memory of a fixed band CTA: the group's two planes, each
// warpgroup's ring of x stages and output rows, alignment.
template <int kAccum>
__host__ __device__ constexpr int fixed_band_smem(int K) {
  using Sh = fir::fixedtc::Shape<kAccum>;
  return 2 * (K / i8::kK) * Sh::kTileBytes +
         2 * (i8::kRing * i8::kRawBytes + Sh::kWgRows * i8::kRawPitch) + 128;
}

// One CTA: the group's planes copied into shared memory once (K-slice tile
// (p, s) at (p * n_slices + s) * kTileBytes, warpgroup h's kN rows from
// row h * kN: its kWgRows outputs' column sets, set-major, as fir_tile
// reads them), then each warpgroup walks the CTA's lane tiles on its own:
// its own ring of kRing 64-tap x stages (kRing - 1 ahead; the x of a
// K-slice past the band is not copied), a named barrier (1 + h) a stage,
// the fragments of a K-slice built while the previous slice's wgmmas run,
// four wgmmas a K-slice (wh.xh; wh.xl and wl.xh into one accumulator;
// wl.xl), and after a tile's last slice its epilogue: the sums 65536 hh +
// 256 mid + ll + bias, the Q15 mix, the int16 rows through shared memory
// to 16-byte stores (outputs past n_out and lanes past B not stored).
template <int kAccum>
__global__ void __launch_bounds__(kThreads, 1)
gather_fir_fixed_band_kernel(Gather g, FixedBand bw) {
  using Sh = fir::fixedtc::Shape<kAccum>;
  constexpr int kG = Sh::kRows, kC = kAccum * kG;
  extern __shared__ uint8_t fixed_band_smem_buf[];
  const int tid = threadIdx.x, h = tid / kWgThreads, wt = tid % kWgThreads;
  const int w = wt / 32, l = tid % 32;
  const BandCta cta(g, kFixedLaneTiles);
  const int n_slices = bw.K / i8::kK;
  const int n_st = (n_slices + i8::kSub - 1) / i8::kSub;
  const int n_total = cta.n_lt * n_st;
  const int o0 = cta.tile * kG, v0 = g.starts[o0];
  const uint32_t band = (fir::smem_addr(fixed_band_smem_buf) + 127) & ~127u;
  const uint32_t rings = band + 2 * n_slices * Sh::kTileBytes;
  const uint32_t ring = rings + h * i8::kRing * i8::kRawBytes;
  const uint32_t out = rings + 2 * i8::kRing * i8::kRawBytes +
                       h * Sh::kWgRows * i8::kRawPitch;
  const bool vec = vector_axis<int16_t>(g);
  // This thread's ldmatrix row (int8tc::load_split).
  const uint32_t frag = (8 * (l / 16) + l % 8) * i8::kRawPitch +
                        (16 * w + 8 * ((l / 8) % 2)) * 2;

  // the group's band: chunk e is 16-byte chunk cc of band column n's K
  // bytes in plane p (neighbouring threads, neighbouring chunks)
  {
    const int per_row = bw.K / 16, groups = (g.n_out + kG - 1) / kG;
    const size_t plane = (size_t)groups * kC * bw.K;
    const int8_t* src = bw.planes + (size_t)cta.tile * kC * bw.K;
    for (int e = tid; e < 2 * kC * per_row; e += kThreads) {
      const int cc = e % per_row, n = e / per_row % kC, p = e / (per_row * kC);
      const int j = n % kG;  // output j of the group, column set n / kG
      const int row = j / Sh::kWgRows * Sh::kN + n / kG * Sh::kWgRows +
                      j % Sh::kWgRows;
      fir::copy16(band + (p * n_slices + cc / 2) * Sh::kTileBytes +
                      i8::core_offset(row, cc % 2),
                  src + p * plane + (size_t)n * bw.K + cc * 16, 16);
    }
  }
  // stage q of this warpgroup's walk (its lane tile q / n_st, that tile's
  // stage q % n_st): one cp.async group, empty past the walk
  auto copy_stage = [&](int q) {
    if (q < n_total) {
      const int lane0 = (cta.lt0 + q / n_st) * kLanes, s = q % n_st;
      const uint32_t buf = ring + q % i8::kRing * i8::kRawBytes;
#pragma unroll
      for (int r = 0; r < i8::kStageTaps * kLanes / 8 / kWgThreads; ++r) {
        const int i = wt + r * kWgThreads, tap = i / (kLanes / 8);
        const int lane = (i % (kLanes / 8)) * 8;
        if (s * i8::kStageTaps + tap < bw.K)
          copy_axis16<int16_t>(g, v0 + s * i8::kStageTaps + tap,
                               lane0 + lane, vec,
                               buf + tap * i8::kRawPitch + lane * 2);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  // this thread's copies of the next stage have landed; then the
  // warpgroup's.  The first wait also takes the band (in the first
  // group): every thread's, fenced for the tensor cores, across the CTA.
  auto stage_ready = [&](bool first_wait) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(i8::kRingLead - 1)
                 : "memory");
    if (first_wait) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
    } else {
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + h), "n"(kWgThreads)
                   : "memory");
    }
  };

  int acc[3][Sh::kAcc];  // hh, mid, ll
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int i = 0; i < Sh::kAcc; ++i) acc[j][i] = 0;
#pragma unroll
  for (int q = 0; q < i8::kRingLead; ++q) copy_stage(q);
  stage_ready(true);
  uint32_t xh[2][4], xl[2][4];
  const uint32_t w_row = band + h * (Sh::kN / 8) * 256;
  const bool vec_y = g.B % 8 == 0 && reinterpret_cast<uintptr_t>(g.y) % 16 == 0;
#pragma unroll 1
  for (int it = 0; it < cta.n_lt; ++it) {
#pragma unroll 1
    for (int s = 0; s < n_st; ++s) {
      const int q = it * n_st + s;
      const uint32_t buf = ring + q % i8::kRing * i8::kRawBytes;
#pragma unroll
      for (int j = 0; j < i8::kSub; ++j) {
        const int slice = s * i8::kSub + j;
        // a tile's last stage stops at the band's end (uniform)
        if (j > 0 && slice >= n_slices) break;
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        i8::pin(xh[j]);
        i8::pin(xl[j]);
        i8::load_split(buf + j * i8::kK * i8::kRawPitch + frag, xh[j], xl[j]);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        const uint64_t bh = i8::descriptor(w_row + slice * Sh::kTileBytes);
        const uint64_t bl =
            i8::descriptor(w_row + (n_slices + slice) * Sh::kTileBytes);
        fir::fixedtc::mma(acc[0], xh[j], bh, slice > 0);
        fir::fixedtc::mma(acc[1], xl[j], bh, slice > 0);
        fir::fixedtc::mma(acc[1], xh[j], bl, 1);
        fir::fixedtc::mma(acc[2], xl[j], bl, slice > 0);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        // the buffer of stage q - 1 takes stage q + kRingLead: every
        // thread's ldmatrix of it ended before the last barrier
        if (j == 0) copy_stage(q + i8::kRingLead);
      }
      stage_ready(false);
    }
    // The epilogue of lane tile lt0 + it.  Accumulator register i = set *
    // kPer + e of thread (warp w, lane l): lane 16w + l/4 + 8*((e/2)%2),
    // output h * kWgRows + r, r = 8*(e/4) + 2*(l%4) + e%2 (fir_tile's
    // map).  The last readers of `out` passed a barrier since.
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < 3; ++j) i8::pin(acc[j]);
    const int32_t* bias_g = bw.bias + (size_t)cta.tile * kC + h * Sh::kWgRows;
#pragma unroll
    for (int e = 0; e < Sh::kPer; ++e) {
      const int lane = 16 * w + l / 4 + 8 * ((e / 2) % 2);
      const int r = 8 * (e / 4) + 2 * (l % 4) + e % 2;
      const int o = o0 + h * Sh::kWgRows + r;
      unsigned mix = 0;
#pragma unroll
      for (int set = 0; set < kAccum; ++set) {
        const int i = set * Sh::kPer + e;
        const unsigned sum = 65536u * (unsigned)acc[0][i] +
                             256u * (unsigned)acc[1][i] + (unsigned)acc[2][i] +
                             (unsigned)bias_g[set * kG + r];
        mix = kAccum == 1
                  ? sum
                  : mix + fir::mult16_32_q15(
                              o < g.n_out ? bw.coef[(size_t)o * 4 + set] : 0,
                              (int)sum >> 1);
      }
      asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(out + r * i8::kRawPitch +
                                                     lane * 2),
                   "h"(fir::sat32pshr15((int)mix))
                   : "memory");
    }
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + h), "n"(kWgThreads)
                 : "memory");
    const int lane0 = (cta.lt0 + it) * kLanes;
#pragma unroll
    for (int r = 0; r < Sh::kWgRows * kLanes / 8 / kWgThreads; ++r) {
      const int chunk = wt + r * kWgThreads;
      const int row = chunk / (kLanes / 8), cl = chunk % (kLanes / 8) * 8;
      const int o = o0 + h * Sh::kWgRows + row, lane = lane0 + cl;
      if (o >= g.n_out || lane >= g.B) continue;
      uint32_t v[4];
      asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
                   : "r"(out + row * i8::kRawPitch + cl * 2)
                   : "memory");
      int16_t* dst = static_cast<int16_t*>(g.y) + (size_t)o * g.B + lane;
      if (vec_y) {
        *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int b = 0; b < 8; ++b)
          if (lane + b < g.B) dst[b] = (int16_t)(v[b / 2] >> (16 * (b & 1)));
      }
    }
  }
}

// Float band: a warp tile is 16 outputs (M) x 32 lanes (four 8-lane N
// slices); a CTA takes four tiles (64 outputs), two warps each (lanes 0-31
// and 32-63 of the lane tile).
constexpr int kF64Tile = 16;            // outputs a warp tile
constexpr int kF64Outputs = 4 * kF64Tile;
constexpr int kF64Pitch = kLanes + 8;   // staged x row, elements
constexpr int kF64Slices = 4;           // 8-lane slices a warp

// band f64[tiles * 16, K] (K % 8 == 0, 16-byte aligned): row o holds
// output o's taps from column starts[o] - starts[o - o % 16]; `rows`: the
// x rows a CTA stages (the widest CTA's fourth tile origin offset + K).
struct F64Band {
  const double* band;
  int K, rows;
};

// Dynamic shared memory of a float band CTA: its four tiles' bands (rows
// K + 4 doubles apart, so a fragment's rows fall in distinct banks) and
// two x windows.
__host__ __device__ constexpr int f64_band_smem(int K, int rows,
                                                int x_bytes) {
  return kF64Outputs * (K + 4) * 8 + 2 * rows * kF64Pitch * x_bytes;
}

// d += a . b, m16n8k8 f64: a [16 x 8] row-major fragment (a[i]: row g +
// 8 (i % 2), column t + 4 (i / 2), g = lane / 4, t = lane % 4), b [8 x 8]
// column-major (b[i]: row t + 4 i, column g), d [16 x 8] (d[i]: row g + 8
// (i / 2), column 2 t + i % 2).
__device__ __forceinline__ void dmma(double (&d)[4], const double (&a)[4],
                                     const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// One CTA: copies its four tiles' bands (zeros past the last tile) and
// the first lane tile's window into shared memory; then for each of its
// lane tiles stages the next window while its warps multiply this one:
// warp (tile i, half j) walks its band in k-steps of 8, each an A fragment
// from the band and four B fragments (8 lanes each) from the window rows
// d_i + k .. (d_i: tile i's origin offset), converted to double, into four
// DMMAs; then rounds each sum once to f32 and stores it (raw) or its
// WORD2INT.
template <typename XT>
__global__ void __launch_bounds__(kThreads, 1)
gather_fir_f64mma_kernel(Gather g, F64Band bw, int raw) {
  extern __shared__ __align__(16) unsigned char f64_band_smem_buf[];
  const int P = bw.K + 4;  // band row pitch, doubles
  double* bs = reinterpret_cast<double*>(f64_band_smem_buf);
  XT* xs = reinterpret_cast<XT*>(bs + kF64Outputs * P);
  const int tid = threadIdx.x, warp = tid / 32, l = tid % 32;
  const int gi = l / 4, ti = l % 4;
  const int tile = warp % 4, half = warp / 4;
  const BandCta cta(g, kF64LaneTiles);
  const int o0 = cta.tile * kF64Outputs;
  const int last = min(o0 + kF64Outputs, g.n_out) - 1;
  const int base = g.starts[o0];
  const int d = g.starts[min(o0 + tile * kF64Tile, last)] - base;
  const int n_rows = (g.n_out + kF64Tile - 1) / kF64Tile * kF64Tile;
  const bool vec = vector_axis<XT>(g);
  constexpr int kV = 16 / sizeof(XT);          // lanes a 16-byte chunk
  constexpr int kChunks = kLanes / kV;         // chunks a staged row

  // the four tiles' bands: 16-byte chunk e % (K/2) of band row e / (K/2)
  for (int e = tid; e < kF64Outputs * (bw.K / 2); e += kThreads) {
    const int r = e / (bw.K / 2), c = e % (bw.K / 2) * 2;
    const bool in = o0 + r < n_rows;
    fir::copy16(fir::smem_addr(bs + r * P + c),
                in ? bw.band + (size_t)(o0 + r) * bw.K + c : bw.band,
                in ? 16 : 0);
  }
  auto stage = [&](int it) {
    if (it < cta.n_lt) {
      const int lane0 = (cta.lt0 + it) * kLanes;
      XT* dst = xs + (it % 2) * bw.rows * kF64Pitch;
      for (int e = tid; e < bw.rows * kChunks; e += kThreads) {
        const int r = e / kChunks, c = e % kChunks * kV;
        copy_axis16<XT>(g, base + r, lane0 + c, vec,
                        fir::smem_addr(dst + r * kF64Pitch + c));
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  stage(0);
  const double* a_row = bs + (tile * kF64Tile + gi) * P + ti;
#pragma unroll 1
  for (int it = 0; it < cta.n_lt; ++it) {
    // the next window's copies run while this one is multiplied; its
    // buffer's last readers passed the barrier that ended iteration it - 1
    stage(it + 1);
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    const XT* xb = xs + (it % 2) * bw.rows * kF64Pitch +
                   (d + ti) * kF64Pitch + half * 32 + gi;
    double acc[kF64Slices][4];
#pragma unroll
    for (int s = 0; s < kF64Slices; ++s)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[s][i] = 0.0;
#pragma unroll 2
    for (int k = 0; k < bw.K; k += 8) {
      const double a[4] = {a_row[k], a_row[8 * P + k], a_row[k + 4],
                           a_row[8 * P + k + 4]};
#pragma unroll
      for (int s = 0; s < kF64Slices; ++s) {
        const double b[2] = {static_cast<double>(xb[k * kF64Pitch + 8 * s]),
                             static_cast<double>(
                                 xb[(k + 4) * kF64Pitch + 8 * s])};
        dmma(acc[s], a, b);
      }
    }
    const int lane0 = (cta.lt0 + it) * kLanes + half * 32;
#pragma unroll
    for (int s = 0; s < kF64Slices; ++s) {
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int o = o0 + tile * kF64Tile + gi + 8 * m;
        const int b = lane0 + 8 * s + 2 * ti;
        if (o >= g.n_out || b >= g.B) continue;
        const float f0 = __double2float_rn(acc[s][2 * m]);
        const float f1 = __double2float_rn(acc[s][2 * m + 1]);
        const size_t at = (size_t)o * g.B + b;
        const bool pair = b + 1 < g.B && g.B % 2 == 0;
        if (raw) {
          float* y = static_cast<float*>(g.y) + at;
          if (pair) {
            *reinterpret_cast<float2*>(y) = make_float2(f0, f1);
          } else {
            y[0] = f0;
            if (b + 1 < g.B) y[1] = f1;
          }
        } else {
          int16_t* y = static_cast<int16_t*>(g.y) + at;
          const int16_t y0 = fir::word2int(f0), y1 = fir::word2int(f1);
          if (pair) {
            *reinterpret_cast<short2*>(y) = make_short2(y0, y1);
          } else {
            y[0] = y0;
            if (b + 1 < g.B) y[1] = y1;
          }
        }
      }
    }
    __syncthreads();
  }
}

// A band kernel's shared-memory ceiling, set once a device (`done` is the
// kernel's own), by its launches and by gather_fir_launch_ctas.
template <typename Kernel>
cudaError_t band_ceiling(Kernel* kernel, std::atomic<unsigned>& done) {
  return fir::set_once(done, [kernel] {
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  });
}
template <int kAccum>
std::atomic<unsigned> fixed_band_set{0};
template <typename XT>
std::atomic<unsigned> f64_band_set{0};

// The grid of a band launch: a CTA a band tile (a fixed group of
// Shape<kAccum>::kRows outputs; kF64Outputs float) and its lane tiles,
// kFixedLaneTiles / kF64LaneTiles a CTA.
template <int kAccum>
unsigned fixed_band_ctas(int n_out, int B) {
  constexpr int kG = fir::fixedtc::Shape<kAccum>::kRows;
  return (unsigned)((n_out + kG - 1) / kG) * band_chunks(B, kFixedLaneTiles);
}
inline unsigned f64_band_ctas(int n_out, int B) {
  return (unsigned)((n_out + kF64Outputs - 1) / kF64Outputs) *
         band_chunks(B, kF64LaneTiles);
}

template <int kAccum>
cudaError_t launch_fixed_band(const Gather& g, const FixedBand& bw,
                              cudaStream_t stream) {
  auto* kernel = gather_fir_fixed_band_kernel<kAccum>;
  const cudaError_t attr = band_ceiling(kernel, fixed_band_set<kAccum>);
  if (attr != cudaSuccess) return attr;
  kernel<<<fixed_band_ctas<kAccum>(g.n_out, g.B), kThreads,
           fixed_band_smem<kAccum>(bw.K), stream>>>(g, bw);
  return cudaGetLastError();
}

template <typename XT>
cudaError_t launch_f64_band(const Gather& g, const F64Band& bw, int raw,
                            cudaStream_t stream) {
  auto* kernel = gather_fir_f64mma_kernel<XT>;
  const cudaError_t attr = band_ceiling(kernel, f64_band_set<XT>);
  if (attr != cudaSuccess) return attr;
  kernel<<<f64_band_ctas(g.n_out, g.B), kThreads,
           f64_band_smem(bw.K, bw.rows, sizeof(XT)), stream>>>(g, bw, raw);
  return cudaGetLastError();
}

// The CTAs of `kernel` (`threads`, `smem` bytes of dynamic shared memory)
// that the current device holds at once: its multiprocessors times the
// occupancy API's CTAs a multiprocessor.
template <typename Kernel>
cudaError_t resident_slots(Kernel* kernel, int threads, int smem,
                           long long* slots) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  *slots = (long long)sms * per_sm;
  return err;
}

// -- streamed band form ------------------------------------------------------

// A CTA takes one band tile (float: 16 outputs; fixed: a warpgroup's
// Shape<kAccum>::kWgRows outputs) over several lane tiles, and streams the
// tile's band and the x rows of its lanes through a ring of stages, a
// stage of taps at a time: a staged band slice serves every lane
// tile of the CTA, a staged x slice every output of the tile.  Where the
// CTAs (tiles x lane chunks) fill the card poorly, a launch splits K over
// `split` CTAs a tile (stream_split): each writes its partial sums, and the
// last of them to finish adds them in split order and runs the epilogue.
// stages in a streamed CTA's ring, by kernel (tools/gather_ablate.py on
// the H100: the float kernel ran within 2 % at 3 and 4 and slower at 6,
// which leaves one CTA an SM; the fixed one, one CTA an SM, fastest at 6
// of 3, 4, 6 and 8)
constexpr int kF64StreamRing = 4;
constexpr int kFixedStreamRing = 6;
constexpr int kStreamMaxSplit = 8;    // K splits a streamed launch may take
constexpr int kStreamMinStages = 16;  // stages a split walks at least
// fixed: 64-lane tiles a CTA, one a warpgroup, sharing each band slice
constexpr int kStreamWgs = 2;
// float: a CTA's lanes (eight warps of 32), taps a stage, the staged band
// and x rows' pitches (floats, samples: a fragment's rows in distinct banks)
constexpr int kF64StreamLanes = kWarps * 32;
constexpr int kF64StreamTaps = 32;
constexpr int kF64StreamBandPitch = kF64StreamTaps + 4;
constexpr int kF64StreamXPitch = kF64StreamLanes + 8;
constexpr int kF64StreamBandBytes = kF64Tile * kF64StreamBandPitch * 4;
constexpr int kF64StreamStage =
    kF64StreamBandBytes + kF64StreamTaps * kF64StreamXPitch * 2;

// A streamed launch's band: float f32[tiles * 16, K]; fixed planes
// int8[2, groups, C, K] (C = kAccum * G, K-major, each 32-tap group
// permuted by K_PERM) with bias int32[groups, C] and, for kAccum 4, coef
// int32[n_out, 4]; K a whole number of stages, 16-byte aligned.  With
// split > 1: part, the splits' partial sums (float: f64[split, tiles * 16,
// B]; fixed: uint32[split, groups, C, B]), and count, int32[units], zero.
struct StreamBand {
  const void* w;
  const int32_t* bias;
  const int32_t* coef;
  int K, split;
  void* part;
  int* count;
};

// Dynamic shared memory of a streamed CTA: float, the ring; fixed, the
// ring (each stage the two planes' K-slices and each warpgroup's x rows),
// each warpgroup's output rows, alignment.
__host__ __device__ constexpr int f64_stream_smem() {
  return kF64StreamRing * kF64StreamStage;
}
template <int kAccum>
__host__ __device__ constexpr int fixed_stream_smem() {
  using Sh = fir::fixedtc::Shape<kAccum>;
  return kFixedStreamRing * (2 * i8::kSub * i8::kK * Sh::kN +
                             kStreamWgs * i8::kRawBytes) +
         kStreamWgs * Sh::kWgRows * i8::kRawPitch + 128;
}

// After a split CTA has stored its partial sums: whether it is the last of
// its unit's `split` CTAs to finish (the one that adds them up).  Every
// thread of the CTA calls it.
__device__ __forceinline__ bool last_split(const StreamBand& sb, int unit) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(sb.count + unit, 1) == sb.split - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// Float streamed band: CTA (tile, lane chunk of 256, split) takes the
// tile's 16 outputs over its 256 lanes, warp w lanes 32w .. 32w + 31 as
// four 8-lane N slices, every warp from the tile's K origin starts[o0];
// stage q holds the band's taps 32q .. 32q + 31 of the 16 rows (f32) and
// the x rows starts[o0] + 32q + r, r < 32, of the CTA's lanes (x's type,
// zeros past T and B), copied kF64StreamRing - 1 stages ahead, one
// barrier a stage.  Each k-step of 8 is one A fragment (the f32 band,
// widened as it loads) and four B fragments (int16 x, widened) into four
// DMMAs; the sums are f64, rounded once to f32 (split: the f64 partials
// added in split order first).  A warp whose lanes all lie past B copies
// but does not multiply.
template <typename XT>
__global__ void __launch_bounds__(kThreads, 2)
gather_fir_f64mma_stream_kernel(Gather g, StreamBand sb, int raw) {
  extern __shared__ __align__(16) unsigned char f64_stream_smem_buf[];
  constexpr int kV = 16 / sizeof(XT);                // lanes a 16-byte chunk
  constexpr int kChunks = kF64StreamLanes / kV;      // chunks a staged row
  const int tid = threadIdx.x, warp = tid / 32, l = tid % 32;
  const int gi = l / 4, ti = l % 4;
  const int chunks = (g.B + kF64StreamLanes - 1) / kF64StreamLanes;
  const int split = blockIdx.x % sb.split, unit = blockIdx.x / sb.split;
  const int o0 = unit / chunks * kF64Tile;
  const int lane0 = unit % chunks * kF64StreamLanes;
  const int base = g.starts[o0];
  const int n_st = sb.K / kF64StreamTaps;
  const int s0 = split * n_st / sb.split, s1 = (split + 1) * n_st / sb.split;
  const bool vec = vector_axis<XT>(g);
  const bool busy = lane0 + warp * 32 < g.B;
  const float* band = static_cast<const float*>(sb.w) + (size_t)o0 * sb.K;
  auto stage_at = [&](int q) {
    return f64_stream_smem_buf + q % kF64StreamRing * kF64StreamStage;
  };
  // stage q: one cp.async group, empty past s1
  auto copy_stage = [&](int q) {
    if (q < s1) {
      unsigned char* buf = stage_at(q);
      const int t0 = q * kF64StreamTaps;
      if (tid < kF64Tile * kF64StreamTaps / 4) {
        const int r = tid / (kF64StreamTaps / 4);
        const int c = tid % (kF64StreamTaps / 4) * 4;
        fir::copy16(fir::smem_addr(buf + (r * kF64StreamBandPitch + c) * 4),
                    band + (size_t)r * sb.K + t0 + c, 16);
      }
      XT* xs = reinterpret_cast<XT*>(buf + kF64StreamBandBytes);
      for (int e = tid; e < kF64StreamTaps * kChunks; e += kThreads) {
        const int r = e / kChunks, c = e % kChunks * kV;
        copy_axis16<XT>(g, base + t0 + r, lane0 + c, vec,
                        fir::smem_addr(xs + r * kF64StreamXPitch + c));
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  double acc[kF64Slices][4];
#pragma unroll
  for (int s = 0; s < kF64Slices; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[s][i] = 0.0;
#pragma unroll
  for (int q = 0; q < kF64StreamRing - 1; ++q) copy_stage(s0 + q);
#pragma unroll 1
  for (int q = s0; q < s1; ++q) {
    // stage q has landed; its buffer's next copy (stage q +
    // kF64StreamRing - 1) waits for this barrier, after every read of
    // stage q - 1
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kF64StreamRing - 2)
                 : "memory");
    __syncthreads();
    copy_stage(q + kF64StreamRing - 1);
    if (!busy) continue;
    const unsigned char* buf = stage_at(q);
    const float* a_row =
        reinterpret_cast<const float*>(buf) + gi * kF64StreamBandPitch + ti;
    const XT* xb = reinterpret_cast<const XT*>(buf + kF64StreamBandBytes) +
                   ti * kF64StreamXPitch + warp * 32 + gi;
#pragma unroll
    for (int k = 0; k < kF64StreamTaps; k += 8) {
      const double a[4] = {a_row[k], a_row[8 * kF64StreamBandPitch + k],
                           a_row[k + 4],
                           a_row[8 * kF64StreamBandPitch + k + 4]};
#pragma unroll
      for (int s = 0; s < kF64Slices; ++s) {
        const double b[2] = {
            static_cast<double>(xb[k * kF64StreamXPitch + 8 * s]),
            static_cast<double>(xb[(k + 4) * kF64StreamXPitch + 8 * s])};
        dmma(acc[s], a, b);
      }
    }
  }
  // acc[s][2m + e]: output o0 + gi + 8m, lane lane0 + 32 warp + 8s + 2ti + e
  const int n_rows = (g.n_out + kF64Tile - 1) / kF64Tile * kF64Tile;
  double* part = static_cast<double*>(sb.part);
  auto at = [&](int s, int m) {
    return (size_t)(o0 + gi + 8 * m) * g.B + lane0 + warp * 32 + 8 * s +
           2 * ti;
  };
  if (sb.split > 1) {
#pragma unroll
    for (int s = 0; s < kF64Slices; ++s)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int b = lane0 + warp * 32 + 8 * s + 2 * ti + i % 2;
        if (b < g.B)
          part[(size_t)split * n_rows * g.B + at(s, i / 2) + i % 2] =
              acc[s][i];
      }
    if (!last_split(sb, unit)) return;
#pragma unroll
    for (int s = 0; s < kF64Slices; ++s)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int b = lane0 + warp * 32 + 8 * s + 2 * ti + i % 2;
        double sum = 0.0;
        for (int p = 0; p < sb.split && b < g.B; ++p)
          sum += __ldcg(part + (size_t)p * n_rows * g.B + at(s, i / 2) +
                        i % 2);
        acc[s][i] = sum;
      }
  }
#pragma unroll
  for (int s = 0; s < kF64Slices; ++s) {
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int o = o0 + gi + 8 * m;
      const int b = lane0 + warp * 32 + 8 * s + 2 * ti;
      if (o >= g.n_out || b >= g.B) continue;
      const float f0 = __double2float_rn(acc[s][2 * m]);
      const float f1 = __double2float_rn(acc[s][2 * m + 1]);
      const size_t y_at = at(s, m);
      const bool pair = b + 1 < g.B && g.B % 2 == 0;
      if (raw) {
        float* y = static_cast<float*>(g.y) + y_at;
        if (pair) {
          *reinterpret_cast<float2*>(y) = make_float2(f0, f1);
        } else {
          y[0] = f0;
          if (b + 1 < g.B) y[1] = f1;
        }
      } else {
        int16_t* y = static_cast<int16_t*>(g.y) + y_at;
        const int16_t y0 = fir::word2int(f0), y1 = fir::word2int(f1);
        if (pair) {
          *reinterpret_cast<short2*>(y) = make_short2(y0, y1);
        } else {
          y[0] = y0;
          if (b + 1 < g.B) y[1] = y1;
        }
      }
    }
  }
}

// Fixed streamed band: CTA (group, chunk of kStreamWgs lane tiles, split)
// takes the group's G = kWgRows outputs (kN = kAccum * G band columns, the
// wgmma's N, set-major as fir_tile's warpgroup reads them), warpgroup h
// lane tile chunk * kStreamWgs + h, from the group's K origin starts[o0].
// Stage q holds both planes' two K-slices of taps 64q .. 64q + 63 (all
// threads copy them) and each warpgroup's x rows of those taps (it copies
// its own), copied kFixedStreamRing - 2 stages ahead; a CTA barrier a
// stage; the pipeline and the four wgmmas a K-slice are fixed_wgmma.cuh's
// fir_tile's.  Then the band kernel's epilogue a warpgroup (split: the
// uint32 sums of every split added first); a warpgroup whose lanes all lie
// past B (its x zeros) stores nothing.
template <int kAccum>
__global__ void __launch_bounds__(kStreamWgs * kWgThreads, 1)
gather_fir_fixed_stream_kernel(Gather g, StreamBand sb) {
  using Sh = fir::fixedtc::Shape<kAccum>;
  constexpr int kG = Sh::kWgRows, kC = Sh::kN;
  constexpr int kTile = i8::kK * kC;        // one plane's K-slice
  constexpr int kW = 2 * i8::kSub * kTile;  // a stage's band
  constexpr int kStage = kW + kStreamWgs * i8::kRawBytes;
  constexpr int kCta = kStreamWgs * kWgThreads;
  constexpr int kLead = kFixedStreamRing - 2;
  extern __shared__ uint8_t fixed_stream_smem_buf[];
  const int tid = threadIdx.x, h = tid / kWgThreads, wt = tid % kWgThreads;
  const int w = wt / 32, l = tid % 32;
  const int chunks = (g.B + kStreamWgs * kLanes - 1) / (kStreamWgs * kLanes);
  const int split = blockIdx.x % sb.split, unit = blockIdx.x / sb.split;
  const int grp = unit / chunks;
  const int lane0 = (unit % chunks * kStreamWgs + h) * kLanes;
  const int o0 = grp * kG, v0 = g.starts[o0];
  const int n_st = sb.K / i8::kStageTaps;
  const int s0 = split * n_st / sb.split, s1 = (split + 1) * n_st / sb.split;
  const uint32_t ring = (fir::smem_addr(fixed_stream_smem_buf) + 127) & ~127u;
  const uint32_t out =
      ring + kFixedStreamRing * kStage + h * kG * i8::kRawPitch;
  const bool vec = vector_axis<int16_t>(g);
  const int groups = (g.n_out + kG - 1) / kG;
  // This thread's band copies: chunk e = tid + i * kCta is 16-byte half e %
  // 2 of band column n's K-slice j in plane p (j, p, n from e below); its
  // source from a stage's first tap and its place in a stage.
  constexpr int kCopies = 2 * i8::kSub * kC * 2 / kCta;
  const int8_t* wsrc[kCopies];
  uint32_t wdst[kCopies];
#pragma unroll
  for (int i = 0; i < kCopies; ++i) {
    const int e = tid + i * kCta, c = e % 2, n = e / 2 % kC;
    const int j = e / (2 * kC) % i8::kSub, p = e / (2 * kC * i8::kSub);
    wsrc[i] = static_cast<const int8_t*>(sb.w) +
              ((size_t)(p * groups + grp) * kC + n) * sb.K + j * i8::kK +
              c * 16;
    wdst[i] = (p * i8::kSub + j) * kTile + i8::core_offset(n, c);
  }
  // This thread's ldmatrix row (int8tc::load_split).
  const uint32_t frag = (8 * (l / 16) + l % 8) * i8::kRawPitch +
                        (16 * w + 8 * ((l / 8) % 2)) * 2;

  auto stage_at = [&](int q) { return ring + q % kFixedStreamRing * kStage; };
  // stage q: one cp.async group, empty past s1 (x past B: zeros)
  auto copy_stage = [&](int q) {
    if (q < s1) {
      const uint32_t buf = stage_at(q);
      const int t0 = q * i8::kStageTaps;
#pragma unroll
      for (int i = 0; i < kCopies; ++i)
        fir::copy16(buf + wdst[i], wsrc[i] + t0, 16);
#pragma unroll
      for (int r = 0; r < i8::kStageTaps * kLanes / 8 / kWgThreads; ++r) {
        const int i = wt + r * kWgThreads, tap = i / (kLanes / 8);
        const int lane = (i % (kLanes / 8)) * 8;
        copy_axis16<int16_t>(g, v0 + t0 + tap, lane0 + lane, vec,
                             buf + kW + h * i8::kRawBytes +
                                 tap * i8::kRawPitch + lane * 2);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  // this thread's copies of the next stage have landed; then every
  // thread's, visible to the tensor cores and to ldmatrix
  auto stage_ready = [&]() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kLead - 1) : "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
  };

  int acc[3][Sh::kAcc];  // hh, mid, ll
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int i = 0; i < Sh::kAcc; ++i) acc[j][i] = 0;
#pragma unroll
  for (int q = 0; q < kLead; ++q) copy_stage(s0 + q);
  stage_ready();
  uint32_t xh[2][4], xl[2][4];
#pragma unroll 1
  for (int q = s0; q < s1; ++q) {
    const uint32_t buf = stage_at(q);
#pragma unroll
    for (int j = 0; j < i8::kSub; ++j) {
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      i8::pin(xh[j]);
      i8::pin(xl[j]);
      i8::load_split(
          buf + kW + h * i8::kRawBytes + j * i8::kK * i8::kRawPitch + frag,
          xh[j], xl[j]);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      const int accumulate = q > s0 || j > 0;
      const uint64_t bh = i8::descriptor(buf + j * kTile);
      const uint64_t bl = i8::descriptor(buf + (i8::kSub + j) * kTile);
      fir::fixedtc::mma(acc[0], xh[j], bh, accumulate);
      fir::fixedtc::mma(acc[1], xl[j], bh, accumulate);
      fir::fixedtc::mma(acc[1], xh[j], bl, 1);
      fir::fixedtc::mma(acc[2], xl[j], bl, accumulate);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // later stages' copies run while this stage's wgmmas do
      if (j == 0) copy_stage(q + kLead);
    }
    stage_ready();
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int j = 0; j < 3; ++j) i8::pin(acc[j]);

  // Accumulator register i = set * kPer + e of thread (warp w, lane l):
  // lane 16w + l/4 + 8*((e/2)%2), output o0 + r, r = 8*(e/4) + 2*(l%4) +
  // e%2 (fir_tile's map), band column set * G + r.
  uint32_t* part = static_cast<uint32_t*>(sb.part);
  auto at = [&](int p, int set, int r, int lane) {
    return (((size_t)p * groups + grp) * kC + set * kG + r) * g.B + lane;
  };
  if (sb.split > 1) {
#pragma unroll
    for (int e = 0; e < Sh::kPer; ++e) {
      const int lane = lane0 + 16 * w + l / 4 + 8 * ((e / 2) % 2);
      const int r = 8 * (e / 4) + 2 * (l % 4) + e % 2;
#pragma unroll
      for (int set = 0; set < kAccum; ++set) {
        const int i = set * Sh::kPer + e;
        if (lane < g.B)
          part[at(split, set, r, lane)] = 65536u * (unsigned)acc[0][i] +
                                          256u * (unsigned)acc[1][i] +
                                          (unsigned)acc[2][i];
      }
    }
    if (!last_split(sb, unit)) return;
  }
  if (lane0 >= g.B) return;
  const int32_t* bias_g = sb.bias + (size_t)grp * kC;
#pragma unroll
  for (int e = 0; e < Sh::kPer; ++e) {
    const int lane = 16 * w + l / 4 + 8 * ((e / 2) % 2);
    const int r = 8 * (e / 4) + 2 * (l % 4) + e % 2;
    const int o = o0 + r;
    unsigned mix = 0;
#pragma unroll
    for (int set = 0; set < kAccum; ++set) {
      const int i = set * Sh::kPer + e;
      unsigned sum = (unsigned)bias_g[set * kG + r];
      if (sb.split > 1) {
        for (int p = 0; p < sb.split && lane0 + lane < g.B; ++p)
          sum += __ldcg(part + at(p, set, r, lane0 + lane));
      } else {
        sum += 65536u * (unsigned)acc[0][i] + 256u * (unsigned)acc[1][i] +
               (unsigned)acc[2][i];
      }
      mix = kAccum == 1
                ? sum
                : mix + fir::mult16_32_q15(
                            o < g.n_out ? sb.coef[(size_t)o * 4 + set] : 0,
                            (int)sum >> 1);
    }
    asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(out + r * i8::kRawPitch +
                                                   lane * 2),
                 "h"(fir::sat32pshr15((int)mix))
                 : "memory");
  }
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + h), "n"(kWgThreads) : "memory");
  const bool vec_y = g.B % 8 == 0 && reinterpret_cast<uintptr_t>(g.y) % 16 == 0;
#pragma unroll
  for (int r = 0; r < kG * kLanes / 8 / kWgThreads; ++r) {
    const int chunk = wt + r * kWgThreads;
    const int row = chunk / (kLanes / 8), cl = chunk % (kLanes / 8) * 8;
    const int o = o0 + row, lane = lane0 + cl;
    if (o >= g.n_out || lane >= g.B) continue;
    uint32_t v[4];
    asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
                 : "r"(out + row * i8::kRawPitch + cl * 2)
                 : "memory");
    int16_t* dst = static_cast<int16_t*>(g.y) + (size_t)o * g.B + lane;
    if (vec_y) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int b = 0; b < 8; ++b)
        if (lane + b < g.B) dst[b] = (int16_t)(v[b / 2] >> (16 * (b & 1)));
    }
  }
}

// Sets a streamed kernel's shared memory (once a device) and gives the K
// splits of its launch over `units` CTAs of n_st stages each, and the CTAs
// the card holds at once (*slots).  Where the
// units fill a wave of the card's resident CTAs (multiprocessors times the
// kernel's CTAs each), 1: their last, partial wave runs on an L2 the others
// no longer share, and splitting only adds the partial sums' traffic
// (tools/gather_ablate.py, PERF.md section 6).  Else, of s in 1 ..
// kStreamMaxSplit (each split at least kStreamMinStages stages), the one
// whose units * s CTAs take the fewest waves for their 1 / s of the work;
// the smallest s on a tie.
template <typename Kernel>
cudaError_t stream_split(Kernel* kernel, std::atomic<unsigned>& smem_set,
                         int threads, int smem, int units, int n_st,
                         int* split, long long* slots) {
  cudaError_t err = fir::set_once(smem_set, [kernel, smem] {
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  });
  if (err == cudaSuccess) err = resident_slots(kernel, threads, smem, slots);
  if (err != cudaSuccess) return err;
  if (*slots < 1) return cudaErrorInvalidConfiguration;
  auto waves = [&](int s) {
    return ((long long)units * s + *slots - 1) / *slots;
  };
  *split = 1;
  for (int s = 2; units < *slots && s <= kStreamMaxSplit &&
                  n_st / s >= kStreamMinStages;
       ++s)
    if (waves(s) * *split < waves(*split) * s) *split = s;
  return cudaSuccess;
}

// A streamed launch's shape (n_accum 0: float): its K splits, its CTAs
// without the splits (units), their threads and shared memory, the bytes
// of its partial sums (0 unsplit), the CTAs the card holds at once
// (slots); the kernel's ceiling set.
struct StreamShape {
  int split, units, threads, smem;
  long long part_bytes, slots;
};

cudaError_t stream_shape(int n_accum, int n_out, int B, int K,
                         StreamShape* sh) {
  static std::atomic<unsigned> set_f64{0}, set_fixed4{0}, set_fixed1{0};
  if (n_out < 1 || B < 1 || K < 1) return cudaErrorInvalidValue;
  cudaError_t err;
  if (n_accum == 0) {
    const int tiles = (n_out + kF64Tile - 1) / kF64Tile;
    sh->units = tiles * ((B + kF64StreamLanes - 1) / kF64StreamLanes);
    sh->threads = kThreads;
    sh->smem = f64_stream_smem();
    err = stream_split(gather_fir_f64mma_stream_kernel<int16_t>, set_f64,
                       sh->threads, sh->smem, sh->units, K / kF64StreamTaps,
                       &sh->split, &sh->slots);
    sh->part_bytes = (long long)sh->split * tiles * kF64Tile * B * 8;
  } else if (n_accum == 1 || n_accum == 4) {
    const int G = n_accum == 4 ? fir::fixedtc::Shape<4>::kWgRows
                               : fir::fixedtc::Shape<1>::kWgRows;
    const int groups = (n_out + G - 1) / G;
    sh->units =
        groups * ((B + kStreamWgs * kLanes - 1) / (kStreamWgs * kLanes));
    sh->threads = kStreamWgs * kWgThreads;
    sh->smem = n_accum == 4 ? fixed_stream_smem<4>() : fixed_stream_smem<1>();
    const int n_st = K / i8::kStageTaps;
    err = n_accum == 4
              ? stream_split(gather_fir_fixed_stream_kernel<4>, set_fixed4,
                             sh->threads, sh->smem, sh->units, n_st,
                             &sh->split, &sh->slots)
              : stream_split(gather_fir_fixed_stream_kernel<1>, set_fixed1,
                             sh->threads, sh->smem, sh->units, n_st,
                             &sh->split, &sh->slots);
    sh->part_bytes = (long long)sh->split * groups * n_accum * G * B * 4;
  } else {
    return cudaErrorInvalidValue;
  }
  if (sh->split == 1) sh->part_bytes = 0;
  return err;
}

static_assert(i8::kStageTaps * kLanes / 8 % kWgThreads == 0,
              "whole x copies a warpgroup");
static_assert(kF64StreamRing >= 3 && kFixedStreamRing >= 3,
              "a streamed ring runs at least a stage ahead");
static_assert(2 * i8::kSub * fir::fixedtc::Shape<1>::kN * 2 %
                      (kStreamWgs * kWgThreads) ==
                  0,
              "whole band copies a fixed streamed CTA");
static_assert(fixed_stream_smem<4>() <= kMaxSmem &&
                  fixed_stream_smem<1>() <= kMaxSmem &&
                  f64_stream_smem() <= kMaxSmem,
              "a streamed CTA fits");
static_assert(fir::fixedtc::Shape<4>::kWgRows * kLanes / 8 % kWgThreads ==
                      0 &&
                  fir::fixedtc::Shape<1>::kWgRows * kLanes / 8 % kWgThreads ==
                      0,
              "whole output stores a warpgroup");
static_assert(kThreads == 8 * 32 && kF64Outputs * 2 == kWarps * kF64Tile,
              "eight warps: four 16-output tiles, two lane halves");

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

// The dynamic shared memory of a band CTA (ops/fir_matmul.gather_plan's
// formula, checked against this when the library loads): n_accum 0 the
// float band kernel (K taps, `rows` staged x rows of x_bytes samples),
// n_accum 1 or 4 the fixed one (K taps); and the most a CTA may take.
int gather_fir_band_smem(int n_accum, int x_bytes, int K, int rows) {
  if (n_accum == 4) return fixed_band_smem<4>(K);
  if (n_accum == 1) return fixed_band_smem<1>(K);
  return f64_band_smem(K, rows, x_bytes);
}
int gather_fir_band_smem_max() { return kMaxSmem; }

// The CTAs of a band (form 0) or stream (form 1) launch on the current
// device, as its launcher takes them: n_accum 0 the float kernel (x_bytes
// its samples, 2 or 4; the stream form takes 2), 1 or 4 the fixed one; n_out
// outputs over B lanes, K band taps, `rows` x rows a float band CTA stages.
// *ctas: the launch's grid; *resident: those the card holds at once, the
// occupancy API's CTAs a multiprocessor at the launch's dynamic shared
// memory times the multiprocessors, at most *ctas.  Sets the kernel's
// shared-memory ceiling as its launch does; launches nothing.
int gather_fir_launch_ctas(int form, int n_accum, int x_bytes, int n_out,
                           int B, int K, int rows, int* ctas, int* resident) {
  *ctas = *resident = 0;
  if (n_out < 1 || B < 1 || K < 1 || (form == 1 && x_bytes != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  long long grid = 0, slots = 0;
  cudaError_t err;
  // a band kernel's ceiling set, then its CTAs an SM at `smem`
  auto band = [&](auto* kernel, std::atomic<unsigned>& done, int smem) {
    if (smem > kMaxSmem) return cudaErrorInvalidValue;
    const cudaError_t e = band_ceiling(kernel, done);
    return e == cudaSuccess ? resident_slots(kernel, kThreads, smem, &slots)
                            : e;
  };
  if (form == 1) {
    StreamShape sh{};
    err = stream_shape(n_accum, n_out, B, K, &sh);
    grid = (long long)sh.units * sh.split;
    slots = sh.slots;
  } else if (form != 0) {
    err = cudaErrorInvalidValue;
  } else if (n_accum == 4) {
    grid = fixed_band_ctas<4>(n_out, B);
    err = band(gather_fir_fixed_band_kernel<4>, fixed_band_set<4>,
               fixed_band_smem<4>(K));
  } else if (n_accum == 1) {
    grid = fixed_band_ctas<1>(n_out, B);
    err = band(gather_fir_fixed_band_kernel<1>, fixed_band_set<1>,
               fixed_band_smem<1>(K));
  } else if (n_accum == 0 && rows >= K && (x_bytes == 2 || x_bytes == 4)) {
    grid = f64_band_ctas(n_out, B);
    const int smem = f64_band_smem(K, rows, x_bytes);
    err = x_bytes == 2 ? band(gather_fir_f64mma_kernel<int16_t>,
                              f64_band_set<int16_t>, smem)
                       : band(gather_fir_f64mma_kernel<float>,
                              f64_band_set<float>, smem);
  } else {
    err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  *ctas = static_cast<int>(grid);
  *resident = static_cast<int>(grid < slots ? grid : slots);
  return 0;
}

// The band form (float): hist and x as gather_fir_f32; band f64[ceil(n_out
// / 16) * 16, K] (K % 8 == 0, 16-byte aligned; ops/fir_matmul.gather_band),
// `rows` x rows a CTA stages.
int gather_fir_f32_band(const void* h, long long hst, long long hsb, int H,
                        const void* x, long long st, long long sb, int x_f32,
                        const void* band, const void* starts, void* y, int T,
                        int B, int n_out, int K, int rows, int raw,
                        void* stream) {
  cudaGetLastError();
  if (n_out < 1 || B < 1 || K < 8 || K % 8 || rows < K ||
      f64_band_smem(K, rows, x_f32 ? 4 : 2) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(band) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const Gather g = make_gather(h, hst, hsb, H, x, st, sb, T, B, starts, n_out,
                               K, K, rows, y);
  const F64Band bw{static_cast<const double*>(band), K, rows};
  const auto st_ = static_cast<cudaStream_t>(stream);
  return static_cast<int>(x_f32 ? launch_f64_band<float>(g, bw, raw, st_)
                                : launch_f64_band<int16_t>(g, bw, raw, st_));
}

// The band form (fixed): hist and x int16 as gather_fir_fixed; planes
// int8[2, groups, n_accum * G, K] (G = 32 for n_accum 4, 64 for 1; K % 32
// == 0, 16-byte aligned), bias int32[groups, n_accum * G], coef
// int32[n_out, 4] (NULL for n_accum 1).
int gather_fir_fixed_band(const void* h, long long hst, long long hsb, int H,
                          const void* x, long long st, long long sb,
                          const void* planes, const void* bias,
                          const void* starts, const void* coef, void* y,
                          int n_accum, int T, int B, int n_out, int K,
                          void* stream) {
  cudaGetLastError();
  if ((n_accum != 1 && n_accum != 4) || n_out < 1 || B < 1 || K < 32 ||
      K % 32 || (n_accum == 4) != (coef != nullptr) ||
      (n_accum == 4 ? fixed_band_smem<4>(K) : fixed_band_smem<1>(K)) >
          kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(planes) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const Gather g = make_gather(h, hst, hsb, H, x, st, sb, T, B, starts, n_out,
                               K, K, 1, y);
  const FixedBand bw{static_cast<const int8_t*>(planes),
                     static_cast<const int32_t*>(bias),
                     static_cast<const int32_t*>(coef), K};
  const auto st_ = static_cast<cudaStream_t>(stream);
  return static_cast<int>(n_accum == 4 ? launch_fixed_band<4>(g, bw, st_)
                                       : launch_fixed_band<1>(g, bw, st_));
}

// The dynamic shared memory of a streamed CTA (ops/fir_matmul._stream_smem):
// n_accum 0 the float kernel, 1 or 4 the fixed one.
int gather_fir_stream_smem(int n_accum) {
  if (n_accum == 4) return fixed_stream_smem<4>();
  if (n_accum == 1) return fixed_stream_smem<1>();
  return f64_stream_smem();
}

// The scratch of a streamed launch (n_accum 0: float) of n_out outputs, B
// lanes and K band taps on the current device: the bytes of its partial
// sums and its int32 counters (both 0 where it does not split K), which
// the caller allocates, the counters zeroed, and hands to the launch.
int gather_fir_stream_scratch(int n_accum, int n_out, int B, int K,
                              long long* part_bytes, int* counters) {
  StreamShape sh{};
  const cudaError_t err = stream_shape(n_accum, n_out, B, K, &sh);
  *part_bytes = sh.part_bytes;
  *counters = sh.split > 1 ? sh.units : 0;
  return static_cast<int>(err);
}

// The streamed band (float): hist and x int16 as gather_fir_f32; band
// f32[ceil(n_out / 16) * 16, K] (K % 32 == 0, 16-byte aligned;
// ops/fir_matmul.gather_band); part and count the scratch of
// gather_fir_stream_scratch (NULL where it gives none).
int gather_fir_f32_stream(const void* h, long long hst, long long hsb, int H,
                          const void* x, long long st, long long sb,
                          const void* band, const void* starts, void* y,
                          int T, int B, int n_out, int K, int raw, void* part,
                          void* count, void* stream) {
  cudaGetLastError();
  if (K < kF64StreamTaps || K % kF64StreamTaps)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(band) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  StreamShape sh{};
  cudaError_t err = stream_shape(0, n_out, B, K, &sh);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (sh.split > 1 && (part == nullptr || count == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Gather g = make_gather(h, hst, hsb, H, x, st, sb, T, B, starts, n_out,
                               K, K, 1, y);
  const StreamBand bw{band, nullptr, nullptr, K, sh.split, part,
                      static_cast<int*>(count)};
  gather_fir_f64mma_stream_kernel<int16_t>
      <<<sh.units * sh.split, sh.threads, sh.smem,
         static_cast<cudaStream_t>(stream)>>>(g, bw, raw);
  return static_cast<int>(cudaGetLastError());
}

// The streamed band (fixed): hist and x int16 as gather_fir_fixed; planes
// int8[2, groups, n_accum * G, K] (G = 16 for n_accum 4, 32 for 1; K % 64
// == 0, 16-byte aligned), bias int32[groups, n_accum * G], coef int32[n_out,
// 4] (NULL for n_accum 1); part and count as gather_fir_f32_stream.
int gather_fir_fixed_stream(const void* h, long long hst, long long hsb,
                            int H, const void* x, long long st, long long sb,
                            const void* planes, const void* bias,
                            const void* starts, const void* coef, void* y,
                            int n_accum, int T, int B, int n_out, int K,
                            void* part, void* count, void* stream) {
  cudaGetLastError();
  if ((n_accum != 1 && n_accum != 4) || K < i8::kStageTaps ||
      K % i8::kStageTaps || (n_accum == 4) != (coef != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(planes) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  StreamShape sh{};
  cudaError_t err = stream_shape(n_accum, n_out, B, K, &sh);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (sh.split > 1 && (part == nullptr || count == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Gather g = make_gather(h, hst, hsb, H, x, st, sb, T, B, starts, n_out,
                               K, K, 1, y);
  const StreamBand bw{planes, static_cast<const int32_t*>(bias),
                      static_cast<const int32_t*>(coef), K, sh.split, part,
                      static_cast<int*>(count)};
  const auto st_ = static_cast<cudaStream_t>(stream);
  if (n_accum == 4)
    gather_fir_fixed_stream_kernel<4>
        <<<sh.units * sh.split, sh.threads, sh.smem, st_>>>(g, bw);
  else
    gather_fir_fixed_stream_kernel<1>
        <<<sh.units * sh.split, sh.threads, sh.smem, st_>>>(g, bw);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
