// Probe P5 on Hopper: the flagship's int8 launch (K1b, 44.1 kHz -> 48 kHz
// q7, D = 3 digit planes) split into its parts.  It replaces the Pallas
// kernel of experiments/v3_overhead_anatomy.py (_make_variant :83, its
// pallas_call :230): at the flagship's tiled geometry (P 20, S 2352, R 128,
// K 264, H 128, 4 periods, n_blocks 80) output block (period j, phase m)
// is R rows of every lane, from the K-row patch of the virtual axis hist ++
// x at v(j, m) = j * S + offsets[m]:
//
//   full         K1b's function: for d = 0..2, I_d = 256 * <w_d, xh> +
//                <w_d, xl> (uint32), acc = acc + float(I_d) * scale_d
//                (__fadd_rn / __fmul_rn), then WORD2INT(acc + bias[m]);
//                bit-identical to tiled_fir_int8_kernel<3, true>
//   hoist        the same output; x is split into its int8 planes xh = x >>
//                8 and xl = (x & 255) - 128 once an element, by a pre-pass
//                in the launch, and the walk reads the planes
//   no_assemble  every block of period j reads phase 0's patch v(j, 0),
//                with the full epilogue
//   no_epilogue  the block's own patch, sum_d <w_d, xh> + <w_d, xl> in one
//                int32 accumulator, wrapped to int16 (no combine, bias or
//                WORD2INT)
//   dots_only    phase 0's patch of the period, no_epilogue's raw sum
//
// A TPU program is one (lane tile, period): it assembles each phase's patch
// from VMEM views into a scratch block, extracts, dots and stores, phase
// after phase.  Hopper has no VMEM-to-VMEM assembly: the served K1b reads a
// patch by ldmatrix straight from its staged x ring, and keeps a (phase,
// row tile)'s digit band resident across 8 output tiles.  So this kernel
// takes the TPU probe's program order instead, in which the variants'
// savings exist: a CTA (two warpgroups, 256 threads) owns one (period j,
// 64-row tile, 64 lanes) and walks its P phases in order.  For each phase
// it copies the row tile's digit band (the D planes' nonzero K-slices,
// fir_tile_resident's band layout) and the x rows of that band into one of
// two stage buffers (16-byte cp.async, the next phase's copies in flight
// while this phase's wgmmas run), then each warpgroup runs its 32 rows
// (m64n32k32 .s32.s8.s8, int8tc::mma, xh / xl fragments by
// int8tc::load_split) and the epilogue, whose int16 rows leave through
// shared memory as 16-byte stores.  The variants change only what the TPU
// variant changes:
//
// - hoist: the pre-pass writes xh and xl as two int8 planes [H + T + K,
//   B] (rows past the chunk: x = 0, so xh = 0 and xl = -128); the walk
//   copies their rows and builds fragments by probes::load_pairs (no
//   extraction; the fragment's lanes then pair up, tile_lane<true>).
// - no_assemble, dots_only: the CTA copies phase 0's whole patch (K rows,
//   41 KB) once and reads every phase's band from it; only the digit bands
//   stream.
// - no_epilogue, dots_only: one accumulator for the 2 * D wgmmas a K-slice,
//   its int32 stored as int16 (two's complement truncation).
//
// Shared memory holds what a CTA needs, not the TPU's views: a band of 7
// K-slices is 42 KB of digit tiles and 32 KB of x rows a stage (the TPU
// program's V x S views are 903 KB for 64 lanes as int8 planes).  What
// bounds it: K1b's bound, its 82 MB at 3.35 TB/s (0.0245 ms), beside 3.90
// G band multiply-adds of 6 int8 products each (0.024 ms at 1,979 TOP/s).
// chip_smoke.py times each variant beside the served K1b.
#include "probe_common.cuh"

namespace probes {
namespace v3 {

using fir::int8tc::kRawPitch;   // an int16 x row of 64 lanes, padded
using fir::int8tc::kTileBytes;  // one [64 rows x 32 taps] digit tile

constexpr int kFull = 0, kHoist = 1, kNoAssemble = 2, kNoEpilogue = 3,
              kDotsOnly = 4;
constexpr int kD = 3;                      // digit planes (K1b's D)
constexpr int kRows = fir::kRowTile;       // a CTA's rows
constexpr int kWgRows = 32;                // a warpgroup's rows: m64n32k32
constexpr int kThreads = 2 * kWgThreads;
constexpr int kAcc = kWgRows / 2;          // registers an accumulator

static_assert(kRows == 2 * kWgRows && kLanes == fir::int8tc::kLanes,
              "two 32-row warpgroups on the same 64 lanes");

template <int kVar>
__host__ __device__ constexpr bool raw() {
  return kVar == kNoEpilogue || kVar == kDotsOnly;
}
template <int kVar>
__host__ __device__ constexpr bool resident() {
  return kVar == kNoAssemble || kVar == kDotsOnly;
}

// A stage buffer at a band of up to ms K-slices: the digit tiles, then the
// band's x rows (int16, or the two int8 planes; none where the patch is
// resident).
template <int kVar>
__host__ __device__ constexpr int slot_bytes(int ms) {
  return kD * ms * kTileBytes +
         (kVar == kHoist        ? 2 * ms * kK * kPitch8
          : resident<kVar>() ? 0
                                : ms * kK * kRawPitch);
}

// Dynamic shared memory: two stage buffers, the resident patch (K rows),
// the output tile, alignment.
template <int kVar>
__host__ __device__ constexpr int smem_bytes(int ms, int K) {
  return 2 * slot_bytes<kVar>(ms) + (resident<kVar>() ? K * kRawPitch : 0) +
         kRows * kRawPitch + 128;
}

struct Args {
  fir::Launch g;              // hist, x, y, taps [P, R / 64, 2], H, T, B, R,
                              // K (K_pad), P
  const int32_t* offsets;     // [P]
  const int8_t* planes;       // [kD, P, R, K] K-major, 32-tap groups K_PERM
  const float* bias;          // [P, R]
  const int8_t* split;        // hoist: [2, H + T + K, B] xh, xl
  float4 scales;
  int S, n_periods, max_slices;
};

// xh, xl = x >> 8, (x & 255) - 128 of every row of hist ++ x ++ K zero
// rows: 8 lanes a thread and step (B % 16 == 0, rows 16-byte aligned).
__global__ void v3_split_kernel(const fir::Launch g, int8_t* __restrict__ split,
                                int rows) {
  const long long n = (long long)rows * (g.B / 8);
  const size_t plane = (size_t)rows * g.B;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    const int v = (int)(e / (g.B / 8)), lane = (int)(e % (g.B / 8)) * 8;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (v < g.H)
      u = *reinterpret_cast<const uint4*>(g.hist + (size_t)v * g.B + lane);
    else if (v - g.H < g.T)
      u = *reinterpret_cast<const uint4*>(g.x + (size_t)(v - g.H) * g.B + lane);
    const uint2 hi = make_uint2(__byte_perm(u.x, u.y, 0x7531),
                                __byte_perm(u.z, u.w, 0x7531));
    const uint2 lo = make_uint2(__byte_perm(u.x, u.y, 0x6420) ^ 0x80808080u,
                                __byte_perm(u.z, u.w, 0x6420) ^ 0x80808080u);
    *reinterpret_cast<uint2*>(split + (size_t)v * g.B + lane) = hi;
    *reinterpret_cast<uint2*>(split + plane + (size_t)v * g.B + lane) = lo;
  }
}

template <int kVar>
__global__ void __launch_bounds__(kThreads, 1) v3_anatomy_kernel(const Args a) {
  constexpr bool kRaw = raw<kVar>(), kRes = resident<kVar>();
  constexpr bool kPaired = kVar == kHoist;
  constexpr int kAccs = kRaw ? 1 : 2 * kD;
  const fir::Launch& g = a.g;
  extern __shared__ uint8_t v3_smem[];
  const uint32_t base = (fir::smem_addr(v3_smem) + 127) & ~127u;
  const int tid = threadIdx.x, h = tid / kWgThreads;
  const int w = (tid % kWgThreads) / 32, l = tid % 32;
  const int n_lt = (g.B + kLanes - 1) / kLanes, n_rt = g.R / kRows;
  const int lt = blockIdx.x % n_lt, rt = blockIdx.x / n_lt % n_rt;
  const int j = blockIdx.x / (n_lt * n_rt);
  const int lane0 = lt * kLanes, ms = a.max_slices;
  const uint32_t sb = slot_bytes<kVar>(ms);
  const uint32_t xres = base + 2 * sb;               // the resident patch
  const uint32_t out = xres + (kRes ? g.K * kRawPitch : 0);
  const uint32_t xoff = kD * ms * kTileBytes;        // a slot's x rows
  const size_t plane = (size_t)g.P * g.R * g.K;
  const size_t split_plane = (size_t)(g.H + g.T + g.K) * g.B;

  // phase m's band in this row tile: from t_lo rounded down to 32, n_sl
  // K-slices
  auto band = [&](int m, int& t_begin, int& n_sl) {
    const int t_lo = g.taps[(m * n_rt + rt) * 2];
    const int t_hi = g.taps[(m * n_rt + rt) * 2 + 1];
    t_begin = t_lo & ~(kK - 1);
    n_sl = t_hi > t_begin ? (t_hi - t_begin + kK - 1) / kK : 0;
    if (n_sl > ms) __trap();
  };
  // phase m's digit band and x rows into stage buffer m % 2: one cp.async
  // group (empty past the last phase)
  auto copy_stage = [&](int m) {
    if (m < g.P) {
      int t_begin, n_sl;
      band(m, t_begin, n_sl);
      const uint32_t slot = base + (m % 2) * sb;
      const int per_row = 2 * n_sl;                  // 16-byte chunks a row
      const int8_t* src = a.planes + ((size_t)m * g.R + rt * kRows) * g.K;
      for (int e = tid; e < kD * kRows * per_row; e += kThreads) {
        const int cc = e % per_row, n = e / per_row % kRows;
        const int d = e / (per_row * kRows);
        const int t = t_begin + cc * 16;
        const int bytes = min(max(g.K - t, 0), 16);
        fir::copy16(slot + (d * ms + cc / 2) * kTileBytes +
                        fir::int8tc::core_offset(n, cc % 2),
                    bytes ? src + d * plane + (size_t)n * g.K + t : a.planes,
                    bytes);
      }
      const int v = j * a.S + a.offsets[m] + t_begin;
      if (kVar == kHoist) {
        for (int e = tid; e < 2 * n_sl * kK * 4; e += kThreads) {
          const int c = e % 4, r = e / 4 % (n_sl * kK), p = e / (4 * n_sl * kK);
          const int lane = lane0 + 16 * c;
          const bool in = lane < g.B;
          fir::copy16(slot + xoff + (p * ms * kK + r) * kPitch8 + 16 * c,
                      in ? a.split + p * split_plane + (size_t)(v + r) * g.B +
                               lane
                         : a.planes,
                      in ? 16 : 0);
        }
      } else if (!kRes) {
        for (int e = tid; e < n_sl * kK * 8; e += kThreads) {
          const int c = e % 8, r = e / 8;
          fir::copy_x8(g, v + r, lane0 + 8 * c, true,
                       slot + xoff + r * kRawPitch + 16 * c, a.planes);
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  // this thread's ldmatrix row in a K-slice
  const uint32_t frag = kPaired ? l * kPitch8 + 16 * w
                                : (8 * (l / 16) + l % 8) * kRawPitch +
                                      (16 * w + 8 * ((l / 8) % 2)) * 2;
  const int wg_row = h * kWgRows;

  // phase 0's patch (resident variants) rides in the first group
  if (kRes) {
    const int v = j * a.S + a.offsets[0];
    for (int e = tid; e < g.K * 8; e += kThreads) {
      const int c = e % 8, r = e / 8;
      fir::copy_x8(g, v + r, lane0 + 8 * c, true, xres + r * kRawPitch + 16 * c,
                   a.planes);
    }
  }
  copy_stage(0);

  int acc[kAccs][kAcc];
  uint32_t xa[2][4], xb[2][4];       // xh and xl fragments, two sets
#pragma unroll 1
  for (int m = 0; m < g.P; ++m) {
    copy_stage(m + 1);
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    int t_begin, n_sl;
    band(m, t_begin, n_sl);
    const uint32_t slot = base + (m % 2) * sb;
    const uint32_t wt = slot + (wg_row / 8) * 256;
    const uint32_t xs = kRes ? xres + t_begin * kRawPitch + frag
                             : slot + xoff + frag;
    const int pitch = kPaired ? kPitch8 : kRawPitch;
#pragma unroll
    for (int k = 0; k < kAccs; ++k)
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[k][i] = 0;
    // K-slice i, one commit group, its fragments in set s
    auto slice = [&](auto set, int i) {
      constexpr int s = decltype(set)::value;
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      fir::int8tc::pin(xa[s]);
      fir::int8tc::pin(xb[s]);
      const uint32_t at = xs + i * kK * pitch;
      if (kPaired) {
        load_pairs(at, xa[s]);
        load_pairs(at + ms * kK * kPitch8, xb[s]);
      } else {
        fir::int8tc::load_split(at, xa[s], xb[s]);
      }
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int d = 0; d < kD; ++d) {
        const uint64_t b =
            fir::int8tc::descriptor(wt + (d * ms + i) * kTileBytes);
        fir::int8tc::mma(acc[kRaw ? 0 : 2 * d], xa[s], b, 1);
        fir::int8tc::mma(acc[kRaw ? 0 : 2 * d + 1], xb[s], b, 1);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    };
    // whole pairs, then an odd last slice: no exit between a pair's groups
    // (ptxas would serialize the wgmmas, C7513)
#pragma unroll 1
    for (int i = 0; i + 1 < n_sl; i += 2) {
      slice(std::integral_constant<int, 0>{}, i);
      slice(std::integral_constant<int, 1>{}, i + 1);
    }
    if (n_sl % 2) slice(std::integral_constant<int, 0>{}, n_sl - 1);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int k = 0; k < kAccs; ++k) fir::int8tc::pin(acc[k]);

    // the epilogue (int8tc::store_tile's arithmetic, in digit order), each
    // output to the int16 tile in shared memory, then 16-byte row stores
    const float* bias_m = a.bias + (size_t)m * g.R + rt * kRows;
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int lane = tile_lane<kPaired>(w, l, i);
      const int row = wg_row + tile_col(l, i);
      uint16_t q;
      if (kRaw) {
        q = (uint16_t)(uint32_t)acc[0][i];
      } else {
        float total = 0.0f;
#pragma unroll
        for (int d = 0; d < kD; ++d) {
          const uint32_t sum =
              256u * (uint32_t)acc[2 * d][i] + (uint32_t)acc[2 * d + 1][i];
          total = __fadd_rn(total, __fmul_rn(__int2float_rn((int)sum),
                                             fir::int8tc::pick(a.scales, d)));
        }
        q = (uint16_t)fir::word2int(__fadd_rn(total, bias_m[row]));
      }
      asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(out + row * kRawPitch +
                                                     lane * 2),
                   "h"(q)
                   : "memory");
    }
    __syncthreads();
    const int k = j * g.P + m;
#pragma unroll
    for (int r = 0; r < kRows * kLanes / 8 / kThreads; ++r) {
      const int chunk = tid + r * kThreads;
      const int row = chunk / (kLanes / 8), cl = chunk % (kLanes / 8) * 8;
      if (lane0 + cl >= g.B) continue;
      uint4 v;
      asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                   : "r"(out + row * kRawPitch + cl * 2)
                   : "memory");
      *reinterpret_cast<uint4*>(
          g.y + ((size_t)k * g.R + rt * kRows + row) * g.B + lane0 + cl) = v;
    }
    // every thread is done with stage buffer m % 2 and the output tile
    // before the next phase's copies and epilogue reuse them
    __syncthreads();
  }
}

template <typename F>
int dispatch(int variant, F f) {
#define PROBE_V3_CASE(V) \
  if (variant == V) return f(std::integral_constant<int, V>{});
  PROBE_V3_CASE(kFull) PROBE_V3_CASE(kHoist) PROBE_V3_CASE(kNoAssemble)
  PROBE_V3_CASE(kNoEpilogue) PROBE_V3_CASE(kDotsOnly)
#undef PROBE_V3_CASE
  return -static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace v3
}  // namespace probes

extern "C" {

// Dynamic shared memory of one CTA (probes/v3_overhead_anatomy.py tiles by
// it): a band of max_slices K-slices, K_pad patch rows.
int probe_v3_anatomy_smem(int variant, int max_slices, int K) {
  return probes::v3::dispatch(variant, [&](auto v) {
    return probes::v3::smem_bytes<decltype(v)::value>(max_slices, K);
  });
}

// hoist's pre-pass alone: hist int16 [H, B] ++ x int16 [T, B] ++ K rows
// of zeros split into split int8 [2, H + T + K, B] (xh, then xl); B % 8 ==
// 0, every pointer 16-byte aligned.  Launches on `stream`; returns
// cudaGetLastError() (0 on success).
int probe_v3_split(const void* hist, const void* x, void* split, int H,
                   int T, int B, int K, void* stream) {
  cudaGetLastError();
  if ((reinterpret_cast<uintptr_t>(hist) | reinterpret_cast<uintptr_t>(x) |
       reinterpret_cast<uintptr_t>(split)) % 16 ||
      B % 8 || B <= 0 || split == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const fir::Launch g =
      fir::make_launch(hist, x, nullptr, nullptr, H, T, B, 0, K, 0);
  const long long n = (long long)(H + T + K) * (B / 8);
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  probes::v3::v3_split_kernel<<<blocks, 256, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      g, static_cast<int8_t*>(split), H + T + K);
  return static_cast<int>(cudaGetLastError());
}

// variant 0 full, 1 hoist, 2 no_assemble, 3 no_epilogue, 4 dots_only.
// hist int16 [H, B], x int16 [T, B], y int16 [n_periods * P * R, B]; planes
// int8 [3, P, R, K] (K % 32 == 0, each 32-tap group K_PERM: the tiled int8
// device planes) and bias f32 [P, R]; taps int32 [P, R / 64, 2] (no band
// past max_slices K-slices); offsets int32 [P]; split int8 [2, H + T + K,
// B] for hoist (else unused); B % 16 == 0, R % 64 == 0, every pointer
// 16-byte aligned, every patch inside hist ++ x.  Launches the walk (and
// for hoist probe_v3_split's pre-pass before it) on `stream`; returns
// cudaGetLastError() (0 on success).
int probe_v3_anatomy(const void* hist, const void* x, void* y,
                     const void* offsets, const void* taps, const void* planes,
                     const void* bias, void* split, int variant, float s0,
                     float s1, float s2, int H, int T, int B, int R, int K,
                     int P, int S, int n_periods, int max_slices,
                     void* stream) {
  cudaGetLastError();
  const uintptr_t addr =
      reinterpret_cast<uintptr_t>(hist) | reinterpret_cast<uintptr_t>(x) |
      reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(planes) |
      reinterpret_cast<uintptr_t>(bias) | reinterpret_cast<uintptr_t>(split);
  if (addr % 16 || B % 16 || B <= 0 || R % probes::v3::kRows || K % 32 ||
      P <= 0 || n_periods <= 0 || max_slices <= 0 || max_slices > K / 32 ||
      (variant == probes::v3::kHoist && split == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const probes::v3::Args a{
      fir::make_launch(hist, x, y, taps, H, T, B, R, K, P),
      static_cast<const int32_t*>(offsets),
      static_cast<const int8_t*>(planes),
      static_cast<const float*>(bias),
      static_cast<const int8_t*>(split),
      make_float4(s0, s1, s2, 0.0f),
      S,
      n_periods,
      max_slices};
  if (variant == probes::v3::kHoist) {
    const int err = probe_v3_split(hist, x, split, H, T, B, K, stream);
    if (err) return err;
  }
  return probes::v3::dispatch(variant, [&](auto v) {
    constexpr int kV = decltype(v)::value;
    const int smem = probes::v3::smem_bytes<kV>(max_slices, K);
    if (smem > probes::kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
    auto kernel = probes::v3::v3_anatomy_kernel<kV>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int grid = n_periods * (R / probes::v3::kRows) *
                     ((B + probes::kLanes - 1) / probes::kLanes);
    kernel<<<grid, probes::v3::kThreads, smem, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // extern "C"
