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
// (tile below) are fir_tile with what the TPU variant drops taken out:
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
#include "f32_fir.cuh"

namespace probes {
namespace f32a {

namespace f = fir::f32;

constexpr int kFull = 0, kNodot = 1, kNoslice = 2, kNocvt = 3;
constexpr int kXf32Bytes = f::kStageTaps * f::kLanes * 4;   // f32 x rows

// A stage buffer: the weight rows (none for nodot) and the x rows (int16,
// or f32 for nocvt).
template <int kVar>
__host__ __device__ constexpr int slot_bytes() {
  return kVar == kNodot   ? f::kRawBytes
         : kVar == kNocvt ? f::kWBytes + kXf32Bytes
                          : f::kSlotBytes;
}

template <int kVar>
__host__ __device__ constexpr int smem_bytes() {
  return kVar == kFull || kVar == kNoslice
             ? f::kSmemBytes
             : f::kStages * slot_bytes<kVar>() +
                   (kVar == kNodot ? 2 * f::kXfBytes : 0);
}

// nodot and nocvt: fir::f32::fir_tile's tile (block k, row tile rt, lanes
// lane0 .., patch at v0) with the dots or the conversion taken out.  x rows
// come by 16-byte cp.async (B % 8 == 0, rows 16-byte aligned); rows past the
// walk or the chunk are zero-filled, so every multiplied value is finite.
template <int kVar>
__device__ __forceinline__ void tile(const fir::Launch& g, int k, int rt,
                                     int lane0, int v0, const float* w,
                                     const float* xf32) {
  constexpr int kNo = kVar == kNodot;
  extern __shared__ __align__(16) uint8_t f32a_smem[];
  const int tid = threadIdx.x, warp = tid / 32;
  const int sb = warp % f::kSubBands, lg = warp / f::kSubBands;
  const int ty = (tid % 32) / 16, tx = tid % 16;
  const int m = k % g.P;

  int t_lo = 0, t_hi = g.K, sb_lo = 0, sb_hi = g.K;
  if (!kNo) {
    const int32_t* bands =
        g.taps + ((size_t)m * (g.R / f::kSubRows) + rt * f::kSubBands) * 2;
    t_lo = g.K;
    t_hi = 0;
#pragma unroll
    for (int i = 0; i < f::kSubBands; ++i) {
      if (bands[2 * i] < bands[2 * i + 1]) {
        t_lo = min(t_lo, bands[2 * i]);
        t_hi = max(t_hi, bands[2 * i + 1]);
      }
    }
    sb_lo = bands[2 * sb];
    sb_hi = bands[2 * sb + 1];
  }
  const int n = t_hi > t_lo ? (t_hi - t_lo + f::kStageTaps - 1) / f::kStageTaps
                            : 0;
  const float* wm = w + (size_t)m * g.K * g.R + rt * fir::kRowTile;
  auto slot = [&](int s) {
    return f32a_smem + (s % f::kStages) * slot_bytes<kVar>();
  };
  // the f32 x rows of stage s: its own buffer (nocvt) or a converted one
  auto xs_of = [&](int s) {
    return reinterpret_cast<const float*>(
        kVar == kNocvt ? slot(s) + f::kWBytes
                       : f32a_smem + f::kStages * slot_bytes<kVar>() +
                             (s % 2) * f::kXfBytes);
  };

  auto copy_stage = [&](int s) {
    if (s < n) {
      uint8_t* buf = slot(s);
      const int t0 = t_lo + s * f::kStageTaps;
      if (!kNo) {
#pragma unroll
        for (int r = 0; r < f::kStageTaps * 16 / f::kThreads; ++r) {
          const int i = tid + r * f::kThreads, t = t0 + i / 16;
          fir::copy16(fir::smem_addr(buf + i * 16),
                      t < t_hi ? wm + (size_t)t * g.R + (i % 16) * 4 : w,
                      t < t_hi ? 16 : 0);
        }
      }
      if (kVar == kNocvt) {
        constexpr int kChunks = f::kLanes / 4;      // 16-byte chunks a row
#pragma unroll
        for (int r = 0; r < f::kStageTaps * kChunks / f::kThreads; ++r) {
          const int i = tid + r * f::kThreads, t = t0 + i / kChunks;
          const int v = v0 + t, lane = lane0 + (i % kChunks) * 4;
          const bool in = t < t_hi && v < g.T && lane < g.B;
          fir::copy16(fir::smem_addr(buf + f::kWBytes + i * 16),
                      in ? xf32 + (size_t)v * g.B + lane : w, in ? 16 : 0);
        }
      } else {
        const int xoff = kNo ? 0 : f::kWBytes;
#pragma unroll
        for (int r = 0; r < f::kStageTaps * f::kLanes / 8 / f::kThreads; ++r) {
          const int i = tid + r * f::kThreads, t = t0 + i / (f::kLanes / 8);
          const uint32_t dst = fir::smem_addr(buf + xoff + i * 16);
          if (t < t_hi)
            fir::copy_x8(g, v0 + t, lane0 + (i % (f::kLanes / 8)) * 8, true,
                         dst, g.x);
          else
            fir::copy16(dst, g.x, 0);
        }
      }
    }
    f::commit();
  };
  auto convert = [&](int s) {
    const int16_t* raw =
        reinterpret_cast<const int16_t*>(slot(s) + (kNo ? 0 : f::kWBytes));
    float* dst = const_cast<float*>(xs_of(s));
#pragma unroll
    for (int r = 0; r < f::kStageTaps * f::kLanes / 4 / f::kThreads; ++r) {
      const int i = tid + r * f::kThreads;
      float v[4];
      f::load4_i16(v, raw + i * 4);
      *reinterpret_cast<float4*>(dst + i * 4) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  };

  float acc[f::kTM][f::kTN];
#pragma unroll
  for (int a = 0; a < f::kTM; ++a)
#pragma unroll
    for (int b = 0; b < f::kTN; ++b) acc[a][b] = 0.0f;
  const int wrow = sb * f::kSubRows + ty * f::kTM;
  const int xlane = lg * f::kWarpLanes + 4 * tx;

  auto multiply = [&](int s) {
    const float* ws = reinterpret_cast<const float*>(slot(s));
    const float* xs = xs_of(s);
    const int st = t_lo + s * f::kStageTaps;
#pragma unroll
    for (int j = 0; j < f::kStageTaps / f::kSlice; ++j) {
      if (!kNo && !(st + j * f::kSlice < sb_hi && st + (j + 1) * f::kSlice > sb_lo))
        continue;
#pragma unroll
      for (int kk = 0; kk < f::kSlice; ++kk) {
        const int t = j * f::kSlice + kk;
        float xr[f::kTN];
#pragma unroll
        for (int c = 0; c < f::kTN / 4; ++c)
          fir::load4(xr + 4 * c, xs + t * f::kLanes + xlane + 64 * c);
        if (kNo) {   // the column sums, one row of the tile
#pragma unroll
          for (int b = 0; b < f::kTN; ++b) acc[0][b] = __fadd_rn(acc[0][b], xr[b]);
          continue;
        }
        float wr[f::kTM];
        fir::load4(wr, ws + t * fir::kRowTile + wrow);
        fir::load4(wr + 4, ws + t * fir::kRowTile + wrow + 4);
#pragma unroll
        for (int a = 0; a < f::kTM; ++a)
#pragma unroll
          for (int b = 0; b < f::kTN; ++b)
            acc[a][b] = __fmaf_rn(wr[a], xr[b], acc[a][b]);
      }
    }
  };

  // fir_tile's ring; nocvt multiplies a stage as soon as it has landed
#pragma unroll
  for (int s = 0; s < f::kLead; ++s) copy_stage(s);
  if (n > 0) {
    if (kVar == kNocvt) {
      f::wait<f::kLead - 1>();
      __syncthreads();
    } else {
      f::wait<f::kLead - 2>();
      __syncthreads();
      convert(0);
      __syncthreads();
    }
  }
#pragma unroll 1
  for (int s = 0; s < n; ++s) {
    copy_stage(s + f::kLead);
    if (kVar != kNocvt && s + 1 < n) convert(s + 1);
    multiply(s);
    if (kVar == kNocvt)
      f::wait<f::kLead - 1>();
    else
      f::wait<f::kLead - 2>();
    __syncthreads();
  }
  if (kNo) {
#pragma unroll
    for (int a = 1; a < f::kTM; ++a)
#pragma unroll
      for (int b = 0; b < f::kTN; ++b) acc[a][b] = acc[0][b];
  }

  // fir_tile's stores: rows wrow .., lanes xlane + 64c, 8 bytes a store
#pragma unroll
  for (int a = 0; a < f::kTM; ++a) {
    const int row = rt * fir::kRowTile + wrow + a;
    int16_t* out = g.y + ((size_t)k * g.R + row) * g.B + lane0;
#pragma unroll
    for (int c = 0; c < f::kTN / 4; ++c) {
      const int lane = xlane + 64 * c;
      if (lane0 + lane >= g.B) continue;
      int16_t q[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) q[b] = fir::word2int(acc[a][4 * c + b]);
      *reinterpret_cast<uint2*>(out + lane) = make_uint2(
          (uint32_t)(uint16_t)q[0] | ((uint32_t)(uint16_t)q[1] << 16),
          (uint32_t)(uint16_t)q[2] | ((uint32_t)(uint16_t)q[3] << 16));
    }
  }
}

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
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
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
