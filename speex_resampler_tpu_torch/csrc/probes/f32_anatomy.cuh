// The variants of probe P6 (f32_anatomy.cu) as device code: the tiled f32
// block's stage buffers and the tile that runs the nodot and nocvt
// variants (fir::f32::fir_tile with the dots or the int16 -> f32
// conversion taken out).  Shared with batched_dot.cu, whose batched form
// multiplies patches assembled as f32 in device memory: nocvt's tile.
#pragma once

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

}  // namespace f32a
}  // namespace probes
