// Phase-tiled polyphase FIR launch for Hopper (sm_90a), schemes "highest"
// and "int8".
//
// Replaces speex_resampler_tpu/ops/pallas_fir.py resample_conv_tm_pallas_v3
// / _kernel_v3 (the TPU kernel of the batched serving path).  It computes
// the same function: output block k (R rows, all lanes) is
//
//     y_k = epilogue( W[k % P]^T [R, K] @ patch_k [K, B] ),
//     patch_k = rows v0 .. v0+K-1 of the virtual axis hist ++ x,
//     v0      = (k / P) * S + offsets[k % P],
//
// with time-major int16 [rows, B] buffers and lanes minor.  The TPU kernel
// assembled each patch in VMEM from static copy plans over overlapping
// chunk views; here every CTA computes its own origin v0 and reads tap row
// v0+t from hist when v0+t < H, else from x.  Offsets are a device array,
// so one compiled kernel serves every fractional phase f0 a flush rebuilds.
//
// What bounds it on the H100: the multiply-adds.  One flagship launch
// (44.1k->48k q7, B = 2048) reads ~38 MB of real int16 rows and writes
// 42 MB, ~25 us at 3.35 TB/s, but does 5.5 G multiply-adds per weight
// pass: ~165 us at the 33.5 T FMA/s of the CUDA cores in f32, and three
// int32 passes (D = 3 digit planes) at half that rate under "int8".
// The design therefore aims at the arithmetic, simply:
//   * each CTA owns a 64-row x 128-lane output tile and walks only the tap
//     rows where its 64 weight columns are nonzero (taps[m][row tile]; a
//     block's R outputs start ~R*num/den rows apart, so one row tile
//     needs filt_len + 64*num/den of the K taps, ~70% at the flagship);
//   * weights and patch rows are staged through shared memory 16 taps at
//     a time (a whole f32 [R, K] block is 135 KB at the flagship and more
//     where R widens to 256, so no block is assumed to fit), and each
//     thread keeps an 8-row x 4-lane register tile: 32 multiply-adds per
//     three 16-byte shared loads, the weight loads broadcast across a warp;
//   * lanes are masked in the kernel, so any B works without padding.
// Tensor-core int8 MMA (wgmma / mma.sync), TMA staging and dp4a are left
// for later work: this is the simple, exact first kernel.
//
// Epilogues match the TPU kernel exactly:
//   highest: y = sum_t W[t,r] * float(x), f32 (FMA, no TF32), then WORD2INT
//            floor(0.5 + y) with the -32767.5 / 32766.5 clamps.
//   int8:    for digit d = 0..D-1 in order, I_d = sum_t w_d[t,r] * (x - 128)
//            exactly in int32 (equal to 256*<w_d,xh> + <w_d,xl>, since
//            x = 256*xh + xl + 128), acc += float(I_d) * scales[d]; then
//            acc + bias[m,r] and WORD2INT.  The f32 steps use __fmul_rn /
//            __fadd_rn so nvcc cannot contract them into an FMA: the int8
//            certificate (ops/int8_planes.py) assumes separately rounded
//            steps, and it keeps the kernel bit-identical to its plain
//            version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowTile = 64;    // output rows of one block per CTA
constexpr int kLaneTile = 128;  // lanes per CTA
constexpr int kTapStage = 16;   // tap rows staged in shared memory per step
constexpr int kThreads = 256;   // warp w: rows 8w..8w+7; its thread l: lanes 4l..4l+3

struct Launch {
  const int16_t* hist;     // [H, B]
  const int16_t* x;        // [T, B]
  int16_t* y;              // [n_blocks * R, B]
  const int32_t* offsets;  // [P] patch origin of each block phase
  const int32_t* taps;     // [P, R / kRowTile, 2] nonzero tap rows [lo, hi)
  int H, T, B, R, K, P, S;
};

// Row v of the virtual axis hist ++ x; rows past the chunk read as zero.
__device__ __forceinline__ int read_virtual(const Launch& g, int v, int lane) {
  if (v < g.H) return g.hist[(size_t)v * g.B + lane];
  v -= g.H;
  return v < g.T ? g.x[(size_t)v * g.B + lane] : 0;
}

// WORD2INT (arch.h:208-209): round half up, saturate to int16.
__device__ __forceinline__ int16_t word2int(float v) {
  float r = floorf(__fadd_rn(0.5f, v));
  if (v < -32767.5f) r = -32768.0f;
  if (v > 32766.5f) r = 32767.0f;
  return (int16_t)__float2int_rz(r);
}

struct Tile {
  int k, rt, m, v0, lane0, t_lo, t_hi, warp, tl;
  __device__ Tile(const Launch& g) {
    const int row_tiles = g.R / kRowTile;
    k = blockIdx.x / row_tiles;
    rt = blockIdx.x % row_tiles;
    m = k % g.P;
    v0 = (k / g.P) * g.S + g.offsets[m];
    lane0 = blockIdx.y * kLaneTile;
    t_lo = g.taps[(m * row_tiles + rt) * 2];
    t_hi = g.taps[(m * row_tiles + rt) * 2 + 1];
    warp = threadIdx.x / 32;
    tl = threadIdx.x % 32;
  }
  __device__ int row(int a) const {  // block-local output row
    return rt * kRowTile + warp * 8 + a;
  }
};

// Stage tap rows t0 .. t0+kTapStage-1 of the patch (as `shift + x`) and of
// the weight columns [rt*kRowTile, +kRowTile); rows at or past t_hi and
// lanes past B stage as zero.
template <typename Acc, typename WT>
__device__ __forceinline__ void stage(const Launch& g, const Tile& c,
                                      const WT* __restrict__ wm, int t0,
                                      int shift, Acc (*xs)[kLaneTile],
                                      Acc (*ws)[kRowTile]) {
  for (int i = threadIdx.x; i < kTapStage * kLaneTile; i += kThreads) {
    const int t = t0 + i / kLaneTile, lane = c.lane0 + i % kLaneTile;
    xs[i / kLaneTile][i % kLaneTile] =
        (t < c.t_hi && lane < g.B) ? (Acc)(read_virtual(g, c.v0 + t, lane) + shift)
                                   : (Acc)0;
  }
  for (int i = threadIdx.x; i < kTapStage * kRowTile; i += kThreads) {
    const int t = t0 + i / kRowTile;
    ws[i / kRowTile][i % kRowTile] =
        t < c.t_hi ? (Acc)wm[(size_t)t * g.R + i % kRowTile] : (Acc)0;
  }
}

template <typename Acc> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<int> { using type = int4; };

// One 16-byte shared-memory load of four consecutive values.
template <typename Acc>
__device__ __forceinline__ void load4(Acc* dst, const Acc* src) {
  const typename Vec4<Acc>::type v =
      *reinterpret_cast<const typename Vec4<Acc>::type*>(src);
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}

// acc[a][b] += sum over the staged taps of ws[.][8*warp + a] * xs[.][4*tl + b]
template <typename Acc>
__device__ __forceinline__ void multiply_stage(const Tile& c,
                                               Acc (*xs)[kLaneTile],
                                               Acc (*ws)[kRowTile],
                                               Acc (&acc)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < kTapStage; ++kk) {
    Acc xr[4], wr[8];
    load4(xr, &xs[kk][c.tl * 4]);
    load4(wr, &ws[kk][c.warp * 8]);
    load4(wr + 4, &ws[kk][c.warp * 8 + 4]);
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] += wr[a] * xr[b];
  }
}

__device__ __forceinline__ void store(const Launch& g, const Tile& c, int a,
                                      const float (&v)[4]) {
  int16_t* out = g.y + ((size_t)c.k * g.R + c.row(a)) * g.B;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int lane = c.lane0 + c.tl * 4 + b;
    if (lane < g.B) out[lane] = word2int(v[b]);
  }
}

__global__ void __launch_bounds__(kThreads)
tiled_fir_f32_kernel(Launch g, const float* __restrict__ w) {
  __shared__ __align__(16) float xs[kTapStage][kLaneTile];
  __shared__ __align__(16) float ws[kTapStage][kRowTile];
  const Tile c(g);
  const float* wm = w + (size_t)c.m * g.K * g.R + c.rt * kRowTile;
  float acc[8][4] = {};
  for (int t0 = c.t_lo; t0 < c.t_hi; t0 += kTapStage) {
    stage(g, c, wm, t0, 0, xs, ws);
    __syncthreads();
    multiply_stage(c, xs, ws, acc);  // f32 multiply-add, contracted to FMA
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < 8; ++a) store(g, c, a, acc[a]);
}

__global__ void __launch_bounds__(kThreads)
tiled_fir_int8_kernel(Launch g, const int8_t* __restrict__ planes,
                      const float* __restrict__ bias, int D, float4 scales) {
  __shared__ __align__(16) int xs[kTapStage][kLaneTile];
  __shared__ __align__(16) int ws[kTapStage][kRowTile];
  const Tile c(g);
  const float scale[4] = {scales.x, scales.y, scales.z, scales.w};
  float acc[8][4] = {};
  for (int d = 0; d < D; ++d) {
    const int8_t* wm =
        planes + ((size_t)d * g.P + c.m) * g.K * g.R + c.rt * kRowTile;
    int iacc[8][4] = {};
    for (int t0 = c.t_lo; t0 < c.t_hi; t0 += kTapStage) {
      stage(g, c, wm, t0, -128, xs, ws);
      __syncthreads();
      multiply_stage(c, xs, ws, iacc);  // exact int32 multiply-add
      __syncthreads();
    }
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        acc[a][b] = __fadd_rn(acc[a][b],
                              __fmul_rn(__int2float_rn(iacc[a][b]), scale[d]));
  }
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const float bias_r = bias[c.m * g.R + c.row(a)];
    float v[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) v[b] = __fadd_rn(acc[a][b], bias_r);
    store(g, c, a, v);
  }
}

Launch make_launch(const void* hist, const void* x, void* y,
                   const void* offsets, const void* taps, int H, int T, int B,
                   int R, int K, int P, int S) {
  return Launch{static_cast<const int16_t*>(hist), static_cast<const int16_t*>(x),
                static_cast<int16_t*>(y), static_cast<const int32_t*>(offsets),
                static_cast<const int32_t*>(taps), H, T, B, R, K, P, S};
}

dim3 grid_of(int n_blocks, int R, int B) {
  return dim3(n_blocks * (R / kRowTile), (B + kLaneTile - 1) / kLaneTile);
}

}  // namespace

extern "C" {

// Tile sizes the host wrapper must honour (R % row_tile == 0; taps table).
int tiled_fir_row_tile() { return kRowTile; }

const char* tiled_fir_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Each entry point launches on `stream`, does not synchronise, and returns
// cudaGetLastError() of the launch (0 on success).
int tiled_fir_f32(const void* hist, const void* x, void* y, const void* offsets,
                  const void* taps, const void* w, int H, int T, int B, int R,
                  int K, int P, int S, int n_blocks, void* stream) {
  cudaGetLastError();
  Launch g = make_launch(hist, x, y, offsets, taps, H, T, B, R, K, P, S);
  tiled_fir_f32_kernel<<<grid_of(n_blocks, R, B), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      g, static_cast<const float*>(w));
  return static_cast<int>(cudaGetLastError());
}

int tiled_fir_int8(const void* hist, const void* x, void* y,
                   const void* offsets, const void* taps, const void* planes,
                   const void* bias, int D, float s0, float s1, float s2,
                   float s3, int H, int T, int B, int R, int K, int P, int S,
                   int n_blocks, void* stream) {
  cudaGetLastError();
  Launch g = make_launch(hist, x, y, offsets, taps, H, T, B, R, K, P, S);
  tiled_fir_int8_kernel<<<grid_of(n_blocks, R, B), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      g, static_cast<const int8_t*>(planes), static_cast<const float*>(bias),
      D, make_float4(s0, s1, s2, s3));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
