// Phase-tiled polyphase FIR launch for Hopper (sm_90a), schemes "highest",
// "int8", "fixed" (n_accum 1 and 4) and "split5".
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
// 42 MB, ~25 us at 3.35 TB/s, but needs 2.7 G multiply-adds (filt_len 128
// per output; 5.5 G over the dense K = 264): ~80 us at the 33.5 T FMA/s of
// the CUDA cores in f32, and three int32 passes (D = 3 digit planes) at
// half that rate under "int8".
// The design (fir_common.cuh) therefore aims at the arithmetic, simply: a
// CTA per 64-row x 128-lane output tile walks only the nonzero tap band of
// its weight columns (a block's R outputs start ~R*num/den rows apart, so
// one row tile needs filt_len + 64*num/den of the K taps, ~70% at the
// flagship), staging 16 taps at a time through shared memory (a whole f32
// [R, K] block is 135 KB at the flagship and more where R widens to 256,
// so no block is assumed to fit).  The grid runs over (block, row tile)
// fastest: the whole weight cycle is 2.7 MB and stays in L2.  Tensor-core
// int8 MMA (wgmma / mma.sync), TMA staging and dp4a are left for later
// work: this is the simple, exact first kernel.
//
// Scheme "highest" (K1a) has its own product, shared with the streamed
// kernel (f32_fir.cuh): a 3-stage cp.async ring of 16-tap stages, x
// converted to f32 once a stage, an 8 x 8 register tile a thread, and each
// warp multiplying only the 8-tap slices that meet its 16 rows' nonzero
// band (a table of 16-row sub-bands), every output still one FMA chain in
// tap order.  Its lane tile is f32::kLanes.
//
// Scheme "fixed" (the Q15 universe; K1's fixed branch, _kernel_v3 with
// _dot_fixed and the fixed_math epilogues; K1e at n_accum 4, K1d at 1)
// runs on the int8 tensor cores (fixed_wgmma.cuh, shared with the streamed
// kernel): _dot_fixed's four int8 dots and bias, all n_accum weight column
// sets (C = 4R = 512 at 44.1k->48k q7) in one walk of the band, x split
// once per K-slice.  Its planes are K-major, int8[2, P, C, K_pad] (wh,
// wl0; K padded to a multiple of 32, each 32-tap group permuted: JAX's
// tiled planes are [2, P, C, K]); its CTA takes fixedtc::Shape's rows and
// int8tc::kLanes lanes, and its tap table those rows.  Its flagship launch
// needs 10.7 G int16 multiply-adds (filt_len x 4 per output): 86 G int8
// tensor-core operations (4 int8 products, 8 ops, per int16 MAC), ~43 us,
// above the ~25 us of its bytes, so operations bound it; the CUDA cores'
// IMAD would take >= 0.86 ms for the 14.4 G the 64-row tiles walk.
//
// Scheme "split5" (K1c; _kernel_v3 with _dot_scheme "split5": five bf16
// products per multiply-add, summed in f32) is what "auto" resolves where
// the int8 certificate fails, e.g. 96 kHz -> 8 kHz q10 (filt_len 3072,
// K 4600, P 1).  One launch at B = 2048 needs 16.1 G multiply-adds: 161 G
// bf16 tensor-core FLOP at 5 products each, ~0.16 ms, above the ~0.045 ms
// of its ~151 MB, so operations bound it, and only the tensor cores come
// near: the CUDA cores' f32 FMA would take 2.4 ms for the five passes.
// So it runs on them (split5_wgmma.cuh): wgmma m64n64k16 with x_hi / x_lo
// as the register operand, five f32 accumulators over one walk of the
// band (3840 taps a tile), the weights and x rows copied three stages
// ahead, and each K-slice's x split while the previous slice's wgmmas run.

#include "f32_fir.cuh"
#include "fir_common.cuh"
#include "fixed_wgmma.cuh"
#include "split5_wgmma.cuh"

namespace {

using fir::kRowTile;
using fir::kLaneTile;
using fir::kThreads;

// Block k and row tile of this CTA, and its patch origin.
__device__ __forceinline__ fir::Tile tiled_tile(const fir::Launch& g,
                                                const int32_t* offsets,
                                                int S) {
  const int row_tiles = g.R / kRowTile;
  const int k = blockIdx.x / row_tiles;
  return fir::Tile(g, k, blockIdx.x % row_tiles, blockIdx.y,
                   (k / g.P) * S + offsets[k % g.P]);
}

// grid (n_blocks * R / kRowTile, ceil(B / f32::kLanes))
__global__ void __launch_bounds__(fir::f32::kThreads, fir::f32::kMinBlocks)
tiled_fir_f32_kernel(fir::Launch g, const int32_t* __restrict__ offsets,
                     int S, const float* __restrict__ w) {
  const int row_tiles = g.R / kRowTile;
  const int k = blockIdx.x / row_tiles;
  fir::f32::fir_tile(g, k, blockIdx.x % row_tiles,
                     blockIdx.y * fir::f32::kLanes,
                     (k / g.P) * S + offsets[k % g.P], g.R, w);
}

__global__ void __launch_bounds__(kThreads)
tiled_fir_int8_kernel(fir::Launch g, const int32_t* __restrict__ offsets,
                      int S, const int8_t* __restrict__ planes,
                      const float* __restrict__ bias, int D, float4 scales) {
  fir::fir_tile_int8(g, tiled_tile(g, offsets, S), planes, bias, D, scales);
}

// grid (n_blocks * R / Shape<kAccum>::kRows, ceil(B / int8tc::kLanes))
template <int kAccum>
__global__ void __launch_bounds__(kThreads,
                                  fir::fixedtc::Shape<kAccum>::kMinBlocks)
tiled_fir_fixed_kernel(fir::Launch g, const int32_t* __restrict__ offsets,
                       int S, const int8_t* __restrict__ planes,
                       const int32_t* __restrict__ bias,
                       const int32_t* __restrict__ coef) {
  constexpr int kRows = fir::fixedtc::Shape<kAccum>::kRows;
  const int row_tiles = g.R / kRows;
  const int k = blockIdx.x / row_tiles;
  fir::fixedtc::fir_tile<kAccum>(
      g,
      fir::Tile(g, k, blockIdx.x % row_tiles, blockIdx.y,
                (k / g.P) * S + offsets[k % g.P], fir::int8tc::kLanes, kRows),
      planes, bias, coef);
}

// Launches the n_accum kAccum fixed kernel (its shared memory set once a
// device).
template <int kAccum>
cudaError_t launch_fixed(const fir::Launch& g, const int32_t* offsets, int S,
                         const int8_t* planes, const int32_t* bias,
                         const int32_t* coef, int n_blocks,
                         cudaStream_t stream) {
  using Shape = fir::fixedtc::Shape<kAccum>;
  static std::atomic<unsigned> smem_set{0};
  const cudaError_t attr = fir::set_once(smem_set, [] {
    return fir::fixedtc::allow_smem<kAccum>(tiled_fir_fixed_kernel<kAccum>);
  });
  if (attr != cudaSuccess) return attr;
  const dim3 grid(n_blocks * (g.R / Shape::kRows),
                  (g.B + fir::int8tc::kLanes - 1) / fir::int8tc::kLanes);
  tiled_fir_fixed_kernel<kAccum><<<grid, kThreads, Shape::kSmemBytes,
                                   stream>>>(g, offsets, S, planes, bias,
                                             coef);
  return cudaGetLastError();
}

__global__ void __launch_bounds__(kThreads, 1)
tiled_fir_split5_kernel(fir::Launch g, const int32_t* __restrict__ offsets,
                        int S, const __nv_bfloat16* __restrict__ planes) {
  fir::split5::fir_tile(g, tiled_tile(g, offsets, S), planes);
}

dim3 grid_of(int n_blocks, int R, int B) {
  return dim3(n_blocks * (R / kRowTile), (B + kLaneTile - 1) / kLaneTile);
}

}  // namespace

extern "C" {

// Tile sizes the host wrapper must honour (R % row_tile == 0; taps table;
// the "highest" table's sub-bands of sub_rows rows; the fixed tables' rows
// at n_accum 1 and 4).
int tiled_fir_row_tile() { return kRowTile; }
int f32_fir_sub_rows() { return fir::f32::kSubRows; }
int fixed_fir_rows(int n_accum) {
  return n_accum == 4 ? fir::fixedtc::Shape<4>::kRows
                      : fir::fixedtc::Shape<1>::kRows;
}

const char* tiled_fir_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Each entry point launches on `stream`, does not synchronise, and returns
// cudaGetLastError() of the launch (0 on success).
// taps int32[P, R / sub_rows, 2] (each 16-row sub-band's nonzero taps);
// w f32[P, K, R], 16-byte aligned.
int tiled_fir_f32(const void* hist, const void* x, void* y, const void* offsets,
                  const void* taps, const void* w, int H, int T, int B, int R,
                  int K, int P, int S, int n_blocks, void* stream) {
  cudaGetLastError();
  if (reinterpret_cast<uintptr_t>(w) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  static std::atomic<unsigned> smem_set{0};
  const cudaError_t attr = fir::set_once(smem_set, [] {
    return fir::f32::allow_smem(tiled_fir_f32_kernel);
  });
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const fir::Launch g = fir::make_launch(hist, x, y, taps, H, T, B, R, K, P);
  const dim3 grid(n_blocks * (R / kRowTile),
                  (B + fir::f32::kLanes - 1) / fir::f32::kLanes);
  tiled_fir_f32_kernel<<<grid, fir::f32::kThreads, fir::f32::kSmemBytes,
                         static_cast<cudaStream_t>(stream)>>>(
      g, static_cast<const int32_t*>(offsets), S, static_cast<const float*>(w));
  return static_cast<int>(cudaGetLastError());
}

// planes bf16[3, P, K, R] (hi, mid, lo), 16-byte aligned.
int tiled_fir_split5(const void* hist, const void* x, void* y,
                     const void* offsets, const void* taps, const void* planes,
                     int H, int T, int B, int R, int K, int P, int S,
                     int n_blocks, void* stream) {
  cudaGetLastError();
  if (reinterpret_cast<uintptr_t>(planes) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  static std::atomic<unsigned> smem_set{0};
  const cudaError_t attr = fir::set_once(smem_set, [] {
    return fir::split5::allow_smem(tiled_fir_split5_kernel);
  });
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const fir::Launch g = fir::make_launch(hist, x, y, taps, H, T, B, R, K, P);
  tiled_fir_split5_kernel<<<grid_of(n_blocks, R, B), kThreads,
                            fir::split5::kSmemBytes,
                            static_cast<cudaStream_t>(stream)>>>(
      g, static_cast<const int32_t*>(offsets), S,
      static_cast<const __nv_bfloat16*>(planes));
  return static_cast<int>(cudaGetLastError());
}

int tiled_fir_int8(const void* hist, const void* x, void* y,
                   const void* offsets, const void* taps, const void* planes,
                   const void* bias, int D, float s0, float s1, float s2,
                   float s3, int H, int T, int B, int R, int K, int P, int S,
                   int n_blocks, void* stream) {
  cudaGetLastError();
  const fir::Launch g = fir::make_launch(hist, x, y, taps, H, T, B, R, K, P);
  tiled_fir_int8_kernel<<<grid_of(n_blocks, R, B), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      g, static_cast<const int32_t*>(offsets), S,
      static_cast<const int8_t*>(planes), static_cast<const float*>(bias), D,
      make_float4(s0, s1, s2, s3));
  return static_cast<int>(cudaGetLastError());
}

// planes int8[2, P, n_accum * R, K] (K % 32 == 0, each 32-tap group
// permuted: fixed_wgmma.cuh), 16-byte aligned; bias int32[P, n_accum * R];
// coef int32[P, 4, R] (NULL for n_accum 1); taps int32[P, R / rows, 2]
// (rows: fixed_fir_rows).
int tiled_fir_fixed(const void* hist, const void* x, void* y,
                    const void* offsets, const void* taps, const void* planes,
                    const void* bias, const void* coef, int n_accum, int H,
                    int T, int B, int R, int K, int P, int S, int n_blocks,
                    void* stream) {
  cudaGetLastError();
  if (reinterpret_cast<uintptr_t>(planes) % 16 || K % 32)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const fir::Launch g = fir::make_launch(hist, x, y, taps, H, T, B, R, K, P);
  const auto* off = static_cast<const int32_t*>(offsets);
  const auto* p8 = static_cast<const int8_t*>(planes);
  const auto* b32 = static_cast<const int32_t*>(bias);
  const auto* c32 = static_cast<const int32_t*>(coef);
  const auto st = static_cast<cudaStream_t>(stream);
  if (n_accum == 4)
    return static_cast<int>(
        launch_fixed<4>(g, off, S, p8, b32, c32, n_blocks, st));
  if (n_accum == 1)
    return static_cast<int>(
        launch_fixed<1>(g, off, S, p8, b32, c32, n_blocks, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
