// Probe P11 on Hopper: the f32 launch with its history, phase by phase
// against one batched product.  It replaces the Pallas kernel of
// experiments/batched_dot.py (make :45, its pallas_call :102): with the
// phase-tiled weights W [P, K, R] of 44.1 kHz -> 48 kHz q7 shifted for a
// 128-row history (origin_shift H - (filt_len - 1); P 20, R 128, K 264, S
// 2352), 4 periods (80 blocks), hist int16 [H, B] and x int16 [T, B],
// output block (period j, phase m) is
//
//   y = WORD2INT(W_m . float(patch)),  f32 (HIGHEST)
//
// of the K-row patch of the virtual axis hist ++ x at j * S + offsets[m]
// (the TPU kernel assembled it from the history and V views of S rows).
// The two forms:
//
// - m-loop (the TPU program's order): a CTA owns one (period j, 64-row
//   tile, `lanes` lanes) and walks the P phases in order, each phase one
//   call of the served highest body, fir::f32::fir_tile (K1a's: a ring of
//   16-tap stages copied from hist ++ x by cp.async, x converted to f32
//   once a stage, an 8 x 8 register tile a thread, each warp only the
//   8-tap slices of its 16 rows' nonzero band).  `lanes` is the TPU
//   probe's lane tile: 128 (its default, fir_tile's own CTA) or 64.
// - batched: every phase's patch assembled before any product.  On the TPU
//   one program assembled its period's [P, K, lb] f32 patches in VMEM
//   (2.70 MB at lb 128) and ran one batched dot_general.  A CTA here holds
//   at most 227 KB, so the patches of one period fit only at 8 lanes a CTA
//   ([20, 264, 8] f32, 169 KB), and then every CTA would read all 2.7 MB
//   of W from L2 for 8 lanes (2.7 GB a launch).  So the patches go to
//   device memory instead: a pre-pass writes all of them, f32 [n_blocks,
//   K, B] (173 MB at B = 2048), and one batched product over (block, 64-row
//   tile, 128 lanes) multiplies them: P6's nocvt tile (f32_anatomy.cuh,
//   fir_tile fed f32 rows, no conversion stage), each block reading its own
//   patch from row 0.  This is torch.bmm's form, [P, R, K] x [P, K, lanes].
//
// Every output is one __fmaf_rn chain in tap order in both forms (and in
// K1a), so they agree bit for bit.  What bounds it: 2.68 G needed
// multiply-adds at the CUDA cores' 67 TFLOP/s (0.080 ms); the batched
// form adds the patches' round trip, 173 MB written and read (0.10 ms at
// 3.35 TB/s).
#include "f32_anatomy.cuh"

namespace probes {
namespace bdot {

namespace f = fir::f32;

constexpr int kMloop = 0, kBatched = 1;

// fir_tile's CTA at the m-loop's lane tiles: 128 threads either way
static_assert(f::threads_for(128, 8) == f::kThreads &&
                  f::threads_for(64, 4) == f::kThreads,
              "the m-loop's CTAs are fir_tile's 128 threads");

// The m-loop's CTA: period j, row tile rt, lane tile lt of kL lanes
// (blockIdx.x = (j * row_tiles + rt) * lane_tiles + lt), the P phases in
// order.
template <int kL>
__global__ void __launch_bounds__(f::kThreads, f::kMinBlocks)
    batched_mloop_kernel(fir::Launch g, const int32_t* __restrict__ offsets,
                         int S, const float* __restrict__ w) {
  constexpr int kTN = kL / 16;      // a thread's lanes: 8 at 128, 4 at 64
  const int lane_tiles = (g.B + kL - 1) / kL, row_tiles = g.R / fir::kRowTile;
  const int lt = blockIdx.x % lane_tiles;
  const int rt = blockIdx.x / lane_tiles % row_tiles;
  const int j = blockIdx.x / (lane_tiles * row_tiles);
#pragma unroll 1
  for (int m = 0; m < g.P; ++m)
    f::fir_tile<kL, kTN>(g, j * g.P + m, rt, lt * kL, j * S + offsets[m],
                         g.R, w);
}

// The pre-pass: patch k's rows t < K, f32 [n_blocks, K, B], from row (k /
// P) * S + offsets[k % P] + t of hist ++ x (zero past it): 8 lanes a
// thread and step (B % 8 == 0, rows 16-byte aligned).
__global__ void batched_patch_kernel(fir::Launch g,
                                     const int32_t* __restrict__ offsets,
                                     int S, int n_blocks,
                                     float* __restrict__ patches) {
  const long long per_block = (long long)g.K * (g.B / 8);
  const long long n = n_blocks * per_block;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    const int k = (int)(e / per_block);
    const int t = (int)(e % per_block / (g.B / 8));
    const int lane = (int)(e % (g.B / 8)) * 8;
    const int v = (k / g.P) * S + offsets[k % g.P] + t;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (v < g.H)
      u = *reinterpret_cast<const uint4*>(g.hist + (size_t)v * g.B + lane);
    else if (v - g.H < g.T)
      u = *reinterpret_cast<const uint4*>(g.x + (size_t)(v - g.H) * g.B + lane);
    auto lo = [](uint32_t b) { return (float)(int16_t)(b & 0xFFFF); };
    auto hi = [](uint32_t b) { return (float)(int16_t)(b >> 16); };
    float4* dst = reinterpret_cast<float4*>(
        patches + ((size_t)k * g.K + t) * g.B + lane);
    dst[0] = make_float4(lo(u.x), hi(u.x), lo(u.y), hi(u.y));
    dst[1] = make_float4(lo(u.z), hi(u.z), lo(u.w), hi(u.w));
  }
}

// The batched product: block k, row tile, 128 lanes of patch k (its own T
// = K rows from row 0); grid (n_blocks * R / 64, ceil(B / 128)).
__global__ void __launch_bounds__(f::kThreads, f::kMinBlocks)
    batched_product_kernel(fir::Launch g, const float* __restrict__ w,
                           const float* __restrict__ patches) {
  const int row_tiles = g.R / fir::kRowTile;
  const int k = blockIdx.x / row_tiles;
  f32a::tile<f32a::kNocvt>(g, k, blockIdx.x % row_tiles,
                           blockIdx.y * f::kLanes, 0, w,
                           patches + (size_t)k * g.K * g.B);
}

// Dynamic shared memory, once a device (a graph captured after a first
// launch holds no attribute call).
template <typename Kernel>
cudaError_t allow(std::atomic<unsigned>& done, Kernel* kernel, int smem) {
  return fir::set_once(done, [&] {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    return e;
  });
}

cudaError_t patches(const fir::Launch& g, const int32_t* offsets, int S,
                    int n_blocks, float* out, cudaStream_t stream) {
  const long long n = (long long)n_blocks * g.K * (g.B / 8);
  const int blocks = (int)((n + 255) / 256 < 8192 ? (n + 255) / 256 : 8192);
  batched_patch_kernel<<<blocks, 256, 0, stream>>>(g, offsets, S, n_blocks,
                                                   out);
  return cudaGetLastError();
}

template <int kL>
cudaError_t mloop(const fir::Launch& g, const int32_t* offsets, int S,
                  int n_blocks, const float* w, cudaStream_t stream) {
  static std::atomic<unsigned> done{0};
  const int smem = f::smem_bytes(kL);
  cudaError_t err = allow(done, batched_mloop_kernel<kL>, smem);
  if (err != cudaSuccess) return err;
  const int ctas = n_blocks / g.P * (g.R / fir::kRowTile) *
                   ((g.B + kL - 1) / kL);
  batched_mloop_kernel<kL><<<ctas, f::kThreads, smem, stream>>>(g, offsets, S,
                                                                 w);
  return cudaGetLastError();
}

}  // namespace bdot
}  // namespace probes

extern "C" {

// The pre-pass alone: patches f32 [n_blocks, K, B] from hist int16 [H, B]
// ++ x int16 [T, B]; offsets int32 [P]; B % 8 == 0, hist, x and patches
// 16-byte aligned.  Launches on `stream`; returns cudaGetLastError() (0 on
// success).
int probe_batched_patches(const void* hist, const void* x, void* patches,
                          const void* offsets, int H, int T, int B, int K,
                          int P, int S, int n_blocks, void* stream) {
  cudaGetLastError();
  if ((reinterpret_cast<uintptr_t>(hist) | reinterpret_cast<uintptr_t>(x) |
       reinterpret_cast<uintptr_t>(patches)) % 16 ||
      B % 8 || B <= 0 || K <= 0 || P <= 0 || n_blocks % P ||
      patches == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const fir::Launch g =
      fir::make_launch(hist, x, nullptr, nullptr, H, T, B, 0, K, P);
  return static_cast<int>(probes::bdot::patches(
      g, static_cast<const int32_t*>(offsets), S, n_blocks,
      static_cast<float*>(patches), static_cast<cudaStream_t>(stream)));
}

// form 0 m-loop (lanes 128 or 64 a CTA), 1 batched (the pre-pass into
// patches f32 [n_blocks, K, B], then the product; lanes unused).  hist
// int16 [H, B], x int16 [T, B], y int16 [n_blocks * R, B]; w f32 [P, K, R];
// taps int32 [P, R / 16, 2] (each 16-row sub-band's nonzero taps); offsets
// int32 [P]; B % 8 == 0, R % 64 == 0, hist, x, y, w and patches 16-byte
// aligned.  Launches on `stream`; returns cudaGetLastError() (0 on
// success).
int probe_batched_dot(const void* hist, const void* x, void* y,
                      const void* offsets, const void* taps, const void* w,
                      void* patches, int form, int lanes, int H, int T, int B,
                      int R, int K, int P, int S, int n_blocks, void* stream) {
  using namespace probes::bdot;
  cudaGetLastError();
  if ((reinterpret_cast<uintptr_t>(hist) | reinterpret_cast<uintptr_t>(x) |
       reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(patches)) % 16 ||
      B % 8 || B <= 0 || R % fir::kRowTile || P <= 0 || n_blocks % P ||
      (form == kMloop && lanes != 128 && lanes != 64) ||
      (form == kBatched && patches == nullptr) ||
      (form != kMloop && form != kBatched))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* off = static_cast<const int32_t*>(offsets);
  const auto* wf = static_cast<const float*>(w);
  const fir::Launch g = fir::make_launch(hist, x, y, taps, H, T, B, R, K, P);
  cudaError_t err;
  if (form == kMloop) {
    err = lanes == 128 ? mloop<128>(g, off, S, n_blocks, wf, st)
                       : mloop<64>(g, off, S, n_blocks, wf, st);
    return static_cast<int>(err);
  }
  auto* pf = static_cast<float*>(patches);
  err = probes::bdot::patches(g, off, S, n_blocks, pf, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  static std::atomic<unsigned> done{0};
  const int smem = probes::f32a::smem_bytes<probes::f32a::kNocvt>();
  err = allow(done, batched_product_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the product reads patch k as its own x [K, B] from row 0, no history
  const fir::Launch gp =
      fir::make_launch(nullptr, nullptr, y, taps, 0, K, B, R, K, P);
  const dim3 grid(n_blocks * (R / fir::kRowTile),
                  (B + f::kLanes - 1) / f::kLanes);
  batched_product_kernel<<<grid, f::kThreads, smem, st>>>(gp, wf, pf);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
