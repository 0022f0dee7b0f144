// The resident fixed walk's witness: the served persistent walk
// (fixed_wgmma.cuh's fir_tiles<4, false, true>, K1e's and K2d's where
// their bands fit) built with a witness that records what each CTA did,
// so tests hold the host's model of the walk (streamed_fir.resident_runs and
// resident_bands, which the counter speex.kernel.fixed.bands reads) against
// the kernel itself.  CTA c writes record[3c .. 3c + 2] = (first, last,
// band loads): the run of band-major items balanced_run gave it and the
// bands it entered and copied into a band buffer.  The witness only
// stores, so the outputs are the served kernel's, bit for bit.
#include "probe_common.cuh"

#include "fixed_wgmma.cuh"

namespace probes {
namespace walk {

using Sh = fir::fixedtc::Shape<4>;

// fir_tiles' witness: thread 0 writes this CTA's three words
struct Record {
  int* at;
  __device__ __forceinline__ void run(int first, int last) const {
    if (threadIdx.x == 0) {
      at[0] = first;
      at[1] = last;
      at[2] = 0;
    }
  }
  __device__ __forceinline__ void band() const {
    if (threadIdx.x == 0) ++at[2];
  }
};

__global__ void __launch_bounds__(fir::kThreads, Sh::kMinBlocks)
fixed_walk_kernel(fir::Launch g, fir::Origin o, int n_kr, int band_cap,
                  const int8_t* __restrict__ planes,
                  const int32_t* __restrict__ bias,
                  const int32_t* __restrict__ coef, int* record) {
  const int lane_tiles = (g.B + fir::int8tc::kLanes - 1) / fir::int8tc::kLanes;
  fir::fixedtc::fir_tiles<4, false, true>(g, o, n_kr, lane_tiles, band_cap,
                                          planes, bias, coef,
                                          Record{record + 3 * blockIdx.x});
}

}  // namespace walk
}  // namespace probes

extern "C" {

// The served fixed launch's arguments at n_accum 4 (streamed_fir.cu's
// streamed_fir_fixed: planes int8[2, P, 4R, K], bias int32[P, 4R], coef
// int32[P, 4, R], taps int32[P, R / 32, 2], slices its widest band's
// K-slices) on the resident walk, over `ctas` CTAs; record int32[ctas, 3].
// Refuses (cudaErrorInvalidValue) a launch the served launcher would not
// walk resident: fewer than kTileLead tiles a band, or two band buffers
// of `slices` past a CTA's shared memory.  Launches on `stream`; returns
// cudaGetLastError() (0 on success).
int probe_fixed_walk(const void* hist, const void* x, void* y,
                     const void* taps, const void* planes, const void* bias,
                     const void* coef, int slices, int H, int T, int B, int R,
                     int K, int P, int n_blocks, int shift, int num, int den,
                     int f0, int ctas, void* record, void* stream) {
  using probes::walk::Sh;
  cudaGetLastError();
  const int lane_tiles = (B + fir::int8tc::kLanes - 1) / fir::int8tc::kLanes;
  if (reinterpret_cast<uintptr_t>(planes) % 16 || K % 32 || R % Sh::kRows ||
      P <= 0 || n_blocks % P || slices < 1 || slices > K / 32 || ctas < 1 ||
      n_blocks / P * lane_tiles < Sh::kTileLead ||
      Sh::resident_smem(slices) > fir::int8tc::kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = Sh::resident_smem(slices);
  cudaError_t err = fir::fixedtc::allow_smem<4>(
      probes::walk::fixed_walk_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  probes::walk::fixed_walk_kernel<<<ctas, fir::kThreads, smem,
                                    static_cast<cudaStream_t>(stream)>>>(
      fir::make_launch(hist, x, y, taps, H, T, B, R, K, P),
      fir::make_origin(shift, num, den, f0), n_blocks * (R / Sh::kRows),
      slices, static_cast<const int8_t*>(planes),
      static_cast<const int32_t*>(bias), static_cast<const int32_t*>(coef),
      static_cast<int*>(record));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
