// Device code shared by the polyphase FIR kernels (streamed_fir.cu,
// tiled_fir.cu, dense_fir.cu): the launch, its closed-form origins and CTA
// tile, the cp.async helpers and the epilogues' arithmetic.  Each kernel
// computes only where its output block's patch starts on the virtual axis
// hist ++ x; from there on its scheme's header does the rest, the same for
// every geometry, so the kernels give the same sums in the same order.
// Each scheme has its own product and staging: "highest" (f32_fir.cuh,
// CUDA cores, every output one FMA chain in tap order; the streamed and
// dense kernels), "split5" (split5_wgmma.cuh, bf16 tensor cores), "int8"
// (int8_wgmma.cuh, int8 tensor cores; the streamed kernel streams the
// digit planes with x, the tiled one keeps a row tile's planes in shared
// memory across the output tiles that share them) and "fixed"
// (fixed_wgmma.cuh, int8 tensor cores; streamed and dense).  The gather
// kernels (gather_fir.cu) take only the epilogues from here.  A CTA owns
// output rows of one block k (R rows, phase m = k % P) and walks only the
// tap rows where its weight columns are nonzero (taps[m][row tile]).
// Lanes are masked, so any B works without padding (the phase-tiled
// kernels' R is a multiple of kRowTile).
//
// Epilogues match the TPU kernels exactly:
//   highest: y = sum_t W[t,r] * float(x), f32 (FMA, no TF32), then WORD2INT
//            floor(0.5 + y) with the -32767.5 / 32766.5 clamps.
//   int8:    for digit d = 0..D-1 in order, I_d = sum_t w_d[t,r] * (x - 128)
//            exactly in int32 (equal to 256*<w_d,xh> + <w_d,xl>, since
//            x = 256*xh + xl + 128), acc += float(I_d) * scales[d]; then
//            acc + bias[m,r] and WORD2INT.  The f32 steps use __fmul_rn /
//            __fadd_rn so nvcc cannot contract them into an FMA: the int8
//            certificate (ops/int8_planes.py) assumes separately rounded
//            steps, and it keeps the kernels bit-identical to their plain
//            versions.
//   fixed:   the Q15 universe (FIXED_POINT build), bit-exact.  For each of
//            the n_accum weight column sets c (accumulator-major, column
//            c*R + r), acc_c = sum_t W16[t, c*R+r] * x exactly mod 2^32 in
//            uint32 (unsigned arithmetic wraps by definition; signed
//            overflow is undefined in C++).  n_accum 1 (direct):
//            y = SAT32PSHR15(acc_0).  n_accum 4 (interpolated):
//            s = sum_c MULT16_32_Q15(coef[m][c][r], acc_c >> 1) mod 2^32,
//            y = SAT32PSHR15(s) (fixed_generic.h, resample.c:474-479).
//            The dot is _dot_fixed's four int8 dots plus a bias, on the
//            int8 tensor cores (fixed_wgmma.cuh, with this file's Tile and
//            the two Q15 macros below).
//   split5:  _dot_scheme's five bf16 dots, in its order: d_1..d_5 =
//            <w_hi,x_hi>, <w_hi,x_lo>, <w_mid,x_hi>, <w_mid,x_lo>,
//            <w_lo,x_hi> (x_hi = bf16(x), rounded to nearest even, x_lo =
//            x - x_hi; both exact), each its own f32 sum of exact products,
//            then y = ((((d_1 + d_2) + d_3) + d_4) + d_5) with __fadd_rn and
//            WORD2INT: the plain version's five matmuls in the same order.
//            The products run on the bf16 tensor cores (split5_wgmma.cuh,
//            with this file's Tile and word2int).
//            (Fusing the pairs that share a weight plane, w_hi*x_hi +
//            w_hi*x_lo = w_hi*x exactly, rounds each sum elsewhere: on the
//            H100 it disagreed with the plain version on 5.4e-3 of the
//            outputs, past the tie bound.)
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace fir {

constexpr int kRowTile = 64;    // output rows of one block per CTA
constexpr int kLaneTile = 128;  // lanes per CTA (split5)
constexpr int kThreads = 256;   // threads per CTA (f32_fir.cuh: f32::kThreads)

struct Launch {
  const int16_t* hist;     // [H, B]
  const int16_t* x;        // [T, B]
  int16_t* y;              // [n_blocks * R, B]
  const int32_t* taps;     // [P, R / rows, 2] nonzero tap rows [lo, hi)
  int H, T, B, R, K, P;    // weights [P, K, R] per digit plane
};

inline Launch make_launch(const void* hist, const void* x, void* y,
                          const void* taps, int H, int T, int B, int R, int K,
                          int P) {
  return Launch{static_cast<const int16_t*>(hist), static_cast<const int16_t*>(x),
                static_cast<int16_t*>(y), static_cast<const int32_t*>(taps),
                H, T, B, R, K, P};
}

// -- asynchronous copies (split5_wgmma.cuh, f32_fir.cuh) ---------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy; src_bytes 0 fills the chunk with zeros.
__device__ __forceinline__ void copy16(uint32_t dst, const void* src,
                                       int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// Copies 8 int16 samples of virtual row v, lanes lane .. lane+7, to dst
// (zeros past B and past the chunk): one 16-byte cp.async where vec, else
// 2-byte loads and a shared store.
__device__ __forceinline__ void copy_x8(const Launch& g, int v, int lane,
                                        bool vec, uint32_t dst,
                                        const void* any) {
  const int16_t* row = nullptr;
  if (v < g.H)
    row = g.hist + (size_t)v * g.B;
  else if (v - g.H < g.T)
    row = g.x + (size_t)(v - g.H) * g.B;
  const bool in = row != nullptr && lane < g.B;
  if (vec) {
    copy16(dst, in ? row + lane : any, in ? 16 : 0);
    return;
  }
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int b = 0; b < 8; ++b)
    if (in && lane + b < g.B)
      w[b / 2] |= (uint32_t)(uint16_t)__ldg(row + lane + b) << (16 * (b & 1));
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
               "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3])
               : "memory");
}

// Runs set(), which sets a kernel's function attributes, once per device:
// at the first launch there, so a CUDA graph captured after a warm-up
// launch holds no attribute call.  `done` is the caller's (bit d: set on
// device d).
template <typename Set>
inline cudaError_t set_once(std::atomic<unsigned>& done, Set set) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = 1u << (dev & 31);
  if (done.load() & bit) return cudaSuccess;
  err = set();
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

// WORD2INT (arch.h:208-209): round half up, saturate to int16.
__device__ __forceinline__ int16_t word2int(float v) {
  float r = floorf(__fadd_rn(0.5f, v));
  if (v < -32767.5f) r = -32768.0f;
  if (v > 32766.5f) r = 32767.0f;
  return (int16_t)__float2int_rz(r);
}

// Closed-form patch origins of one phase-tiled launch (_kernel_v4's): block
// k's patch starts at floor16((f0 + k*R*num) / den + shift) on the virtual
// axis, taken in 64 bits.  Where P*R*num / den = S is a multiple of 16
// (every phase-tiled geometry), origin(k + P) = origin(k) + S.  The
// division is a multiply-high by den's reciprocal (make_origin: libdivide's
// branch-free unsigned 64-bit divider, exact for every 64-bit numerator):
// a 64-bit division in each CTA's prologue cost the H100 1-3 % of a launch
// (the short CTAs of K1d / K1e, and K2d; PERF.md, PR 26).
struct Origin {
  int shift, num, den, f0;
  unsigned long long magic;  // t / den = (((t - h) >> 1) + h) >> more,
  int more;                  // h = the high 64 bits of magic * t
};

inline Origin make_origin(int shift, int num, int den, int f0) {
  if (den == 1) num *= 2, den = 2, f0 *= 2;  // the divider takes den >= 2
  const int l = 63 - __builtin_clzll((unsigned long long)den);
  if ((den & (den - 1)) == 0) return Origin{shift, num, den, f0, 0, l - 1};
  const unsigned __int128 m = ((unsigned __int128)1 << (65 + l)) / den;
  return Origin{shift, num, den, f0, (unsigned long long)(m + 1), l};
}

__device__ __forceinline__ int origin(const Launch& g, Origin o, int k) {
  const unsigned long long t =
      o.f0 + (unsigned long long)k * g.R * o.num;
  const unsigned long long h = __umul64hi(o.magic, t);
  const long long q = (long long)((((t - h) >> 1) + h) >> o.more);
  return (int)((q + o.shift) / 16 * 16);
}

// Output tile (block k, row tile rt of `rows` rows, the taps table's, lane
// tile lt of `lanes` lanes) whose patch starts at row v0 of the virtual
// axis.
struct Tile {
  int k, rt, m, v0, lane0, t_lo, t_hi;
  __device__ Tile(const Launch& g, int k_, int rt_, int lt, int v0_,
                  int lanes = kLaneTile, int rows = kRowTile)
      : k(k_), rt(rt_), m(k_ % g.P), v0(v0_), lane0(lt * lanes) {
    const int n_rt = g.R / rows;
    t_lo = g.taps[(m * n_rt + rt) * 2];
    t_hi = g.taps[(m * n_rt + rt) * 2 + 1];
  }
};

// One 16-byte shared-memory load of four consecutive floats (f32_fir.cuh).
__device__ __forceinline__ void load4(float* dst, const float* src) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}

// SATURATE32PSHR(s, 15, 32767) (fixed_generic.h:55-57): the low clamp is
// -32767, not -32768.
__device__ __forceinline__ int16_t sat32pshr15(int s) {
  if (s >= (32767 << 15)) return 32767;
  if (s <= -(32767 << 15)) return -32767;
  return (int16_t)((s + (1 << 14)) >> 15);
}

// MULT16_32_Q15(a, b) = a*(b >> 15) + ((a*(b & 0x7fff)) >> 15) mod 2^32
// (fixed_generic.h:90); a*(b >> 15) reaches 2^31 at a = -32768, so the
// products and the sum are taken in uint32.  >> is arithmetic on int.
__device__ __forceinline__ unsigned mult16_32_q15(int a, int b) {
  return (unsigned)a * (unsigned)(b >> 15) +
         (unsigned)((a * (b & 0x7fff)) >> 15);
}

}  // namespace fir
