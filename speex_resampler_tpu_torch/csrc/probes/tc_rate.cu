// Probe P3/P4 on Hopper: the sustained tensor-core multiply-add rate with
// both operands resident, at the TPU probes' block shapes and at the wgmma
// shapes the served kernels issue.  It replaces the Pallas kernels of
// experiments/mxu_peak.py (make_fn, pallas_call :68) and
// experiments/mxu_shape_probe.py (make_fn, :53): a grid step writes
// out[i % 16] = sum_{r<8} W . x[r], W [C, K] and x [8, K, LB] with values
// in [-128, 128) as int8 (int32 sums) or bf16 (f32 sums, stored as int32).
//
// Operand roles are the served kernels' (int8_wgmma.cuh, split5_wgmma.cuh):
// the lanes are M (64 a warpgroup) and x is the register operand, loaded
// from shared memory with ldmatrix.trans (int8: probes::load_pairs, the
// taps in K_PERM order; bf16: the fragment itself); W is the
// shared-memory descriptor operand (int8tc::descriptor, K-major), so the
// TPU's block height C is the wgmma's N, cut into N-tiles of kN = 32, 64,
// 128 or 256 rows.  wgmma m64nNk32 .s32.s8.s8 or m64nNk16 .f32.bf16.bf16,
// without .satfinite.
//
// A CTA is one warpgroup.  Its unit is one (N-tile, 64-lane tile, group
// of rs x blocks): it copies the W rows and the rs x blocks' lanes into
// shared memory once (K padded with zero weights to K_pad, a multiple of
// 32), then runs `iters` iterations, each the rs dependent dot chains
// (rs * K_pad / taps wgmmas into one accumulator, a commit group a K-slice,
// a slice's fragments loaded while the previous slice's wgmmas run, as the
// served kernels do) and the tile's store to slot iteration % 16.  8 / rs
// groups split the 8 x blocks where one CTA cannot hold them all (bf16 x is
// 36 KB a block at K_pad 288); their partial tiles are added after the
// loop (probe_common.cuh).  Every address of an iteration adds `it & salt`,
// salt 0 at run time, so the compiler can neither hoist nor drop one.
//
// What bounds it: the tensor cores, by construction; the rate is the slope
// of the launch time between two iteration counts (tools/tc_probes.py),
// against the datasheet's 1,979 TOP/s int8 and 989 TFLOP/s bf16 (989.5 and
// 494.5 T multiply-adds/s).
#include "probe_common.cuh"

namespace probes {
namespace rate {

template <bool kBf16, int kN>
struct Tag {};

// d (+)= A . B for the int8 N-tiles the served kernels use: int8tc::mma.
__device__ __forceinline__ void mma(Tag<false, 32>, int (&d)[16],
                                    const uint32_t (&a)[4], uint64_t b,
                                    int accumulate) {
  fir::int8tc::mma(d, a, b, accumulate);
}
__device__ __forceinline__ void mma(Tag<false, 64>, int (&d)[32],
                                    const uint32_t (&a)[4], uint64_t b,
                                    int accumulate) {
  fir::int8tc::mma(d, a, b, accumulate);
}

// The other N-tiles: m64n128k32 / m64n256k32 s8, m64nNk16 bf16 with a
// K-major B (the last immediate, trans-b, 0).
__device__ __forceinline__ void mma(Tag<false, 128>, int (&d)[64],
                                    const uint32_t (&a)[4], uint64_t b,
                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void mma(Tag<false, 256>, int (&d)[128],
                                    const uint32_t (&a)[4], uint64_t b,
                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, "
      "{%128, %129, %130, %131}, %132, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
        "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
        "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]),
        "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]),
        "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]),
        "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void mma(Tag<true, 32>, float (&d)[16],
                                    const uint32_t (&a)[4], uint64_t b,
                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void mma(Tag<true, 64>, float (&d)[32],
                                    const uint32_t (&a)[4], uint64_t b,
                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void mma(Tag<true, 128>, float (&d)[64],
                                    const uint32_t (&a)[4], uint64_t b,
                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void mma(Tag<true, 256>, float (&d)[128],
                                    const uint32_t (&a)[4], uint64_t b,
                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <int n>
__device__ __forceinline__ void pin(int (&d)[n]) {
  fir::int8tc::pin(d);
}
template <int n>
__device__ __forceinline__ void pin(float (&d)[n]) {
#pragma unroll
  for (int i = 0; i < n; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

struct Args {
  const uint8_t* w;  // [C, K_pad] int8 (each 32-tap group K_PERM) or bf16
  const uint8_t* x;  // [8, K_pad, LB] int8 or bf16
  uint32_t* out;     // [groups, 16, C, LB] int32
  uint32_t* scratch; // [n_ctas - n_units, kN, 64]: the copies' tiles
  int C, K, LB, rs, iters, salt;
};

template <bool kBf16, int kN>
__host__ __device__ constexpr int pitch() {
  return kLanes * (kBf16 ? 2 : 1) + 16;
}

// Dynamic shared memory: the W tile, rs x blocks, alignment.
template <bool kBf16, int kN>
__host__ __device__ constexpr int smem_bytes(int K, int rs) {
  return kN * K * (kBf16 ? 2 : 1) + rs * K * pitch<kBf16, kN>() + 128;
}

template <bool kBf16, int kN>
__global__ void __launch_bounds__(kWgThreads)
    tc_rate_kernel(const Args g) {
  using Acc = typename std::conditional<kBf16, float, int>::type;
  constexpr int kEs = kBf16 ? 2 : 1;
  constexpr int kTaps = kK / kEs;     // taps a wgmma: 32 int8, 16 bf16
  constexpr int kPitch = pitch<kBf16, kN>();
  constexpr int kRegs = kN / 2;
  extern __shared__ uint8_t rate_smem[];
  const uint32_t wsm = (fir::smem_addr(rate_smem) + 127) & ~127u;
  const int tid = threadIdx.x, w = tid / 32, l = tid % 32;
  const int n_lt = g.LB / kLanes, n_nt = g.C / kN;
  const int n_units = n_lt * n_nt * (8 / g.rs);
  const int u = blockIdx.x % n_units;
  const bool first = blockIdx.x < n_units;
  const int lt = u % n_lt, nt = u / n_lt % n_nt, grp = u / (n_lt * n_nt);
  const int kb = g.K * kEs;           // a W row's bytes
  const int n_sl = g.K / kTaps;       // K-slices a dot chain
  const uint32_t xsm = wsm + kN * kb;

  stage_w(wsm, g.w + (size_t)nt * kN * kb, kb, kN, kb, tid, kWgThreads);
  for (int r = 0; r < g.rs; ++r)
    stage_rows(xsm + r * g.K * kPitch, kPitch,
               g.x + ((size_t)(grp * g.rs + r) * g.K * g.LB + lt * kLanes) *
                         kEs,
               (size_t)g.LB * kEs, g.K, kLanes * kEs, tid, kWgThreads);
  staged();

  // this thread's ldmatrix row in a K-slice of x
  const uint32_t frag = kBf16 ? (8 * (l / 16) + l % 8) * kPitch +
                                    (16 * w + 8 * ((l / 8) % 2)) * 2
                              : l * kPitch + 16 * w;
  uint32_t* out = g.out + (size_t)grp * kSlots * g.C * g.LB;
  uint32_t* own = g.scratch + (size_t)(blockIdx.x - n_units) * kN * kLanes;
  const int n_q = g.rs * n_sl;        // K-slices an iteration
  Acc acc[kRegs];
#pragma unroll
  for (int i = 0; i < kRegs; ++i) acc[i] = 0;
  uint32_t a[2][4];
  uint32_t xa, wa;
  int s;
  // K-slice q of an iteration, one commit group, its fragments in set j:
  // loaded once the group before the last is done (so set j is free),
  // while the last one runs
  auto slice = [&](auto set, int q) {
    constexpr int j = decltype(set)::value;
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    fir::int8tc::pin(a[j]);
    if (kBf16)
      fir::int8tc::ldmatrix_t(xa, a[j]);
    else
      load_pairs(xa, a[j]);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    mma(Tag<kBf16, kN>{}, acc, a[j], fir::int8tc::descriptor(wa), q > 0);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  };
  auto next = [&](uint32_t salt) {
    xa += kTaps * kPitch;
    wa += kN * kK;
    if (++s == n_sl) {
      s = 0;
      wa = wsm + salt;
    }
  };
#pragma unroll 1
  for (int it = 0; it < g.iters; ++it) {
    const uint32_t salt = (uint32_t)it & (uint32_t)g.salt;
    // x of block r follows block r - 1's, so its address only grows; W's
    // returns to the first slice at each block
    xa = xsm + frag + salt;
    wa = wsm + salt;
    s = 0;
    // whole pairs, then an odd last slice: no exit between a pair's
    // groups, which would make ptxas serialize the wgmmas (C7513)
#pragma unroll 1
    for (int q = 0; q + 1 < n_q; q += 2) {
      slice(std::integral_constant<int, 0>{}, q);
      next(salt);
      slice(std::integral_constant<int, 1>{}, q + 1);
      next(salt);
    }
    if (n_q % 2) slice(std::integral_constant<int, 0>{}, n_q - 1);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    pin(acc);
    uint32_t* slot = out + (size_t)(it % kSlots) * g.C * g.LB;
#pragma unroll
    for (int i = 0; i < kRegs; ++i) {
      const int lane = tile_lane<!kBf16>(w, l, i), col = tile_col(l, i);
      const uint32_t v =
          kBf16 ? (uint32_t)__float2int_rz((float)acc[i]) : (uint32_t)acc[i];
      if (first)
        slot[(size_t)(nt * kN + col) * g.LB + lt * kLanes + lane] = v;
      else
        own[col * kLanes + lane] = v;
    }
  }
}

template <bool kBf16, int kN>
int launch(const void* w, const void* x, void* out, void* partial,
           void* scratch, int C, int K, int LB, int rs, int n_ctas, int iters,
           int salt, cudaStream_t stream) {
  const int smem = smem_bytes<kBf16, kN>(K, rs);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = tc_rate_kernel<kBf16, kN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = 8 / rs;
  const Args g{static_cast<const uint8_t*>(w), static_cast<const uint8_t*>(x),
               static_cast<uint32_t*>(groups > 1 ? partial : out),
               static_cast<uint32_t*>(scratch), C, K, LB, rs, iters, salt};
  kernel<<<n_ctas, kWgThreads, smem, stream>>>(g);
  err = cudaGetLastError();
  if (err == cudaSuccess && groups > 1)
    err = partial_sum(partial, out, groups, (long long)kSlots * C * LB,
                      stream);
  return static_cast<int>(err);
}

template <bool kBf16, int kN>
int fill_ctas(int C, int K, int LB, int rs) {
  return fill(tc_rate_kernel<kBf16, kN>, kWgThreads,
              smem_bytes<kBf16, kN>(K, rs),
              (C / kN) * (LB / kLanes) * (8 / rs));
}

// Calls f.template operator()<kBf16, kN>() for the runtime (bf16, n).
template <typename F>
int dispatch(int bf16, int n, F f) {
#define PROBE_RATE_CASE(B, N) \
  if (bf16 == B && n == N) return f(std::integral_constant<bool, B>{}, \
                                    std::integral_constant<int, N>{});
  PROBE_RATE_CASE(0, 32) PROBE_RATE_CASE(0, 64) PROBE_RATE_CASE(0, 128)
  PROBE_RATE_CASE(0, 256) PROBE_RATE_CASE(1, 32) PROBE_RATE_CASE(1, 64)
  PROBE_RATE_CASE(1, 128) PROBE_RATE_CASE(1, 256)
#undef PROBE_RATE_CASE
  return -static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace rate
}  // namespace probes

extern "C" {

const char* probe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err < 0 ? -err : err));
}

// Dynamic shared memory of one CTA (tiled in ops: probes/tc_rate.py).
int probe_tc_rate_smem(int bf16, int n, int K, int rs) {
  return probes::rate::dispatch(bf16, n, [&](auto b, auto nn) {
    return probes::rate::smem_bytes<decltype(b)::value, decltype(nn)::value>(
        K, rs);
  });
}

// The CTAs a launch needs to fill the card (negative: a CUDA error).
int probe_tc_rate_fill(int bf16, int n, int C, int K, int LB, int rs) {
  return probes::rate::dispatch(bf16, n, [&](auto b, auto nn) {
    return probes::rate::fill_ctas<decltype(b)::value, decltype(nn)::value>(
        C, K, LB, rs);
  });
}

// w [C, K] (int8: each 32-tap group K_PERM; bf16) and x [8, K, LB], both
// 16-byte aligned, K % 32 == 0, C % n == 0, LB % 64 == 0, 8 % rs == 0;
// out int32 [16, C, LB]; partial int32 [8 / rs, 16, C, LB] where rs < 8;
// scratch int32 [n_ctas - units, n, 64] where n_ctas > the units (C / n) *
// (LB / 64) * (8 / rs) (n_ctas >= the units); iters >= 16 writes every
// slot; salt 0.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
int probe_tc_rate(const void* w, const void* x, void* out, void* partial,
                  void* scratch, int bf16, int n, int C, int K, int LB, int rs,
                  int n_ctas, int iters, int salt, void* stream) {
  cudaGetLastError();
  if ((reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(x)) % 16 ||
      K % 32 || n <= 0 || C % n || LB % probes::kLanes || rs <= 0 || 8 % rs ||
      n_ctas < (C / n) * (LB / probes::kLanes) * (8 / rs))
    return static_cast<int>(cudaErrorInvalidValue);
  return probes::rate::dispatch(bf16, n, [&](auto b, auto nn) {
    return probes::rate::launch<decltype(b)::value, decltype(nn)::value>(
        w, x, out, partial, scratch, C, K, LB, rs, n_ctas, iters, salt,
        static_cast<cudaStream_t>(stream));
  });
}

}  // extern "C"
