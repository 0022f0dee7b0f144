// Probe P3/P4 on Hopper: the sustained tensor-core multiply-add rate with
// both operands resident, at the TPU probes' block shapes and at the wgmma
// shapes the served kernels issue.  It replaces the Pallas kernels of
// experiments/mxu_peak.py (make_fn, pallas_call :68) and
// experiments/mxu_shape_probe.py (make_fn, :53): a grid step writes
// out[i % 16] = sum_{r<8} W . x[r], W [C, K] and x [8, K, LB] with values
// in [-128, 128) as int8 (int32 sums) or bf16 (f32 sums, stored as int32).
//
// Probe P7 (experiments/mosaic_int_dot_bench.py, make_fn :31, pallas_call
// :44) is the same body with W and x cast to wider integers, int32 sums
// exact mod 2^32; on the TPU the wide forms did not compile.  Here an
// integer of n bytes is its bytes in two's complement, v = sum_a 256^a v_a
// with v_a unsigned for a < n - 1 and the top byte signed, so
//
//   W . x = sum_{a, b} 256^(a+b) <W_a, x_b>   mod 2^32
//
// and the terms with a + b >= 4 vanish mod 2^32: 2 int8 products for
// i16.i8 (kNa = 2 bytes of W, kNb = 1 of x), 4 for i16.i16 (the count of
// _dot_fixed's digit products) and 10, not 16, for i32.i32; kNa = kNb = 1
// is the int8 case above.  Each product is one wgmma with the digits' own
// types (.u8 or .s8 on either side), every partial sum below 2^31 (K * 8 *
// 255^2 at K_pad 288 is 1.4e8), products of equal a + b in one
// accumulator, combined in uint32 at the store.  Chosen over IMAD on the
// CUDA cores: at 1,979 TOP/s, 10 int8 products reckon at ~100 T int32
// multiply-adds/s, against ~16 T for IMAD.  The wrapper
// (probes/mosaic_int_dot_bench.py) hands the kernel the operands' byte
// planes, a reinterpretation with no arithmetic.
//
// Operand roles are the served kernels' (int8_wgmma.cuh, split5_wgmma.cuh):
// the lanes are M (64 a warpgroup) and x is the register operand, loaded
// from shared memory with ldmatrix.trans (int8: probes::load_pairs, the
// taps in K_PERM order; bf16: the fragment itself); W is the
// shared-memory descriptor operand (int8tc::descriptor, K-major), so the
// TPU's block height C is the wgmma's N, cut into N-tiles of kN = 32, 64,
// 128 or 256 rows.  wgmma m64nNk32 .s32 or m64nNk16 .f32.bf16.bf16,
// without .satfinite.
//
// A CTA is one warpgroup.  Its unit is one (N-tile, 64-lane tile, group
// of rs x blocks): it copies W's digit tiles and the rs x blocks' digit
// rows into shared memory once (K padded with zero weights to K_pad, a
// multiple of 32), then runs `iters` iterations, each the rs dependent dot
// chains (rs * K_pad / taps K-slices, the kNa * kNb digit products of a
// slice one commit group, a slice's fragments loaded while the previous
// slice's wgmmas run, as the served kernels do) and the tile's store to
// slot iteration % 16.  8 / rs groups split the 8 x blocks where one CTA
// cannot hold them all (bf16 x is 36 KB a block at K_pad 288); their
// partial tiles are added after the loop (probe_common.cuh).  Every
// address of an iteration adds `it & salt`, salt 0 at run time, so the
// compiler can neither hoist nor drop one.
//
// What bounds it: the tensor cores, by construction; the rate is the slope
// of the launch time between two iteration counts (tools/tc_probes.py),
// against the datasheet's 1,979 TOP/s int8 and 989 TFLOP/s bf16 (989.5 and
// 494.5 T multiply-adds/s).
#include "probe_common.cuh"

#include <utility>

namespace probes {
namespace rate {

// The operand lists of a wgmma with n accumulators a thread (c: "+r" or
// "+f"), its register list and the index of its predicate operand.
#define PROBE_D16(c)                                                     \
  c(d[0]), c(d[1]), c(d[2]), c(d[3]), c(d[4]), c(d[5]), c(d[6]),         \
  c(d[7]), c(d[8]), c(d[9]), c(d[10]), c(d[11]), c(d[12]), c(d[13]),     \
  c(d[14]), c(d[15])
#define PROBE_D32(c)                                                     \
  PROBE_D16(c), c(d[16]), c(d[17]), c(d[18]), c(d[19]), c(d[20]),        \
  c(d[21]), c(d[22]), c(d[23]), c(d[24]), c(d[25]), c(d[26]),            \
  c(d[27]), c(d[28]), c(d[29]), c(d[30]), c(d[31])
#define PROBE_D64(c)                                                     \
  PROBE_D32(c), c(d[32]), c(d[33]), c(d[34]), c(d[35]), c(d[36]),        \
  c(d[37]), c(d[38]), c(d[39]), c(d[40]), c(d[41]), c(d[42]),            \
  c(d[43]), c(d[44]), c(d[45]), c(d[46]), c(d[47]), c(d[48]),            \
  c(d[49]), c(d[50]), c(d[51]), c(d[52]), c(d[53]), c(d[54]),            \
  c(d[55]), c(d[56]), c(d[57]), c(d[58]), c(d[59]), c(d[60]),            \
  c(d[61]), c(d[62]), c(d[63])
#define PROBE_D128(c)                                                    \
  PROBE_D64(c), c(d[64]), c(d[65]), c(d[66]), c(d[67]), c(d[68]),        \
  c(d[69]), c(d[70]), c(d[71]), c(d[72]), c(d[73]), c(d[74]),            \
  c(d[75]), c(d[76]), c(d[77]), c(d[78]), c(d[79]), c(d[80]),            \
  c(d[81]), c(d[82]), c(d[83]), c(d[84]), c(d[85]), c(d[86]),            \
  c(d[87]), c(d[88]), c(d[89]), c(d[90]), c(d[91]), c(d[92]),            \
  c(d[93]), c(d[94]), c(d[95]), c(d[96]), c(d[97]), c(d[98]),            \
  c(d[99]), c(d[100]), c(d[101]), c(d[102]), c(d[103]), c(d[104]),       \
  c(d[105]), c(d[106]), c(d[107]), c(d[108]), c(d[109]), c(d[110]),      \
  c(d[111]), c(d[112]), c(d[113]), c(d[114]), c(d[115]), c(d[116]),      \
  c(d[117]), c(d[118]), c(d[119]), c(d[120]), c(d[121]), c(d[122]),      \
  c(d[123]), c(d[124]), c(d[125]), c(d[126]), c(d[127])
#define PROBE_R16                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
  "%15}, {%16, %17, %18, %19}, %20, p"
#define PROBE_P16 "%21"
#define PROBE_R32                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
  "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p"
#define PROBE_P32 "%37"
#define PROBE_R64                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "    \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "    \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, "  \
  "%67}, %68, p"
#define PROBE_P64 "%69"
#define PROBE_R128                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "    \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "    \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "    \
  "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "    \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "    \
  "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "    \
  "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "   \
  "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "   \
  "%127}, {%128, %129, %130, %131}, %132, p"
#define PROBE_P128 "%133"

#define PROBE_WGMMA(SHAPE, P, REGS, TAIL, ...)                            \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " P ", 0;\n"             \
               "wgmma.mma_async.sync.aligned." SHAPE " " REGS TAIL        \
               ";\n}\n"                                                   \
               : __VA_ARGS__                                              \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),      \
                 "r"(accumulate))
#define PROBE_S8(N, n)                                                    \
  if constexpr (kAs && kBs)                                               \
    PROBE_WGMMA("m64n" N "k32.s32.s8.s8", PROBE_P##n, PROBE_R##n, "",     \
                PROBE_D##n("+r"));                                        \
  else if constexpr (kAs)                                                 \
    PROBE_WGMMA("m64n" N "k32.s32.s8.u8", PROBE_P##n, PROBE_R##n, "",     \
                PROBE_D##n("+r"));                                        \
  else if constexpr (kBs)                                                 \
    PROBE_WGMMA("m64n" N "k32.s32.u8.s8", PROBE_P##n, PROBE_R##n, "",     \
                PROBE_D##n("+r"));                                        \
  else                                                                    \
    PROBE_WGMMA("m64n" N "k32.s32.u8.u8", PROBE_P##n, PROBE_R##n, "",     \
                PROBE_D##n("+r"));

// d (+)= A . B for one K-slice, n = N / 2 accumulators a thread: A (x's
// digit) .s8 where kAs, else .u8, B (W's) likewise by kBs; the served
// kernels' int8tc::mma for their N-tiles, 32 and 64.
template <bool kAs, bool kBs, int n>
__device__ __forceinline__ void mma(int (&d)[n], const uint32_t (&a)[4],
                                    uint64_t b, int accumulate) {
  if constexpr (kAs && kBs && n <= 32) {
    fir::int8tc::mma(d, a, b, accumulate);
  } else if constexpr (n == 16) {
    PROBE_S8("32", 16)
  } else if constexpr (n == 32) {
    PROBE_S8("64", 32)
  } else if constexpr (n == 64) {
    PROBE_S8("128", 64)
  } else {
    PROBE_S8("256", 128)
  }
}

// The bf16 form: m64nNk16 .f32.bf16.bf16 with a K-major B (the last
// immediate, trans-b, 0).
template <bool kAs, bool kBs, int n>
__device__ __forceinline__ void mma(float (&d)[n], const uint32_t (&a)[4],
                                    uint64_t b, int accumulate) {
  if constexpr (n == 16)
    PROBE_WGMMA("m64n32k16.f32.bf16.bf16", PROBE_P16, PROBE_R16, ", 1, 1, 0",
                PROBE_D16("+f"));
  else if constexpr (n == 32)
    PROBE_WGMMA("m64n64k16.f32.bf16.bf16", PROBE_P32, PROBE_R32, ", 1, 1, 0",
                PROBE_D32("+f"));
  else if constexpr (n == 64)
    PROBE_WGMMA("m64n128k16.f32.bf16.bf16", PROBE_P64, PROBE_R64,
                ", 1, 1, 0", PROBE_D64("+f"));
  else
    PROBE_WGMMA("m64n256k16.f32.bf16.bf16", PROBE_P128, PROBE_R128,
                ", 1, 1, 0", PROBE_D128("+f"));
}
#undef PROBE_S8
#undef PROBE_WGMMA
#undef PROBE_P128
#undef PROBE_R128
#undef PROBE_P64
#undef PROBE_R64
#undef PROBE_P32
#undef PROBE_R32
#undef PROBE_P16
#undef PROBE_R16
#undef PROBE_D128
#undef PROBE_D64
#undef PROBE_D32
#undef PROBE_D16

template <int n>
__device__ __forceinline__ void pin(int (&d)[n]) {
  fir::int8tc::pin(d);
}
template <int n>
__device__ __forceinline__ void pin(float (&d)[n]) {
#pragma unroll
  for (int i = 0; i < n; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A form of kNa bytes of W and kNb of x: its accumulators, one a shift a +
// b below 4; its digit pairs (a of W, b of x) run b outer, a inner.
template <int kNa, int kNb>
struct Form {
  static constexpr int kShifts = kNa + kNb - 1 < 4 ? kNa + kNb - 1 : 4;
  // the first pair the loop meets of shift s = a + b: b as small as a < kNa
  // allows
  __host__ __device__ static constexpr bool first(int a, int b) {
    return b == (a + b - (kNa - 1) > 0 ? a + b - (kNa - 1) : 0);
  }
};

// One digit product of a K-slice: pair kP (b = kP / kNa of x, a = kP %
// kNa of W) into the accumulator of its shift a + b, none where a + b >= 4.
template <int kNa, int kNb, int kP, typename Acc, int kS, int kRegs>
__device__ __forceinline__ void product(Acc (&acc)[kS][kRegs],
                                        const uint32_t (&fr)[kNb][4],
                                        uint32_t wt, uint32_t wplane, int q) {
  constexpr int b = kP / kNa, a = kP % kNa;
  if constexpr (a + b < 4)
    mma<b == kNb - 1, a == kNa - 1>(acc[a + b], fr[b],
                                    fir::int8tc::descriptor(wt + a * wplane),
                                    q > 0 || !Form<kNa, kNb>::first(a, b));
}
template <int kNa, int kNb, typename Acc, int kS, int kRegs, int... kP>
__device__ __forceinline__ void products(std::integer_sequence<int, kP...>,
                                         Acc (&acc)[kS][kRegs],
                                         const uint32_t (&fr)[kNb][4],
                                         uint32_t wt, uint32_t wplane,
                                         int q) {
  (product<kNa, kNb, kP>(acc, fr, wt, wplane, q), ...);
}

struct Args {
  const uint8_t* w;  // [kNa, C, K_pad] int8 digits (each 32-tap group
                     // K_PERM) or [C, K_pad] bf16
  const uint8_t* x;  // [kNb, 8, K_pad, LB] int8 digits or [8, K_pad, LB] bf16
  uint32_t* out;     // [groups, 16, C, LB] int32
  uint32_t* scratch; // [n_ctas - n_units, kN, 64]: the copies' tiles
  int C, K, LB, rs, iters, salt;
};

template <bool kBf16, int kN>
__host__ __device__ constexpr int pitch() {
  return kLanes * (kBf16 ? 2 : 1) + 16;
}

// Dynamic shared memory: W's kNa digit tiles, rs x blocks of kNb digit
// rows, alignment.
template <bool kBf16, int kN, int kNa, int kNb>
__host__ __device__ constexpr int smem_bytes(int K, int rs) {
  return kNa * kN * K * (kBf16 ? 2 : 1) + rs * kNb * K * pitch<kBf16, kN>()
         + 128;
}

template <bool kBf16, int kN, int kNa, int kNb>
__global__ void __launch_bounds__(kWgThreads)
    tc_rate_kernel(const Args g) {
  using Acc = typename std::conditional<kBf16, float, int>::type;
  using F = Form<kNa, kNb>;
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
  const uint32_t wplane = kN * kb;    // a W digit's tile
  const uint32_t xplane = g.rs * g.K * kPitch;  // an x digit's rs blocks
  const uint32_t xsm = wsm + kNa * wplane;

  for (int a = 0; a < kNa; ++a)
    stage_w(wsm + a * wplane, g.w + ((size_t)a * g.C + nt * kN) * kb, kb, kN,
            kb, tid, kWgThreads);
  for (int b = 0; b < kNb; ++b)
    for (int r = 0; r < g.rs; ++r)
      stage_rows(xsm + b * xplane + r * g.K * kPitch, kPitch,
                 g.x + (((size_t)b * 8 + grp * g.rs + r) * g.K * g.LB +
                        lt * kLanes) * kEs,
                 (size_t)g.LB * kEs, g.K, kLanes * kEs, tid, kWgThreads);
  staged();

  // this thread's ldmatrix row in a K-slice of x
  const uint32_t frag = kBf16 ? (8 * (l / 16) + l % 8) * kPitch +
                                    (16 * w + 8 * ((l / 8) % 2)) * 2
                              : l * kPitch + 16 * w;
  uint32_t* out = g.out + (size_t)grp * kSlots * g.C * g.LB;
  uint32_t* own = g.scratch + (size_t)(blockIdx.x - n_units) * kN * kLanes;
  const int n_q = g.rs * n_sl;        // K-slices an iteration
  Acc acc[F::kShifts][kRegs];
#pragma unroll
  for (int s = 0; s < F::kShifts; ++s)
#pragma unroll
    for (int i = 0; i < kRegs; ++i) acc[s][i] = 0;
  uint32_t fr[2][kNb][4];
  uint32_t xa, wa;
  int s;
  // K-slice q of an iteration, one commit group, its fragments in set j:
  // loaded once the group before the last is done (so set j is free),
  // while the last one runs
  auto slice = [&](auto set, int q) {
    constexpr int j = decltype(set)::value;
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
#pragma unroll
    for (int b = 0; b < kNb; ++b) {
      fir::int8tc::pin(fr[j][b]);
      if (kBf16)
        fir::int8tc::ldmatrix_t(xa + b * xplane, fr[j][b]);
      else
        load_pairs(xa + b * xplane, fr[j][b]);
    }
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    products<kNa, kNb>(std::make_integer_sequence<int, kNa * kNb>{}, acc,
                       fr[j], wa, wplane, q);
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
#pragma unroll
    for (int d = 0; d < F::kShifts; ++d) pin(acc[d]);
    uint32_t* slot = out + (size_t)(it % kSlots) * g.C * g.LB;
#pragma unroll
    for (int i = 0; i < kRegs; ++i) {
      const int lane = tile_lane<!kBf16>(w, l, i), col = tile_col(l, i);
      uint32_t v = 0;
      if constexpr (kBf16) {
        v = (uint32_t)__float2int_rz(acc[0][i]);
      } else {
        // the shifts' sums, 256^d apart, mod 2^32
#pragma unroll
        for (int d = F::kShifts - 1; d >= 0; --d)
          v = v * 256u + (uint32_t)acc[d][i];
      }
      if (first)
        slot[(size_t)(nt * kN + col) * g.LB + lt * kLanes + lane] = v;
      else
        own[col * kLanes + lane] = v;
    }
  }
}

template <bool kBf16, int kN, int kNa, int kNb>
int launch(const void* w, const void* x, void* out, void* partial,
           void* scratch, int C, int K, int LB, int rs, int n_ctas, int iters,
           int salt, cudaStream_t stream) {
  const int smem = smem_bytes<kBf16, kN, kNa, kNb>(K, rs);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = tc_rate_kernel<kBf16, kN, kNa, kNb>;
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

template <bool kBf16, int kN, int kNa, int kNb>
int fill_ctas(int C, int K, int LB, int rs) {
  return fill(tc_rate_kernel<kBf16, kN, kNa, kNb>, kWgThreads,
              smem_bytes<kBf16, kN, kNa, kNb>(K, rs),
              (C / kN) * (LB / kLanes) * (8 / rs));
}

// Calls f.template operator()<kBf16, kN, kNa, kNb>() for the runtime
// (bf16, n, na, nb): bf16 and int8 at every N-tile, and each wider integer
// form of P7 at the widest N-tile whose accumulators fit beside the
// fragments (128 for i16.i8 and i16.i16, 64 for i32.i32).
template <typename F>
int dispatch(int bf16, int n, int na, int nb, F f) {
#define PROBE_RATE_CASE(B, N, NA, NB)                             \
  if (bf16 == B && n == N && na == NA && nb == NB)                \
    return f(std::integral_constant<bool, B>{},                   \
             std::integral_constant<int, N>{},                    \
             std::integral_constant<int, NA>{},                   \
             std::integral_constant<int, NB>{});
  PROBE_RATE_CASE(0, 32, 1, 1) PROBE_RATE_CASE(0, 64, 1, 1)
  PROBE_RATE_CASE(0, 128, 1, 1) PROBE_RATE_CASE(0, 256, 1, 1)
  PROBE_RATE_CASE(1, 32, 1, 1) PROBE_RATE_CASE(1, 64, 1, 1)
  PROBE_RATE_CASE(1, 128, 1, 1) PROBE_RATE_CASE(1, 256, 1, 1)
  PROBE_RATE_CASE(0, 128, 2, 1) PROBE_RATE_CASE(0, 128, 2, 2)
  PROBE_RATE_CASE(0, 64, 4, 4)
#undef PROBE_RATE_CASE
  return -static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace rate
}  // namespace probes

extern "C" {

const char* probe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err < 0 ? -err : err));
}

#define PROBE_RATE_ARGS                                                   \
  constexpr bool kB = decltype(b)::value;                                 \
  constexpr int kN = decltype(nn)::value, kA = decltype(a)::value,        \
                kX = decltype(xb)::value;

// Dynamic shared memory of one CTA (tiled in ops: probes/tc_rate.py).
int probe_tc_rate_smem(int bf16, int n, int na, int nb, int K, int rs) {
  return probes::rate::dispatch(bf16, n, na, nb,
                                [&](auto b, auto nn, auto a, auto xb) {
    PROBE_RATE_ARGS
    return probes::rate::smem_bytes<kB, kN, kA, kX>(K, rs);
  });
}

// The CTAs a launch needs to fill the card (negative: a CUDA error).
int probe_tc_rate_fill(int bf16, int n, int na, int nb, int C, int K, int LB,
                       int rs) {
  return probes::rate::dispatch(bf16, n, na, nb,
                                [&](auto b, auto nn, auto a, auto xb) {
    PROBE_RATE_ARGS
    return probes::rate::fill_ctas<kB, kN, kA, kX>(C, K, LB, rs);
  });
}

// w [C, K] (int8: each 32-tap group K_PERM; bf16) and x [8, K, LB], or for
// na, nb > 1 their byte planes uint8 [na, C, K] and [nb, 8, K, LB] (little
// end first, W's 32-tap groups K_PERM), both 16-byte aligned, K % 32 == 0,
// C % n == 0, LB % 64 == 0, 8 % rs == 0; out int32 [16, C, LB]; partial
// int32 [8 / rs, 16, C, LB] where rs < 8; scratch int32 [n_ctas - units, n,
// 64] where n_ctas > the units (C / n) * (LB / 64) * (8 / rs) (n_ctas >=
// the units); iters >= 16 writes every slot; salt 0.  Launches on `stream`
// and returns cudaGetLastError() (0 on success).
int probe_tc_rate(const void* w, const void* x, void* out, void* partial,
                  void* scratch, int bf16, int n, int na, int nb, int C,
                  int K, int LB, int rs, int n_ctas, int iters, int salt,
                  void* stream) {
  cudaGetLastError();
  if ((reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(x)) % 16 ||
      K % 32 || n <= 0 || C % n || LB % probes::kLanes || rs <= 0 || 8 % rs ||
      n_ctas < (C / n) * (LB / probes::kLanes) * (8 / rs))
    return static_cast<int>(cudaErrorInvalidValue);
  return probes::rate::dispatch(bf16, n, na, nb,
                                [&](auto b, auto nn, auto a, auto xb) {
    PROBE_RATE_ARGS
    return probes::rate::launch<kB, kN, kA, kX>(
        w, x, out, partial, scratch, C, K, LB, rs, n_ctas, iters, salt,
        static_cast<cudaStream_t>(stream));
  });
}

#undef PROBE_RATE_ARGS

}  // extern "C"
