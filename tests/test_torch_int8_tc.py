"""The streamed int8 kernel's tensor-core layout, on the CPU.

``csrc/int8_wgmma.cuh`` runs the int8 scheme of the streamed kernel on the
int8 tensor cores: x split into bytes (xh = x >> 8, xl = (x & 255) - 128,
the low byte with its top bit flipped), the digit planes K-major,
int8[D, P, R, K_pad], each 32-tap group permuted to the order in which the
kernel's ldmatrix / byte-permute staging lays taps into the wgmma A
fragment (``streamed_fir.K_PERM``).  Nothing here launches a kernel; the
tests pin what the kernel assumes:

- the byte split equals ``_dot_int8``'s xh / xl for all 65,536 int16;
- a NumPy model of the fragment staging puts tap ``K_PERM[k]`` at K
  position k, so the permuted planes give the tap-order dot;
- the K-major, permuted planes map back to ``[D, P, K_pad, R]`` exactly,
  and ``weights_from_jax`` gives the same device weights;
- the plain version on the new layout equals the JAX package's v4 int8
  kernel (interpret mode) bit for bit, D = 3 and 4, at a small size.

The kernel itself is held against the plain version by
tests/test_torch_gpu.py and chip_smoke.py on the card.
"""

import inspect
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speex_resampler_tpu.ops import pallas_fir as jpf
from speex_resampler_tpu_torch.ops.convert import word2int, word2int_np
from speex_resampler_tpu_torch.ops import streamed_fir as tsf
from speex_resampler_tpu_torch.ops import tiled_fir as ttf
from speex_resampler_tpu_torch.parallel import batch as tb

torch.set_num_threads(1)


def test_byte_split_equals_dot_int8():
    """xh = the high byte, xl = the low byte ^ 0x80 (as int8), for every
    int16 x, equal to _dot_int8's expressions, and x - 128 = 256 xh + xl."""
    src = inspect.getsource(jpf._dot_int8)
    assert "xh = (u32 >> 8).astype(jnp.int8)" in src
    assert "xl = ((u32 & 255) - 128).astype(jnp.int8)" in src
    x = np.arange(-32768, 32768, dtype=np.int32).astype(np.int16)
    bits = x.view(np.uint16)
    xh = (bits >> 8).astype(np.uint8).view(np.int8)
    xl = ((bits & 0xFF) ^ 0x80).astype(np.uint8).view(np.int8)
    u32 = jnp.asarray(x).astype(jnp.int32)
    assert np.array_equal(xh, np.asarray((u32 >> 8).astype(jnp.int8)))
    assert np.array_equal(xl, np.asarray(((u32 & 255) - 128)
                                         .astype(jnp.int8)))
    assert np.array_equal(256 * xh.astype(np.int32) + xl,
                          x.astype(np.int32) - 128)


def test_k_perm_permutes_each_half():
    assert sorted(tsf.K_PERM[:16]) == list(range(16))
    assert sorted(tsf.K_PERM[16:]) == list(range(16, 32))


def _byte_perm(a: int, b: int, sel: int) -> int:
    """CUDA's __byte_perm: result byte i is byte (sel >> 4i) & 7 of b:a."""
    src = [(a >> (8 * i)) & 0xFF for i in range(4)] + \
          [(b >> (8 * i)) & 0xFF for i in range(4)]
    return sum(src[(sel >> (4 * i)) & 7] << (8 * i) for i in range(4))


def _ldmatrix_trans(x: np.ndarray, tap0: int, l: int) -> list:
    """ldmatrix.x4.trans of int16 x[tap][lane] (one warp's 16 lanes):
    thread l's four registers, matrix p at taps tap0 + 8*(p // 2) .., lanes
    8*(p % 2) ..; transposed, thread l holds lane l // 4, taps 2*(l % 4)
    and 2*(l % 4) + 1 (low half first)."""
    g, t = l // 4, l % 4
    out = []
    for p in range(4):
        tap = tap0 + 8 * (p // 2) + 2 * t
        lane = 8 * (p % 2) + g
        lo, hi = (int(v) & 0xFFFF for v in x[tap:tap + 2, lane])
        out.append(lo | hi << 16)
    return out


def test_fragment_model_matches_k_perm():
    """The kernel's load_split, modelled in NumPy: fragment register r of
    thread l holds lane g + 8*(r % 2) (g = l // 4) at K positions
    16*(r // 2) + 4*(l % 4) + j, byte j; that K position must hold tap
    K_PERM[k] of the slice, split into xh / xl, so the K-major permuted
    weights give each lane's tap-order dot."""
    rng = np.random.default_rng(0)
    x = rng.integers(-32768, 32768, (32, 16), dtype=np.int16)
    x[0, 0], x[1, 1] = -32768, 32767
    A = {"h": np.zeros((16, 32), np.int64), "l": np.zeros((16, 32), np.int64)}
    for l in range(32):
        lo, hi = _ldmatrix_trans(x, 0, l), _ldmatrix_trans(x, 16, l)
        for r in range(4):
            a = lo[r % 2] if r < 2 else hi[r % 2]
            b = lo[2 + r % 2] if r < 2 else hi[2 + r % 2]
            regs = {"h": _byte_perm(a, b, 0x7531),
                    "l": _byte_perm(a, b, 0x6420) ^ 0x80808080}
            for part, reg in regs.items():
                for j in range(4):
                    k = 16 * (r // 2) + 4 * (l % 4) + j
                    byte = (reg >> (8 * j)) & 0xFF
                    A[part][l // 4 + 8 * (r % 2), k] = \
                        byte - 256 * (byte > 127)
    xs = x[tsf.K_PERM].astype(np.int64).T               # [lane, K position]
    assert np.array_equal(A["h"], xs >> 8)
    assert np.array_equal(A["l"], (xs & 255) - 128)
    w = rng.integers(-128, 128, (1, 1, 32, 8), dtype=np.int8)   # [.., K, R]
    b = tsf.int8_k_major(w.transpose(0, 1, 3, 2))[0, 0].numpy() \
        .astype(np.int64)                                        # [R, K]
    want = (x.astype(np.int64) - 128).T @ w[0, 0].astype(np.int64)
    assert np.array_equal(256 * A["h"] @ b.T + A["l"] @ b.T, want)


def _planes(D: int, P: int, K: int, R: int, seed: int):
    """Random int8 digit planes [D, P, K, R] zero outside a tap band per
    phase, a bias and D scales 2^(8d - 31)."""
    rng = np.random.default_rng(seed)
    planes = rng.integers(-128, 128, (D, P, K, R), dtype=np.int8)
    for m in range(P):
        lo = 16 + 40 * m
        planes[:, m, :lo] = 0
        planes[:, m, lo + 150:] = 0
    bias = (rng.standard_normal((P, R)) * 100).astype(np.float32)
    scales = tuple(float(2.0 ** (8 * d - 31)) for d in range(D))
    return planes, bias, scales


@pytest.mark.parametrize("D", [3, 4])
def test_k_major_planes_map_back(D):
    planes, bias, _ = _planes(D, 3, 256, 128, seed=D)
    w = tsf.device_weights_streamed((planes, bias), "int8", "cpu")
    assert w[0].shape == (D, 3, 128, 256) and w[0].is_contiguous()
    assert np.array_equal(tsf.int8_n_major(w[0]).numpy(), planes)
    kt = w[0].numpy().reshape(D, 3, 128, 8, 32)
    assert np.array_equal(kt[..., 5], planes.transpose(0, 1, 3, 2)
                          .reshape(D, 3, 128, 8, 32)[..., tsf.K_PERM[5]])
    assert np.array_equal(w[1].numpy(), bias)
    taps = ttf.tap_ranges((planes != 0).any(axis=0))
    assert np.array_equal(w[3].numpy(), taps)
    assert type(w[2]) is ttf.BandWidths
    assert w[2].slices == ttf.band_widths(taps).slices
    jax_planes = np.ascontiguousarray(planes.transpose(1, 0, 3, 2))
    got = tb.weights_from_jax((jax_planes, bias), "int8", device="cpu",
                              kernel="streamed")
    assert got[2].slices == w[2].slices
    assert all(torch.equal(a, b) for a, b in zip(got[:2] + got[3:],
                                                 w[:2] + w[3:]))


def test_streamed_int8_guards():
    """N-major planes, or K-major planes whose K is not a multiple of 32,
    are refused."""
    planes, bias, scales = _planes(3, 2, 256, 64, seed=9)
    w = tsf.device_weights_streamed((planes, bias), "int8", "cpu")
    hist = torch.zeros((32, 4), dtype=torch.int16)
    x = torch.zeros((1024, 4), dtype=torch.int16)
    kw = dict(n_blocks=2, shift=8, num=3, den=2, f0=0, scheme="int8",
              scales=scales)
    tsf.resample_streamed(hist, x, w, **kw)
    with pytest.raises(TypeError):
        tsf.resample_streamed(hist, x, (torch.from_numpy(planes), *w[1:]),
                              **kw)
    odd = w[0][..., :240].contiguous()
    with pytest.raises(ValueError, match="multiple of 32"):
        tsf.resample_streamed(hist, x, (odd, *w[1:]), **kw)


@pytest.mark.parametrize("B", [4, 130])
@pytest.mark.parametrize("D", [3, 4])
def test_plain_on_k_major_equals_jax_v4(D, B):
    """P = 2 phases, R 128, K_pad 256, 4 blocks 192 input rows apart (num 3,
    den 2), windows starting in the history; int16 extremes in x."""
    P, K, R, n_blocks, H = 2, 256, 128, 4, 32
    planes, bias, scales = _planes(D, P, K, R, seed=10 + D)
    rng = np.random.default_rng(B + D)
    hist = rng.integers(-32768, 32768, (H, B), dtype=np.int16)
    x = rng.integers(-32768, 32768, (832, B), dtype=np.int16)
    x[::7] = -32768
    x[3::11] = 32767
    kw = dict(n_blocks=n_blocks, shift=8, num=3, den=2, f0=1)
    jax_planes = np.ascontiguousarray(planes.transpose(1, 0, 3, 2))
    jy = jpf.resample_conv_tm_pallas_v4(
        jnp.asarray(hist), jnp.asarray(x),
        (jnp.asarray(jax_planes), jnp.asarray(bias)), interpret=True,
        scheme="int8", scales=scales, **kw)
    w = tb.weights_from_jax((jax_planes, bias), "int8", device="cpu",
                            kernel="streamed")
    ty = tsf.resample_streamed_reference(torch.from_numpy(hist),
                                         torch.from_numpy(x), w,
                                         scheme="int8", scales=scales, **kw)
    assert ty.shape == (n_blocks * R, B)
    assert np.array_equal(ty.numpy(), np.asarray(jy))


# -- the digit split (fir_tile where D is even) -----------------------------

CSRC = Path(tsf.__file__).resolve().parent.parent / "csrc"
HEADER = (CSRC / "int8_wgmma.cuh").read_text()
LAUNCHER = (CSRC / "streamed_fir.cu").read_text()
KK, ROWS, THREADS, TILE_BYTES = 32, 64, 256, 32 * 64   # kK, kRowTile, ...
STAGE_BYTES = -(-(4 * 2 * TILE_BYTES + 64 * (64 * 2 + 16)) // 128) * 128


def _digit_split(D: int) -> bool:
    return D % 2 == 0


def test_digit_split_follows_the_digit_count():
    """fir_tile splits a tile's work between its warpgroups by digit plane
    where D is even, by 32-row half where it is odd: a template argument
    of the streamed kernel, chosen by the launcher from D alone."""
    for line in ("__host__ __device__ constexpr bool digit_split(int digits) {",
                 "  return digits % 2 == 0;",
                 "template <int kD, bool kDigits = digit_split(kD)>",
                 "constexpr int kWgD = kDigits ? kD / 2 : kD;",
                 "constexpr int kRegs = kDigits ? kRowTile / 2 : kAcc;",
                 "int acc[2 * kWgD][kRegs];",
                 "store_tile_digits<kD>(g, c.k, c.rt, c.lane0, acc,",
                 "bias + (size_t)c.m * g.R + c.rt * kRowTile, scales,"):
        assert line in HEADER, line
    for line in ("template <int kD, bool kDigits, bool kBlockMajor>",
                 "constexpr bool kDigits = fir::int8tc::digit_split(kD);",
                 "fir::int8tc::fir_tile<kD, kDigits>(",
                 "kernels[2] = {streamed_fir_int8_kernel<kD, kDigits, false>,"):
        assert line in LAUNCHER, line
    assert [D for D in range(1, 5) if _digit_split(D)] == [2, 4]


def _core_offset(n, c):
    return (n // 8) * 256 + c * 128 + (n % 8) * 16


@pytest.mark.parametrize("D", [1, 2, 3, 4])
def test_stage_gives_each_warpgroup_its_b_tiles(D):
    """Every thread's weight copies of one stage (K-major permuted planes,
    phase 1, row tile 1) into a model of the stage buffer; each warpgroup's
    B tile of each K-slice read back through the descriptor (128 bytes
    between a slice's 16-tap halves, 256 between 8-row groups) is, under
    the digit split, all 64 rows of its digit h*D/2 + d, else its 32-row
    half of digit d."""
    for line in ("const int wr = tid / 4, ws = (tid / 2) % 2, wc = tid % 2;",
                 "const uint32_t wdst = ws * kTileBytes + core_offset(wr, wc);",
                 "copy16(buf + d * kSub * kTileBytes + wdst,",
                 "const int t = t_begin + s * kStageTaps + ws * kK + wc * 16;",
                 "kDigits ? h * kWgD * kSub * kTileBytes : (wg_row / 8) * 256;",
                 "descriptor(buf + (d * kSub + j) * kTileBytes + wg_b);",
                 "return (n / 8) * 256 + c * 128 + (n % 8) * 16;"):
        assert line in HEADER, line
    P, R, K, m, rt, t_begin, s = 2, 128, 256, 1, 1, 64, 1
    rng = np.random.default_rng(D)
    planes = rng.integers(-128, 128, (D, P, R, K), dtype=np.int64)
    smem = np.full(4 * 2 * TILE_BYTES, 999, dtype=np.int64)
    for tid in range(THREADS):
        wr, ws, wc = tid // 4, (tid // 2) % 2, tid % 2
        t = t_begin + s * 2 * KK + ws * KK + wc * 16
        for d in range(D):
            dst = d * 2 * TILE_BYTES + ws * TILE_BYTES + _core_offset(wr, wc)
            smem[dst:dst + 16] = planes[d, m, rt * ROWS + wr, t:t + 16]
    split = _digit_split(D)
    wg_d, n = (D // 2, ROWS) if split else (D, ROWS // 2)
    n_idx, k_idx = np.meshgrid(np.arange(n), np.arange(KK), indexing="ij")
    read = (n_idx // 8) * 256 + (k_idx // 16) * 128 + (n_idx % 8) * 16 \
        + k_idx % 16                                          # [n, KK]
    for h in range(2):
        wg_b = h * wg_d * 2 * TILE_BYTES if split else (h * 32 // 8) * 256
        for j in range(2):
            taps = t_begin + s * 2 * KK + j * KK + np.arange(KK)
            for d in range(wg_d):
                digit, r0 = (h * wg_d + d, 0) if split else (d, 32 * h)
                got = smem[(d * 2 + j) * TILE_BYTES + wg_b + read]
                want = planes[digit, m, rt * ROWS + r0:
                              rt * ROWS + r0 + n][:, taps]
                assert np.array_equal(got, want), (h, j, d)


def _f32(v):
    return np.float32(v)


@pytest.mark.parametrize("D", [2, 4])
def test_digit_split_epilogue_equals_the_sequential_sum(D):
    """store_tile_digits, modelled in NumPy: warpgroup 0's partial sum
    (0 + I_0 s_0 [+ I_1 s_1]) continued by warpgroup 1's products in digit
    order (whichever warpgroup finishes the output), the bias and WORD2INT
    equal the plain version's sequential f32 sum (``apply_weights``' loop,
    in torch) bit for bit, over random int32 digit sums I_d = 256 <w_d, xh>
    + <w_d, xl> (mod 2^32, many of them wrapping), scales and biases."""
    for line in ("float v[kWgD][2 * kFin];",
                 "float total = 0.0f;",
                 "total = __fadd_rn(total, term(d, i, pick(scales, d)));",
                 "v[d][i] = term(d, i, pick(scales, kWgD + d));",
                 "float total = v[0][kFin + i];",
                 "for (int d = 0; d < kWgD; ++d) total = __fadd_rn(total, "
                 "p[d][i]);",
                 "float total = t[i];",
                 "for (int d = 0; d < kWgD; ++d) total = __fadd_rn(total, "
                 "v[d][i]);",
                 "256u * (uint32_t)acc[2 * d][i] + "
                 "(uint32_t)acc[2 * d + 1][i];",
                 "return __fmul_rn(__int2float_rn((int)sum), scale);",
                 '"h"(word2int(__fadd_rn(total, bi)))'):
        assert line in HEADER, line
    rng = np.random.default_rng(D)
    n = 1 << 16
    # the wgmma accumulators: <w_d, xh> and <w_d, xl>, any int32
    hi = rng.integers(-2 ** 31, 2 ** 31, (D, n), dtype=np.int64)
    lo = rng.integers(-2 ** 31, 2 ** 31, (D, n), dtype=np.int64)
    hi[:, :64] = rng.integers(-2 ** 23, 2 ** 23, (D, 64))  # no wrap
    lo[:, :64] = rng.integers(-2 ** 15, 2 ** 15, (D, 64))
    hi[:, 64:66] = 2 ** 23 - 1
    lo[:, 64], lo[:, 65] = 255, 256          # 2^31 - 1, then -2^31
    wrapped = (256 * hi + lo) & 0xFFFFFFFF
    I = np.where(wrapped >= 2 ** 31, wrapped - 2 ** 32, wrapped) \
        .astype(np.int32)                                        # [D, n]
    assert (I[:, 64] == 2 ** 31 - 1).all() and (I[:, 65] == -2 ** 31).all()
    assert ((256 * hi + lo) != I).mean() > 0.9
    scales = [float(2.0 ** (8 * d - 31)) * (1 + rng.random()) for d in
              range(D)]
    scales = np.asarray(scales, dtype=np.float32)
    bias = (rng.standard_normal(n) * 3e4).astype(np.float32)
    If = I.astype(np.float32)                  # __int2float_rn: to nearest
    half = D // 2
    # warpgroup 0: the partial sum, through shared memory
    t = np.zeros(n, dtype=np.float32)
    for d in range(half):
        t = (t + If[d] * scales[d]).astype(np.float32)
    # warpgroup 1: its products, then the continuation
    prod = [(If[d] * scales[d]).astype(np.float32) for d in range(half, D)]
    for p in prod:
        t = (t + p).astype(np.float32)
    y_split = t + bias
    # the plain version's loop (ops/tiled_fir.apply_weights)
    acc = torch.zeros(n, dtype=torch.float32)
    for d in range(D):
        acc = acc + torch.from_numpy(I[d]).float() * float(scales[d])
    y_plain = acc + torch.from_numpy(bias)
    assert np.array_equal(y_split.view(np.int32), y_plain.numpy()
                          .view(np.int32))
    assert np.array_equal(word2int_np(y_split),
                          word2int(y_plain).numpy())


def test_digit_split_register_and_exchange_maps():
    """m64n64k32 accumulator register i of thread (warp w, lane l) of
    either warpgroup is output (lane 16w + l/4 + 8*((i/2)%2), row 8*(i/4) +
    2*(l%4) + i%2): each warpgroup's 32 registers cover the 64 x 64 tile
    once, the same output in the same register of both.  Warpgroup 1
    finishes registers 0-15 and warpgroup 0 registers 16-31: each word of
    the exchange (t of register i < 16, product d of register 16 + i) is
    written by one thread and read by the thread of the other warpgroup
    that holds the same output, every word once, 24 KB inside a stage
    buffer, a warp's 32 threads on 32 banks.  A thread's 8 biases are the
    rows of the 16 registers it finishes; the CTA's row stores cover the
    tile's 16-byte chunks once."""
    for line in ("const int tid = threadIdx.x, h = tid / 128, wt = tid % 128;",
                 "const int w = wt / 32, l = tid % 32;",
                 "auto t_at = [&](int i) { return part + (i * 128 + wt) * 4; "
                 "};",
                 "return part + ((kFin + d * kFin + i) * 128 + wt) * 4;",
                 "if (i < kFin) st(t_at(i), total);",
                 "if (i >= kFin) st(p_at(d, i - kFin), v[d][i]);",
                 "for (int d = 0; d < kWgD; ++d) p[d][i] = ld(p_at(d, i));",
                 "for (int i = 0; i < kFin; ++i) t[i] = ld(t_at(i));",
                 "finish(kFin + i, total);",
                 "finish(i, total);",
                 "const int fin0 = h == 0 ? kFin : 0;",
                 "b[q] = bias_m[8 * (fin0 / 4 + q / 2) + 2 * (l % 4) + q % 2];",
                 "const float bi = b[(i % kFin) / 4 * 2 + i % 2];",
                 "const int lane = 16 * w + l / 4 + 8 * ((i / 2) % 2);",
                 "const int row = 8 * (i / 4) + 2 * (l % 4) + i % 2;",
                 "stage_at(1), ring, [] {});",
                 "static_assert(16 * (1 + kMaxDigits / 2) * 128 * 4 <= "
                 "kStageBytes &&",
                 "store_rows<kRowTile, kThreads>(g, k, rt, lane0, 0, out);"):
        assert line in HEADER, line

    def out(wt, i):
        w, l = wt // 32, wt % 32
        return (16 * w + l // 4 + 8 * ((i // 2) % 2),
                8 * (i // 4) + 2 * (l % 4) + i % 2)

    assert sorted(out(wt, i) for wt in range(128) for i in range(32)) == [
        (a, b) for a in range(64) for b in range(64)]
    for wg_d in (1, 2):                                   # D = 2, 4
        words = {}                                        # word -> output
        for wt in range(128):
            for i in range(16):                  # warpgroup 0 sends t
                words[i * 128 + wt] = out(wt, i)
            for d in range(wg_d):                # warpgroup 1 its products
                for i in range(16):
                    words[(16 + d * 16 + i) * 128 + wt] = out(wt, 16 + i)
        assert sorted(words) == list(range((1 + wg_d) * 16 * 128))
        assert max(words) * 4 + 4 <= 16 * (1 + 2) * 128 * 4 <= STAGE_BYTES
        for wt in range(128):                    # the readers
            assert all(words[i * 128 + wt] == out(wt, i) for i in range(16))
            assert all(words[(16 + d * 16 + i) * 128 + wt] == out(wt, 16 + i)
                       for d in range(wg_d) for i in range(16))
        for word0 in range(0, len(words), 32):   # a warp's 32 threads
            assert len({(word0 + t) % 32 for t in range(32)}) == 32
    for h, fin0 in ((0, 16), (1, 0)):
        for wt in range(128):
            l = wt % 32
            b = [8 * (fin0 // 4 + q // 2) + 2 * (l % 4) + q % 2
                 for q in range(8)]
            assert all(b[i // 4 * 2 + i % 2] == out(wt, fin0 + i)[1]
                       for i in range(16))
    chunks = [(c // 8, c % 8 * 8) for tid in range(THREADS)
              for r in range(ROWS * 64 // 8 // THREADS)
              for c in [tid + r * THREADS]]
    assert sorted(chunks) == [(r, 8 * c) for r in range(ROWS)
                              for c in range(8)]
