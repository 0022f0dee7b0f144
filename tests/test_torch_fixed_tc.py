"""The fixed-point kernels' tensor-core layout, on the CPU.

``csrc/fixed_wgmma.cuh`` runs the fixed scheme (the Q15 universe) of the
tiled and streamed kernels on the int8 tensor cores, as the JAX package's
``_dot_fixed`` runs it on the MXU: the int16 taps split as ``w = 256*wh +
wl0`` (``balanced_q15_split``), x as ``256*xh + xl + 128`` (the bytes of
``int8_wgmma.cuh``'s load_split), four int8 dots and a bias ``128 * sum
w``.  The device planes are K-major, int8[2, P, C, K_pad], each 32-tap
group permuted to the fragment's tap order (``tiled_fir.K_PERM``).
Nothing here launches a kernel; the tests pin what the kernel assumes:

- the four-pass identity with the bias equals the int16 dot mod 2^32, at
  the realizable tap bound, for int16 extremes and for the wrap input
  (``fixed_inputs.wrap_input``, an accumulator past 2^31);
- the device planes of all three served fixed paths map back to the int16
  weights (inverse permutation, zero padding), with the bias, coefficients
  and the fixed CTA's tap table;
- a NumPy model of the kernel's B-tile staging and accumulator register
  map recovers each output's (lane, row, column set);
- the plain versions on the new layout equal the JAX package's v3 / v4
  ``scheme="fixed"`` kernels (interpret mode) bit for bit;
- the port's planes built from the JAX package's
  ``fixed_weight_planes_tiled`` output (``weights_from_jax``) equal its
  own;
- the wrapper guards, and CPU tensors never launch.

The kernels themselves are held against the plain versions by
tests/test_torch_gpu.py and chip_smoke.py on the card.
"""

import dataclasses
import inspect
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speex_resampler_tpu.ops import filter_design as jfd
from speex_resampler_tpu.ops import pallas_fir as jpf
from speex_resampler_tpu.parallel import batch as jb
from speex_resampler_tpu_torch.ops import filter_design as tfd
from speex_resampler_tpu_torch.ops import fixed_math as tfm
from speex_resampler_tpu_torch.ops import phase as tph
from speex_resampler_tpu_torch.ops import streamed_fir as tsf
from speex_resampler_tpu_torch.ops import tiled_fir as ttf
from speex_resampler_tpu_torch.parallel import batch as tb

import fixed_inputs
from fixed_inputs import launch_inputs

torch.set_num_threads(1)

CSRC = Path(tb.__file__).resolve().parent.parent / "csrc"
U32 = 2 ** 32

# (in, out, quality, target frames, geometry): the served fixed paths
FLAGSHIP = (44100, 48000, 7, 2352, "tiled")      # n_accum 4, R 128, P 20
SLICE = (48000, 44100, 10, 20480, "streamed")    # n_accum 4, P 147
DIRECT = (24000, 48000, 5, 2560, "tiled")        # n_accum 1, R 256, P 1
DIRECT_STREAMED = (24000, 48000, 5, 2560, "streamed")


def _port_step(cfg, f0: int = 0):
    i, o, q, target, kernel = cfg
    g = math.gcd(i, o)
    spec = tfd.design_filter(i // g, o // g, q, fixed_point=True)
    bspec = dataclasses.replace(tb._launch_geometry(spec, target, f0=f0),
                                kernel=kernel)
    step = tb.make_batched_step(spec, bspec, device="cpu")
    assert (step.kernel, step.scheme) == (kernel, "fixed")
    return spec, bspec, step


def _bytes(x: np.ndarray):
    """load_split's bytes of int16 x: xh = the high byte, xl = the low byte
    ^ 0x80, both as int8 (int64 here)."""
    bits = x.astype(np.int16).view(np.uint16).astype(np.int64)
    xh = (bits >> 8) - 256 * (bits >> 15)
    xl = ((bits & 0xFF) ^ 0x80) - 256 * (((bits & 0xFF) ^ 0x80) >> 7)
    return xh, xl


def _kernel_sums(wh, wl0, bias, x):
    """The kernel's accumulator: 65536*<wh, xh> + 256*(<wh, xl> + <wl0,
    xh>) + <wl0, xl> + bias, mod 2^32 (uint32 as int64).  wh, wl0: [C, K]
    in the planes' K order; bias [C]; x int16 [K, B] in the same order."""
    xh, xl = _bytes(x)
    wh, wl0 = wh.astype(np.int64), wl0.astype(np.int64)
    acc = (65536 * (wh @ xh) + 256 * (wh @ xl + wl0 @ xh) + wl0 @ xl
           + bias.astype(np.int64)[:, None])
    return acc % U32


def test_byte_split_is_the_jax_split():
    """x = 256*xh + xl + 128 for every int16, with _dot_fixed's xh / xl."""
    src = inspect.getsource(jpf._dot_fixed)
    assert "xh = (u32 >> 8).astype(jnp.int8)" in src
    assert "xl = ((u32 & 255) - 128).astype(jnp.int8)" in src
    x = np.arange(-32768, 32768, dtype=np.int32).astype(np.int16)
    xh, xl = _bytes(x)
    assert np.array_equal(256 * xh + xl + 128, x.astype(np.int64))
    u32 = jnp.asarray(x).astype(jnp.int32)
    assert np.array_equal(xh, np.asarray((u32 >> 8).astype(jnp.int8)))
    assert np.array_equal(xl, np.asarray(((u32 & 255) - 128)
                                         .astype(jnp.int8)))


@pytest.mark.parametrize("case", ["random", "extremes", "wrap"])
def test_four_pass_identity_equals_int16_dot_mod_2_32(case):
    """The four int8 dots plus the bias equal sum w*x mod 2^32 (the C
    accumulator): random taps at the realizable bound |w| < 32639, x with
    -32768, 0 and 32767 rows; and the served flagship's
    own permuted planes and bias over the wrap input's window (its exact
    accumulator passes 2^31)."""
    rng = np.random.default_rng(7)
    if case == "wrap":
        _, bspec, step = _port_step(FLAGSHIP)
        hist, x = launch_inputs(step, bspec.in_per_launch, 6, seed=1)
        row0, taps = fixed_inputs._wrap_window(step)
        planes, bias = step.w[0].numpy(), step.w[1].numpy()
        v0 = fixed_inputs.block_origins(step)
        k = int(np.flatnonzero(v0 >= step.hist_rows)[0])
        m, K = k % planes.shape[1], planes.shape[3]
        virt = np.concatenate([hist, x, np.zeros((K, 6), np.int16)])
        window = virt[v0[k]:v0[k] + K]                           # tap order
        w16 = ttf.fixed_taps16(step.w[0])[m].numpy().T           # [C, K]
        col = int(np.abs(w16).sum(axis=1).argmax())
        assert np.array_equal(w16[col, :taps.size], taps)
        exact = w16.astype(np.int64) @ window.astype(np.int64)   # [C, B]
        assert exact[col, 0] > 2 ** 31                           # wrap lane
        got = _kernel_sums(planes[0, m], planes[1, m], bias[m],
                           window[ttf.full_perm(K)])
    else:
        K, C, B = 96, 24, 16
        w16 = rng.integers(-32638, 32639, (C, K)).astype(np.int16)
        w16[0, :4] = (-32638, 32638, 0, -1)
        x = rng.integers(-32768, 32768, (K, B), dtype=np.int16)
        if case == "extremes":
            x[::3], x[1::3] = -32768, 32767
            x[2::5] = 0
            w16[1] = np.where(x[:, 0] < 0, -32638, 32638)
        wh, wl0, bias = tfm.balanced_q15_split(w16, tap_axis=1)
        exact = w16.astype(np.int64) @ x.astype(np.int64)
        assert np.abs(exact).max() > 2 ** 31
        got = _kernel_sums(wh, wl0, bias, x)
    assert np.array_equal(got, exact % U32)
    wrapped = ttf.wrap_int32(torch.from_numpy(exact)).numpy()
    assert np.array_equal(got.astype(np.uint32).view(np.int32), wrapped)


@pytest.mark.parametrize("cfg", [FLAGSHIP, SLICE, DIRECT, DIRECT_STREAMED],
                         ids=["tiled-44k1-48k-q7", "streamed-48k-44k1-q10",
                              "tiled-24k-48k-q5", "streamed-24k-48k-q5"])
def test_device_planes_map_back(cfg):
    """The step's planes int8[2, P, C, K_pad] are the balanced split of the
    int16 host weights (_fixed_host_weights) in permuted, zero-padded K
    order; the bias is 128 * sum w; the tap table is the fixed CTA's."""
    spec, bspec, step = _port_step(cfg)
    n_accum = step.kernel_kw["n_accum"]
    K = tb._tiled_weights(spec, 0).K
    K_host = K if cfg[4] == "tiled" else -(-K // 128) * 128
    host = tb._fixed_host_weights(spec, 0, K_host)
    w16 = host[0]
    P, _, C = w16.shape
    planes, bias, taps = step.w[0], step.w[1], step.w[-1]
    K_pad = planes.shape[3]
    assert planes.dtype == torch.int8 and planes.shape[:3] == (2, P, C)
    assert K_pad % 32 == 0 and K_host <= K_pad < K_host + 32
    assert planes.is_contiguous() and planes.data_ptr() % 16 == 0
    back = ttf.fixed_taps16(planes).numpy()
    assert np.array_equal(back[:, :K_host], w16)
    assert not back[:, K_host:].any()
    ends = [0, P - 1]                                  # first, last phase
    pl = planes.numpy()[:, ends]
    wh, wl0, _ = tfm.balanced_q15_split(back[ends], tap_axis=1)  # tap order
    j = 32 * (K_pad // 64) + 5                                 # a position
    t = 32 * (j // 32) + ttf.K_PERM[j % 32]
    assert np.array_equal(pl[0, :, :, j], wh[:, t, :])
    assert np.array_equal(pl[1, :, :, j], wl0[:, t, :])
    assert np.array_equal(bias.numpy(),
                          w16.sum(axis=1, dtype=np.int32) << 7)
    nonzero = (w16.reshape(P, K_host, n_accum, -1) != 0).any(axis=2)
    rows = ttf.FIXED_ROWS[n_accum]
    assert np.array_equal(taps.numpy(), ttf.tap_ranges(nonzero, rows))
    assert taps.shape == (P, bspec.R // rows, 2)
    if n_accum == 4:
        assert np.array_equal(step.w[2].numpy(), host[1])


# -- the kernel's B-tile staging and accumulator map, modelled -------------

KK, SUB, THREADS = 32, 2, 256          # int8tc::kK, kSub; fir::kThreads


def _fixed_shape(n_accum: int):
    """(kWgRows, kRows, kN) of fixedtc::Shape<n_accum>."""
    wg_rows = 16 if n_accum == 4 else 32
    return wg_rows, 2 * wg_rows, wg_rows * n_accum


def test_model_matches_the_header():
    """The expressions the staging model below mirrors, as the headers
    write them."""
    fixed = (CSRC / "fixed_wgmma.cuh").read_text()
    for line in ("kWgRows = kAccum == 4 ? 16 : 32;",
                 "kRows = 2 * kWgRows;", "kN = kWgRows * kAccum;",
                 "kPer = kAcc / kAccum;",
                 "const int set = (n % Sh::kN) / Sh::kWgRows;",
                 "const int row = row0 + (n / Sh::kN) * Sh::kWgRows + "
                 "n % Sh::kWgRows;",
                 "wdst[q] = (i / 2) % 2 * Sh::kTileBytes + "
                 "int8tc::core_offset(n, i % 2);",
                 "wt[q] = (i / 2) % 2 * kK + i % 2 * 16;",
                 # fir_tiles: the same rows, from the tile's first row
                 "const int row = (n / Sh::kN) * Sh::kWgRows + "
                 "n % Sh::kWgRows;",
                 "woff[q] = (set * g.R + row) * g.K + wt[q];",
                 "const uint32_t b = buf + j * Sh::kTileBytes + "
                 "h * (Sh::kN / 8) * 256;",
                 "const int lane = 16 * w + l / 4 + 8 * ((e / 2) % 2);",
                 "const int r = h * Sh::kWgRows + 8 * (e / 4) + "
                 "2 * (l % 4) + e % 2;",
                 "const int i = set * Sh::kPer + e;"):
        assert line in fixed, line
    int8 = (CSRC / "int8_wgmma.cuh").read_text()
    assert "return (n / 8) * 256 + c * 128 + (n % 8) * 16;" in int8
    assert "((uint64_t)(128 >> 4) << 16) |" in int8       # leading, K
    assert "((uint64_t)(256 >> 4) << 32)" in int8         # stride, N
    for n_accum in (1, 4):
        assert ttf.FIXED_ROWS[n_accum] == _fixed_shape(n_accum)[1]


def _core_offset(n, c):
    return (n // 8) * 256 + c * 128 + (n % 8) * 16


@pytest.mark.parametrize("n_accum", [1, 4])
def test_fragment_model_recovers_lane_row_set(n_accum):
    """One stage of the planes staged by every thread's copies, read back
    as each warpgroup's B tile through the descriptor's core-matrix
    layout (128 bytes between the two 16-tap halves, 256 between 8-row
    groups), multiplied by an x slice as wgmma does; every accumulator
    register, decoded as the epilogue decodes it (lane, CTA row, column
    set), holds that output's dot, and the two warpgroups cover the
    CTA's kRows x 64 lanes x n_accum sets once."""
    wg_rows, rows, N = _fixed_shape(n_accum)
    acc_regs = N // 2
    per = acc_regs // n_accum
    R, rt = 2 * rows, 1                        # the CTA's second row tile
    C, row0 = n_accum * R, rt * rows
    rng = np.random.default_rng(n_accum)
    planes = rng.integers(-128, 128, (2, C, KK * SUB), dtype=np.int64)
    tile_bytes = KK * 2 * N
    smem = np.full(2 * SUB * tile_bytes, 999, dtype=np.int64)
    for tid in range(THREADS):
        for q in range(2 * N * SUB * 2 // THREADS):
            i = tid + q * THREADS
            n = i // 4
            s = (n % N) // wg_rows
            row = row0 + (n // N) * wg_rows + n % wg_rows
            dst = (i // 2) % 2 * tile_bytes + _core_offset(n, i % 2)
            t = (i // 2) % 2 * KK + i % 2 * 16
            for p in range(2):
                off = p * SUB * tile_bytes + dst
                smem[off:off + 16] = planes[p, s * R + row, t:t + 16]
    assert (smem != 999).all()
    n_idx, k_idx = np.meshgrid(np.arange(N), np.arange(KK), indexing="ij")
    read = (n_idx // 8) * 256 + (k_idx // 16) * 128 + (n_idx % 8) * 16 \
        + k_idx % 16                                          # [N, KK]
    seen = set()
    for h in range(2):
        for j in range(SUB):
            for p in range(2):
                base = p * SUB * tile_bytes + j * tile_bytes + h * (N // 8) \
                    * 256
                Bt = smem[base + read]                        # [N, KK]
                A = rng.integers(-128, 128, (64, KK))         # lanes x K
                D = A @ Bt.T                                  # [64, N]
                for w in range(4):
                    for l in range(32):
                        for s in range(n_accum):
                            for e in range(per):
                                i = s * per + e
                                got = D[16 * w + l // 4 + 8 * ((i // 2) % 2),
                                        8 * (i // 4) + 2 * (l % 4) + i % 2]
                                lane = 16 * w + l // 4 + 8 * ((e // 2) % 2)
                                r = h * wg_rows + 8 * (e // 4) \
                                    + 2 * (l % 4) + e % 2
                                want = A[lane] @ planes[
                                    p, s * R + row0 + r,
                                    j * KK:(j + 1) * KK]
                                assert got == want, (h, j, p, w, l, s, e)
                                seen.add((lane, r, s))
    assert len(seen) == 64 * rows * n_accum


# -- plain versions against the JAX kernels ----------------------------------

@pytest.mark.parametrize("cfg,f0,B", [(FLAGSHIP, "flush", 130),
                                      (DIRECT, 1, 4),
                                      (DIRECT_STREAMED, 0, 130)],
                         ids=["tiled-n_accum4", "tiled-n_accum1",
                              "streamed-n_accum1"])
def test_plain_on_new_layout_equals_jax(cfg, f0, B):
    """The JAX step's v3 / v4 fixed kernel (interpret mode) against the
    port's plain version on the JAX step's weights carried across
    (weights_from_jax, the new layout), the wrap input on every third
    lane; f0 "flush": the phase a flush of 3368 staged frames leaves."""
    i, o, q, target, kernel = cfg
    g = math.gcd(i, o)
    js = jfd.design_filter(i // g, o // g, q, fixed_point=True)
    if f0 == "flush":
        m = tph.producible_outputs(3368, 0, 0, js.num, js.den)
        f0 = (m * js.num) % js.den
    spec, bspec, tstep = _port_step(cfg, f0)
    jspec = dataclasses.replace(
        jb._launch_geometry(js, target, use_pallas=True, f0=f0),
        kernel=kernel)
    jstep = jb.make_batched_step(js, jspec, use_pallas=True,
                                 pallas_interpret=True)
    hist, x = launch_inputs(tstep, bspec.in_per_launch, B, seed=B + f0)
    _, jy = jstep.fn(hist, x, jstep.w)
    w = tb.weights_from_jax(tuple(np.asarray(a) for a in jstep.w), "fixed",
                            device="cpu", kernel=kernel)
    ty = tsf.resample_streamed_reference(
        torch.from_numpy(hist), torch.from_numpy(x), w,
        **tstep.kernel_kw)[:bspec.out_per_launch]
    assert ty.shape == np.asarray(jy).shape
    assert int((ty.numpy() != np.asarray(jy)).sum()) == 0


def _random_fixed(P, K, R, n_accum, seed):
    """Random int16 taps [P, K, n_accum * R] at the realizable bound |w| <
    32639, zero outside a band per phase, and Q15 coefficients int32[P, 4,
    R]."""
    rng = np.random.default_rng(seed)
    w16 = rng.integers(-32638, 32639, (P, K, n_accum * R)).astype(np.int16)
    for m in range(P):
        w16[m, :16 + 40 * m] = 0
        w16[m, 16 + 40 * m + 150:] = 0
    coef = rng.integers(-32768, 32768, (P, 4, R)).astype(np.int32)
    return w16, coef


@pytest.mark.parametrize("B", [4, 130])
def test_plain_streamed_small_equals_jax_v4(B):
    """n_accum 4 at a small streamed shape (P = 2, R 128, K_pad 256, 4
    blocks 192 input rows apart, windows starting in the history), taps
    at the realizable bound, int16 extremes in x: the JAX v4 fixed kernel
    (interpret) and the port's plain version on weights_from_jax's
    planes, bit for bit."""
    P, K, R, n_blocks, H = 2, 256, 128, 4, 32
    w16, coef = _random_fixed(P, K, R, 4, seed=B)
    rng = np.random.default_rng(B + 1)
    hist = rng.integers(-32768, 32768, (H, B), dtype=np.int16)
    x = rng.integers(-32768, 32768, (832, B), dtype=np.int16)
    x[::7] = -32768
    x[3::11] = 32767
    kw = dict(n_blocks=n_blocks, shift=8, num=3, den=2, f0=1)
    planes, bias = jpf.fixed_weight_planes_tiled(w16)      # [2, P, C, K]
    jax_w = (np.ascontiguousarray(planes.transpose(1, 0, 2, 3)), bias, coef)
    jy = jpf.resample_conv_tm_pallas_v4(
        jnp.asarray(hist), jnp.asarray(x),
        tuple(jnp.asarray(a) for a in jax_w), interpret=True,
        scheme="fixed", n_accum=4, **kw)
    w = tb.weights_from_jax(jax_w, "fixed", device="cpu", kernel="streamed")
    ty = tsf.resample_streamed_reference(torch.from_numpy(hist),
                                         torch.from_numpy(x), w,
                                         scheme="fixed", n_accum=4, **kw)
    assert ty.shape == (n_blocks * R, B)
    assert np.array_equal(ty.numpy(), np.asarray(jy))


# -- weights carried across ----------------------------------------------------

@pytest.mark.parametrize("kernel,n_accum", [("tiled", 4), ("tiled", 1),
                                            ("streamed", 4),
                                            ("streamed", 1)])
def test_planes_from_jax_equal_port_planes(kernel, n_accum):
    """fixed_weight_planes_tiled's planes and bias (K = 200, not a
    multiple of 32; streamed: padded to 256 as the JAX package streams
    them, [P, 2, C, K_pad]) through weights_from_jax equal the port's own
    device weights of the same taps; undone (inverse permutation, the
    padding cut), the port's planes are JAX's and its bias is JAX's."""
    K = 200 if kernel == "tiled" else 256
    w16, coef = _random_fixed(3, K, 64, n_accum, seed=n_accum)
    if kernel == "streamed":
        w16[:, 200:] = 0
    planes, bias = jpf.fixed_weight_planes_tiled(w16)
    jax_planes = planes if kernel == "tiled" else \
        np.ascontiguousarray(planes.transpose(1, 0, 2, 3))
    jax_w = (jax_planes, bias) + ((coef,) if n_accum == 4 else ())
    got = tb.weights_from_jax(jax_w, "fixed", device="cpu", kernel=kernel)
    own = ttf.device_weights((w16,) + ((coef,) if n_accum == 4 else ()),
                             "fixed", "cpu")
    assert len(got) == len(own) == (5 if n_accum == 4 else 4)
    assert got[-2].slices == own[-2].slices
    for a, b in zip(got[:-2] + got[-1:], own[:-2] + own[-1:]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    K_pad = got[0].shape[3]
    inv = np.argsort(ttf.full_perm(K_pad))
    assert np.array_equal(got[0].numpy()[..., inv][..., :K], planes)
    assert not got[0].numpy()[..., inv][..., K:].any()
    assert np.array_equal(got[1].numpy(), bias)


# -- the wrappers' guards --------------------------------------------------------

def _guard_launch(kernel):
    """A launch of the fixed kernel (n_accum 4) on CPU tensors: the
    wrapper, its plain version, the device weights and its keywords."""
    if kernel == "tiled":
        _, bspec, step = _port_step(FLAGSHIP)
        hist, x = (torch.from_numpy(a) for a in
                   launch_inputs(step, bspec.in_per_launch, 3, seed=0))
        return (tsf.resample_streamed, tsf.resample_streamed_reference,
                hist, x, step.w, step.kernel_kw, tsf.launches)
    w16, coef = _random_fixed(2, 256, 64, 4, seed=3)
    w = ttf.device_weights((w16, coef), "fixed", "cpu")
    hist = torch.zeros((32, 4), dtype=torch.int16)
    x = torch.randint(-32768, 32768, (1024, 4), dtype=torch.int16)
    kw = dict(n_blocks=2, shift=8, num=3, den=2, f0=0, scheme="fixed",
              n_accum=4)
    return (tsf.resample_streamed, tsf.resample_streamed_reference, hist, x,
            w, kw, tsf.launches)


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    buf = torch.zeros(t.numel() + 1, dtype=t.dtype)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16
    return out


@pytest.mark.parametrize("fault", ["none", "planes-int16", "bias-float",
                                   "k-not-32", "misaligned", "coef-missing"])
@pytest.mark.parametrize("kernel", ["tiled", "streamed"])
def test_fixed_wrapper_guards(kernel, fault):
    """Wrong dtypes, a K not a multiple of 32, planes off a 16-byte
    boundary or a missing coefficient tensor raise before any launch;
    sound CPU tensors run the plain version and never launch."""
    launch, plain, hist, x, w, kw, launches = _guard_launch(kernel)
    before = dict(launches)
    if fault == "none":
        y = launch(hist, x, w, **kw)
        assert torch.equal(y, plain(hist, x, w, **kw))
        assert launches == before
        return
    planes, bias, coef, bands, taps = w
    bad, err = {
        "planes-int16": ((planes.to(torch.int16), bias, coef, bands, taps),
                         TypeError),
        "bias-float": ((planes, bias.float(), coef, bands, taps), TypeError),
        "k-not-32": ((planes[..., :planes.shape[3] - 16].contiguous(), bias,
                      coef, bands, taps), ValueError),
        "misaligned": ((_misaligned(planes), bias, coef, bands, taps),
                       ValueError),
        "coef-missing": ((planes, bias, bands, taps), ValueError),
    }[fault]
    with pytest.raises(err):
        launch(hist, x, bad, **kw)
    assert launches == before


@pytest.mark.parametrize("fault", ["short", "zero", "too-wide", "list",
                                   "missing"])
def test_fixed_bands_guard(fault):
    """The fixed weights carry their tap table's band widths
    (``tiled_fir.BandWidths``, made by ``fixed_device_weights``), and the
    wrapper and its plain version refuse weights without them or with
    widths that are not the table's: one entry a (phase, row tile) band,
    each in [1, K / 32]; the step's own pass."""
    launch, plain, hist, x, w, kw, launches = _guard_launch("tiled")
    bands = w[-2]
    assert type(bands) is ttf.BandWidths
    assert bands.slices == ttf.band_widths(w[-1].numpy()).slices
    assert bands.widest == max(bands.slices)
    assert torch.equal(launch(hist, x, w, **kw), plain(hist, x, w, **kw))
    K = w[0].shape[-1]
    bad = {"short": lambda: ttf.BandWidths(bands.slices[:-1]),
           "zero": lambda: ttf.BandWidths((0,) + bands.slices[1:]),
           "too-wide": lambda: ttf.BandWidths((K // 32 + 1,)
                                              + bands.slices[1:]),
           "list": lambda: list(bands.slices), "missing": None}[fault]
    for run in (launch, plain):
        with pytest.raises(ValueError, match="band|fixed weights"):
            run(hist, x, w[:-2] + ((bad(),) if bad else ()) + w[-1:], **kw)


# -- the persistent CTAs (fixedtc::fir_tiles) ---------------------------------

def test_fixed_counters_start_at_zero_and_reset():
    """The port's counters of the fixed launches' CTAs, tiles and band
    loads are 0 at import, and utils/launches.reset_launches() sets them
    back to 0 with the launch counts (a fresh process: nothing here
    launches)."""
    import subprocess
    import sys
    code = (
        "from speex_resampler_tpu_torch.ops import streamed_fir as sf\n"
        "from speex_resampler_tpu_torch.utils import launches as ul\n"
        "assert ul.fixed_counts() == (0, 0, 0, 0)\n"
        "sf.count_fixed(132, 18816, 708)\n"
        "assert ul.fixed_counts() == (1, 132, 18816, 708)\n"
        "sf.count_fixed(132, 17920)\n"
        "assert ul.fixed_counts() == (2, 264, 36736, 708)\n"
        "sf.launches['fixed'] = 1\n"
        "ul.reset_launches()\n"
        "assert ul.fixed_counts() == (0, 0, 0, 0)\n"
        "assert not hasattr(sf, 'fixed_ctas')\n"
        "assert sf.launches['fixed'] == 0\n")
    root = Path(__file__).resolve().parent.parent
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root,
                   timeout=120)


@pytest.mark.parametrize("cfg,instance", [
    (FLAGSHIP, "streamed_fir_fixed_kernel<4, true>"),
    (DIRECT, "streamed_fir_fixed_kernel<1, true>"),
    (DIRECT_STREAMED, "streamed_fir_fixed_kernel<1, true>"),
    (SLICE, "streamed_fir_fixed_kernel<4, false>")],
    ids=["tiled-q7", "tiled-q5", "streamed-q5", "streamed-q10"])
def test_fixed_instance_is_pinned(cfg, instance):
    """``utils/launches.fixed_instance`` names the template instance a
    fixed phase-tiled step launches (its CTA order by the planes' bytes,
    as ``csrc/streamed_fir.cu`` picks it: the q10 planes' 77 MB run lane
    tiles fastest), and ``chip_smoke.py`` finds it: in its SASS list
    (IGMMA), its IGMMA pins (16 at n_accum 4, whose kernel holds both
    walks; 8 at n_accum 1) and its spill-free kernels; the step's kernel
    name is the instance's function and n_accum."""
    import chip_smoke as cs
    from speex_resampler_tpu_torch.utils import launches as ul
    _, _, step = _port_step(cfg)
    assert ul.fixed_instance(step) == instance
    assert ul.step_kernel(step)[1] == instance.split(",")[0] + ">"
    assert (instance, "IGMMA") in cs.sass_kernels()
    # n_accum 4's persistent kernel holds both walks, 8 IGMMA each
    assert cs.IGMMA_PINNED[instance] == (16 if "<4" in instance else 8)
    assert instance in cs.SPILL_FREE
    src = (CSRC / "streamed_fir.cu").read_text()
    assert f"kBlockMajorBytes = {ul.BLOCK_MAJOR_BYTES >> 20}ll << 20;" in src


def test_fixed_instance_refuses_other_steps():
    from speex_resampler_tpu_torch.utils import launches as ul
    spec = tfd.design_filter(147, 160, 7)
    step = tb.make_batched_step(spec, tb._launch_geometry(spec, 2352),
                                device="cpu")
    with pytest.raises(ValueError):
        ul.fixed_instance(step)


def _persistent_walk(stages: list, n_ctas: int, lead: int):
    """A model of one persistent CTA set (``fir_tiles``): CTA c walks items
    c, c + n_ctas, ... (``stages[item]`` stages each, at least 1), its
    copy cursor kLead stages ahead, one group a stage, kLead + 1 epilogue
    slots.  Returns, per CTA, the events in order: ("copy", item, stage,
    slot) where the cursor copies a stage (entering a tile at stage 0
    writes its epilogue slot), ("walk", item, stage) and ("epilogue",
    item, slot), the tile's epilogue reading its slot."""
    slots = lead + 1
    out = []
    for c in range(n_ctas):
        items = list(range(c, len(stages), n_ctas))
        seq = [(it, s, t % slots) for t, it in enumerate(items)
               for s in range(stages[it])]
        events, cursor = [], 0

        def copy_next():
            nonlocal cursor
            if cursor < len(seq):
                events.append(("copy",) + seq[cursor])
            cursor += 1

        for _ in range(lead):
            copy_next()
        q = 0
        for t, it in enumerate(items):
            for s in range(stages[it]):
                assert seq[q][:2] == (it, s)
                events.append(("walk", it, s))
                copy_next()
                q += 1
            events.append(("epilogue", it, t % slots))
        out.append(events)
    return out


@pytest.mark.parametrize("cfg", [SLICE, FLAGSHIP, DIRECT],
                         ids=["q10", "q7", "q5"])
@pytest.mark.parametrize("n_ctas", [132, 5, 1])
def test_persistent_walk_model(cfg, n_ctas):
    """The persistent CTAs' streamed walk on a step's tap table (at B =
    130, 3 lane tiles, lane tiles fastest): every tile is walked once, by
    one CTA; every stage is copied before it is walked and at most kLead
    = 6 ahead; a tile's epilogue slot is written (its first stage's copy)
    before the tile's walk and not again until that tile's epilogue has
    read it; and the header keeps the constants the model assumes."""
    fixed = (CSRC / "fixed_wgmma.cuh").read_text()
    for line in ("static constexpr int kTileLead = 6;",
                 "constexpr int kSlots = kLead + 1;",
                 "c_slices = n_hi > c_t ? (n_hi - c_t + kK - 1) / kK : 1;",
                 "int first = blockIdx.x, last = n_items;",
                 "const int stride = kResident ? 1 : n_ctas;",
                 "for (int item = first; item < last; item += stride) {"):
        assert line in fixed, line
    lead = 6
    _, bspec, step = _port_step(cfg)
    taps = step.w[-1].numpy().astype(np.int64)
    lo, hi = taps[..., 0] // 32 * 32, taps[..., 1]
    slices = np.where(hi > lo, -(-(hi - lo) // 32), 1)          # [P, rt]
    n_blocks, lanes = step.kernel_kw["n_blocks"], 3
    P, row_tiles = slices.shape
    stages = [int(-(-slices[(kr // row_tiles) % P, kr % row_tiles] // 2))
              for kr in range(n_blocks * row_tiles) for _ in range(lanes)]
    walked = []
    for events in _persistent_walk(stages, n_ctas, lead):
        copied, slot_free = {}, {}
        for i, ev in enumerate(events):
            if ev[0] == "copy":
                _, it, s, slot = ev
                copied[(it, s)] = i
                if s == 0:          # the epilogue slot is written
                    assert slot_free.get(slot, True), (it, slot)
                    slot_free[slot] = False
            elif ev[0] == "walk":
                _, it, s = ev
                assert (it, s) in copied
                ahead = sum(1 for e in events[copied[(it, s)]:i]
                            if e[0] == "walk")
                assert ahead <= lead
                walked.append((it, s))
            else:
                slot_free[ev[2]] = True
    assert sorted(walked) == sorted((it, s) for it, n in enumerate(stages)
                                    for s in range(n))


def _resident_walk(stages: list, bands: list, runs: list, lead: int):
    """A model of the persistent CTAs' resident walk (``fir_tiles`` with a
    band buffer cap): CTA c walks the items of its run ``runs[c]`` in
    order (``stages[item]`` x stages each, its band ``bands[item]``), its
    copy cursor kLead stages ahead, one group a stage; where the cursor
    enters an item of another band than its last it loads that band into
    the next of two band buffers, in the group of the item's first stage.
    Returns, per CTA, the events in order: ("band", band, buffer),
    ("copy", item, stage, buffer), ("walk", item, stage) and ("epilogue",
    item)."""
    out = []
    for first, last in runs:
        items = list(range(first, last))
        seq = [(it, s) for it in items for s in range(stages[it])]
        events, cursor = [], 0
        state = {"band": None, "buf": 1}

        def copy_next():
            nonlocal cursor
            if cursor < len(seq):
                it, s = seq[cursor]
                if s == 0 and bands[it] != state["band"]:
                    state["band"], state["buf"] = bands[it], state["buf"] ^ 1
                    events.append(("band", bands[it], state["buf"]))
                events.append(("copy", it, s, state["buf"]))
            cursor += 1

        for _ in range(lead):
            copy_next()
        for it in items:
            for s in range(stages[it]):
                events.append(("walk", it, s))
                copy_next()
            events.append(("epilogue", it))
        out.append(events)
    return out


@pytest.mark.parametrize("cfg,B", [(SLICE, 2048), (FLAGSHIP, 2048),
                                   (FLAGSHIP, 130), (DIRECT, 2048)],
                         ids=["q10", "q7", "q7-B130", "q5"])
@pytest.mark.parametrize("n_ctas", [132, 5, 1])
def test_resident_walk_model(cfg, B, n_ctas):
    """The persistent CTAs' resident walk on a step's tap table, items in
    band-major order ((phase, row tile), then the blocks of the phase,
    then the lane tiles), a contiguous run a CTA (``streamed_fir.
    resident_runs``, balanced by K-slices): every tile is walked once; every
    x stage is copied before it is walked and at most kLead = 6 ahead; a
    band is loaded before its first tile's walk, reloaded only where
    (phase, row tile) changes, and never into the buffer a tile not yet
    through its epilogue reads; the band loads equal ``streamed_fir.
    resident_bands``, which the wrapper counts; and the header and the
    launcher keep what the model assumes."""
    fixed = (CSRC / "fixed_wgmma.cuh").read_text()
    for line in ("static constexpr int kTileLead = 6;",
                 "const int per_band = n_kr / row_tiles / g.P * lane_tiles;",
                 "balanced_run(g, row_tiles, per_band, out, first, last);",
                 "const int b = item / per_band, r = item - b * per_band;",
                 "k = m + g.P * j;",
                 "const bool enters = m * row_tiles + rt != c_band;",
                 "c_buf ^= 1;",
                 "if (c_slices > band_cap) __trap();",
                 "c_item += stride;"):
        assert line in fixed, line
    launcher = (CSRC / "streamed_fir.cu").read_text()
    for line in ("n_blocks / P * ((B + fir::int8tc::kLanes - 1) / "
                 "fir::int8tc::kLanes);",
                 "per_band >= Shape::kTileLead &&",
                 "*band_tiles = resident_band_tiles<kAccum>(slices, "
                 "n_blocks, g.P, g.B);"):
        assert line in launcher, line
    lead = 6
    _, bspec, step = _port_step(cfg)
    taps = step.w[-1].numpy().astype(np.int64)
    lo, hi = taps[..., 0] // 32 * 32, taps[..., 1]
    slices = np.where(hi > lo, -(-(hi - lo) // 32), 1)          # [P, rt]
    widths = step.w[-2]
    assert widths.slices == tuple(slices.reshape(-1).tolist())
    n_blocks, lanes = step.kernel_kw["n_blocks"], -(-B // 64)
    P, row_tiles = slices.shape
    per_band = n_blocks // P * lanes
    n_items = n_blocks * row_tiles * lanes
    bands = [i // per_band for i in range(n_items)]
    stages = [int(-(-slices[divmod(b, row_tiles)] // 2)) for b in bands]
    ctas = min(n_items, n_ctas)
    runs = tsf.resident_runs(widths, per_band, ctas)
    loads, walked = 0, []
    for events in _resident_walk(stages, bands, runs, lead):
        copied, held, readers, last_band = {}, {}, {}, None
        for i, ev in enumerate(events):
            if ev[0] == "band":
                _, b, buf = ev
                assert b != last_band
                if per_band >= lead:    # the launcher's condition
                    assert not readers.get(buf), (b, readers[buf])
                held[buf], readers[buf], last_band = b, set(), b
                loads += 1
            elif ev[0] == "copy":
                _, it, s, buf = ev
                assert held[buf] == bands[it]
                copied[(it, s)] = (i, buf)
            elif ev[0] == "walk":
                _, it, s = ev
                at, buf = copied[(it, s)]
                assert sum(1 for e in events[at:i] if e[0] == "walk") <= lead
                if per_band >= lead:
                    assert held[buf] == bands[it]
                readers[buf].add(it)
                walked.append((it, s))
            else:
                for r in readers.values():
                    r.discard(ev[1])
    assert sorted(walked) == sorted((it, s) for it, n in enumerate(stages)
                                    for s in range(n))
    assert loads == tsf.resident_bands(widths, per_band, ctas)
    assert n_items == tsf.fixed_tiles(n_blocks, bspec.R, B,
                                      step.kernel_kw["n_accum"])
    # the runs balance: a CTA's K-slices within a tile's of the mean
    work = [sum(widths.slices[i // per_band] for i in range(*r))
            for r in runs]
    assert max(work) - min(work) <= 2 * widths.widest


@pytest.mark.parametrize("bands,band_tiles,ctas,want", [
    ((5,) * 80, 224, 132, 208), ((9,) * 588, 32, 132, 708),
    ((9,) * 588, 0, 132, 0), ((1, 3), 2, 2, 3), ((4,) * 20, 4, 1, 20),
    ((2, 2, 2), 7, 2, 4)])
def test_fixed_bands_counts_each_ctas_bands(bands, band_tiles, ctas, want):
    """``streamed_fir.resident_bands``: the bands each CTA's balanced run
    meets, summed (bands of one width: the runs of n_items / ctas tiles;
    ``(1, 3)``, two tiles a band, on two CTAs: runs [0, 3) and [3, 4), 2
    and 1 bands); 0 on the streamed walk."""
    assert tsf.resident_bands(ttf.BandWidths(bands), band_tiles, ctas) == want


@pytest.mark.parametrize("seed", range(6))
def test_fixed_runs_are_the_balanced_split(seed):
    """``streamed_fir.resident_runs`` (the kernel's ``balanced_run``): CTA c's
    run starts at the first tile whose work before it reaches c W / G,
    tiles in band-major order weighing their band's K-slices, by brute
    force; the runs are contiguous and cover every tile."""
    rng = np.random.default_rng(seed)
    bands = tuple(int(v) for v in rng.integers(1, 10, rng.integers(1, 40)))
    band_tiles = int(rng.integers(1, 12))
    n = len(bands) * band_tiles
    ctas = int(rng.integers(1, n + 1))
    weights = [bands[i // band_tiles] for i in range(n)]
    before = np.concatenate([[0], np.cumsum(weights)])
    work = int(before[-1])
    want = [int(np.argmax(before >= c * work // ctas)) if c < ctas else n
            for c in range(ctas + 1)]
    runs = tsf.resident_runs(ttf.BandWidths(bands), band_tiles, ctas)
    assert runs == list(zip(want, want[1:]))
    assert runs[0][0] == 0 and runs[-1][1] == n


@pytest.mark.parametrize("B,n_ctas", [(130, 5), (64, 1), (3, 2)])
def test_fixed_walk_witness_plain_version(B, n_ctas):
    """``probes.fixed_walk`` (the served resident walk with a witness that
    records each CTA's run of tiles and its band loads; the GPU tests read
    it on the card) on CPU tensors: the plain launch's output and the
    host's record, each CTA's run of ``streamed_fir.resident_runs``, together
    every tile once, and its band loads, which add up to ``resident_bands``.
    The served walk tells its witness its run once ``balanced_run`` has
    set it and each band the copy cursor enters, and the probe builds the
    served walk's resident instance."""
    from speex_resampler_tpu_torch.ops import _build
    from speex_resampler_tpu_torch.probes import fixed_walk
    fixed = (CSRC / "fixed_wgmma.cuh").read_text()
    for line in ("    balanced_run(g, row_tiles, per_band, out, first, last);\n"
                 "    witness.run(first, last);\n",
                 "        c_buf ^= 1;\n        witness.band();\n",
                 "struct NoWitness {"):
        assert line in fixed, line
    probe = (CSRC / "probes" / "fixed_walk.cu").read_text()
    assert "fir::fixedtc::fir_tiles<4, false, true>(" in probe
    assert "probes/fixed_walk.cu" in _build._PROBE_SOURCE_NAMES
    _, bspec, step = _port_step(FLAGSHIP)
    kw = step.kernel_kw
    hist, x = (torch.from_numpy(a) for a in
               launch_inputs(step, bspec.in_per_launch, B, seed=B))
    geo = {k: kw[k] for k in ("n_blocks", "shift", "num", "den", "f0")}
    y, record = fixed_walk.walk(hist, x, step.w, ctas=n_ctas, **geo)
    assert torch.equal(y, tsf.resample_streamed_reference(hist, x, step.w,
                                                          **kw))
    per_band = kw["n_blocks"] // bspec.P * -(-B // 64)
    runs = tsf.resident_runs(step.w[-2], per_band, n_ctas)
    assert record.dtype == torch.int32 and record.shape == (n_ctas, 3)
    assert [tuple(r[:2]) for r in record.tolist()] == runs
    assert runs[0][0] == 0 and runs[-1][1] == tsf.fixed_tiles(
        kw["n_blocks"], bspec.R, B, 4)
    assert int(record[:, 2].sum()) == tsf.resident_bands(step.w[-2], per_band,
                                                      n_ctas)
    with pytest.raises(ValueError):
        fixed_walk.walk(hist, x, step.w, ctas=0, **geo)
