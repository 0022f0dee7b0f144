"""The gather launch's band and stream forms on the CPU: their plans, their
weights and NumPy models of the band and stream kernels' walks.

The band kernels (``csrc/gather_fir.cu``: ``gather_fir_fixed_band_kernel``
on the int8 tensor cores, ``gather_fir_f64mma_kernel`` on the FP64 ones)
cannot run here.  What they read can:

- ``gather_band``'s fixed planes, un-permuted, recompose each output's
  int16 tap rows at its offset from its group's first start, zeros
  elsewhere, and the bias is 128 * sum of each column; the float band holds
  the f32 taps exactly, as float64;
- a NumPy model of the walk (the kernels' groups or 16-output tiles, each
  from its own K origin starts[o0], K taps wide; the fixed one's permuted
  K positions, split x digits and bias; the float one's staged rows)
  equals the plain versions: float, fixed interpolated, fixed direct on
  synthetic dense-band starts, a last group that is not full, and hist
  apart from x;
- ``gather_plan`` takes the band form wherever it fits (drift 44100 ->
  44101 q7 and q0, its plans as before) and the stream form at the steep
  96000 -> 401 q3 (its band too wide to be resident; f32 samples: the
  rows form);
- the stream form (``gather_fir_f64mma_stream_kernel``,
  ``gather_fir_fixed_stream_kernel``): every output's window inside its
  tile's K taps, K a whole number of stages and every split of them
  covering K; its band (f32, or the band form's planes at 16 or 32
  outputs a group) holds the taps at their offsets; a NumPy model of its
  walk (tiles from their own K origins, K split into partial sums added
  in split order) equals the plain versions; its shared memory formula
  uses the source's constants;
- the wrappers run the plain version for CPU tensors whatever the plan,
  the launch counts hold one key a kernel, and a step's band counts in
  its weight bytes.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from speex_resampler_tpu_torch.ops import filter_design as tfd
from speex_resampler_tpu_torch.ops import fir_matmul as tfm
from speex_resampler_tpu_torch.ops import tiled_fir as ttf
from speex_resampler_tpu_torch.ops.fixed_math import (fixed_interp_mix_rows,
                                                      sat32pshr15)
from speex_resampler_tpu_torch.parallel import batch as tb

from fixed_inputs import launch_inputs

torch.set_num_threads(1)

CSRC = Path(tfm.__file__).resolve().parent.parent / "csrc"
DRIFT = (44100, 44101, 7)
N_OUT = 300   # 9 groups of 32 + 12, 4 of 64 + 44, 18 tiles of 16 + 12
STEEP = (96000, 401, 3)
N_STEEP = 40  # 2 tiles of 16 + 8, 1 group of 32 + 8


def _step(cfg, fixed):
    i, o, q = cfg
    g = math.gcd(i, o)
    spec = tfd.design_filter(i // g, o // g, q, fixed_point=fixed)
    bspec = tb._launch_geometry(spec, 44100)
    step = tb.make_batched_step(spec, bspec, device="cpu")
    assert step.kernel == "gather"
    return spec, bspec, step


def _n_accum(taps, fixed):
    return (4 if taps.ndim == 3 else 1) if fixed else None


def _drift(fixed, n=N_OUT):
    """The drift launch's first n outputs: (taps, starts, coef or None),
    its inputs (hist, x) with the wrap input on every third lane (fixed)
    and the step."""
    spec, bspec, step = _step(DRIFT, fixed)
    hist, x = launch_inputs(step, bspec.in_per_launch, 6, seed=3,
                            wrap=fixed)
    taps, starts = step.w[0][:n].numpy(), step.w[1][:n].numpy()
    coef = step.w[2][:n].numpy() if len(step.w) == 3 else None
    return taps, starts, coef, hist, x[:bspec.in_per_launch]


def _axis_rows(hist, x, rows):
    """Rows ``rows`` of the axis hist ++ x ([T, B], read apart as the
    kernels do), zeros past its end."""
    H, T = hist.shape[0], hist.shape[0] + x.shape[0]
    out = np.zeros((len(rows), x.shape[1]), dtype=x.dtype)
    for i, v in enumerate(rows):
        if v < H:
            out[i] = hist[v]
        elif v < T:
            out[i] = x[v - H]
    return out


def _band_model(hist, x, taps, starts, plan, band, coef=None):
    """NumPy model of the band kernels; returns [batch, n_out] like the
    wrappers.  Fixed: group g (plan.outputs outputs) reads K positions k of
    the axis rows starts[o0] + full_perm(K)[k] (the fragment's permuted tap
    order), x split into xh = x >> 8 and xl = (x & 255) - 128, four int8
    dots a column plus the bias, mod 2^32, then the Q15 epilogue.  Float:
    16-output tile t reads rows starts[16t] + k, k < K, from its CTA's
    staged window (plan.rows rows from the CTA's first start), exact
    float64 products summed, rounded once to f32."""
    fixed = taps.dtype == np.int16
    n_out, K = len(starts), plan.taps
    s = starts.astype(np.int64)
    if not fixed:
        w = band.w.numpy()
        y = np.zeros((n_out, x.shape[1]), dtype=np.float64)
        for o0 in range(0, n_out, 64):           # a CTA's staged window
            base = s[o0]
            win = _axis_rows(hist, x, base + np.arange(plan.rows))
            for t0 in range(o0, min(o0 + 64, n_out), 16):
                d = s[t0] - base
                assert d + K <= plan.rows
                t1 = min(t0 + 16, n_out)
                y[t0:t1] = w[t0:t1] @ win[d:d + K].astype(np.float64)
        return torch.from_numpy(y.astype(np.float32)).t()
    planes = band.w.numpy().astype(np.int64)      # [2, groups, C, K]
    bias = band.bias.numpy().astype(np.int64)     # [groups, C]
    G = plan.outputs
    n_acc = planes.shape[2] // G
    perm = ttf.full_perm(K)
    acc = np.zeros((n_out, n_acc, x.shape[1]), dtype=np.int64)
    for g in range(-(-n_out // G)):
        o0 = g * G
        xv = _axis_rows(hist, x, s[o0] + perm).astype(np.int64)
        xh, xl = xv >> 8, (xv & 255) - 128
        wh, wl = planes[0, g], planes[1, g]
        a = (65536 * (wh @ xh) + 256 * (wh @ xl + wl @ xh) + wl @ xl
             + bias[g][:, None])                         # [C, B]
        a = a.reshape(n_acc, G, -1).transpose(1, 0, 2)   # [G, c, B]
        n = min(G, n_out - o0)
        acc[o0:o0 + n] = a[:n]
    a = torch.from_numpy(((acc + 2 ** 31) % 2 ** 32 - 2 ** 31)
                         .astype(np.int32))
    if n_acc == 1:
        return sat32pshr15(a[:, 0]).t()
    return fixed_interp_mix_rows(a[:, :, None, :],
                                 torch.from_numpy(coef)[:, :, None])[:, 0].t()


# -- the band's weights ------------------------------------------------------

@pytest.mark.parametrize("n_accum", [4, 1], ids=["interp", "direct"])
def test_fixed_band_planes_recompose_the_taps(n_accum):
    """planes int8[2, groups, n_accum * G, K], un-permuted, give back each
    output's tap rows at columns starts[o] - starts[o0] .. + N - 1 of its
    set's column, zeros elsewhere (and in the last group's missing
    outputs); the bias is 128 * sum of each column."""
    taps, starts, _, _, _ = _drift(True)
    if n_accum == 1:
        taps = np.ascontiguousarray(taps[:, 0])
    N = taps.shape[-1]
    plan = tfm.gather_plan_band(starts, N, n_accum=n_accum)
    G, K = plan.outputs, plan.taps
    assert (plan.form, G, K % 32) == ("band", {4: 32, 1: 64}[n_accum], 0)
    band = tfm.gather_band(torch.from_numpy(taps), torch.from_numpy(starts),
                           plan)
    groups = -(-N_OUT // G)
    assert tuple(band.w.shape) == (2, groups, n_accum * G, K)
    assert band.w.dtype == torch.int8 and band.bias.dtype == torch.int32
    w16 = ttf.fixed_taps16(band.w).numpy()             # [groups, K, C]
    want = np.zeros((groups, K, n_accum, G), dtype=np.int16)
    t3 = taps.reshape(N_OUT, n_accum, N)
    for o in range(N_OUT):
        g, j = divmod(o, G)
        d = starts[o] - starts[g * G]
        want[g, d:d + N, :, j] = t3[o].T
    assert np.array_equal(w16, want.reshape(groups, K, n_accum * G))
    assert np.array_equal(band.bias.numpy(),
                          w16.astype(np.int32).sum(1) << 7)


def test_float_band_holds_the_f32_taps():
    """band float64[ceil(n_out / 16) * 16, K]: row o holds the f32 taps of
    output o exactly from column starts[o] - starts[o - o % 16], zeros
    elsewhere and in the rows past n_out."""
    taps, starts, _, _, _ = _drift(False)
    N = taps.shape[-1]
    plan = tfm.gather_plan_band(starts, N)
    assert (plan.form, plan.outputs, plan.taps % 8) == ("band", 64, 0)
    band = tfm.gather_band(taps, starts, plan)
    w = band.w.numpy()
    assert band.bias is None and w.dtype == np.float64
    assert w.shape == (-(-N_OUT // 16) * 16, plan.taps)
    want = np.zeros_like(w)
    for o in range(N_OUT):
        d = starts[o] - starts[o // 16 * 16]
        want[o, d:d + N] = taps[o]
    assert np.array_equal(w, want)
    assert np.array_equal(w[:N_OUT].astype(np.float32).astype(np.float64),
                          w[:N_OUT])


def test_gather_band_refuses_a_rows_plan_and_a_short_band():
    taps, starts, _, _, _ = _drift(False)
    with pytest.raises(ValueError, match="no band"):
        tfm.gather_band(taps, starts, tfm.gather_plan_rows(starts, 128))
    plan = tfm.gather_plan_band(starts, 128)
    with pytest.raises(ValueError, match="past the band"):
        tfm.gather_band(taps, starts, plan._replace(taps=plan.taps - 8))


# -- the walk ----------------------------------------------------------------

@pytest.mark.parametrize("case", ["float", "fixed-interp", "fixed-direct",
                                  "float-one-operand"])
def test_band_walk_model_equals_plain(case):
    """The band kernels' walk over the drift launch's first 300 outputs
    (the last group not full), hist read apart from x, equals the plain
    version on the concatenated axis: fixed bit for bit with the wrap
    input on every third lane (interpolated, and a direct filter, one
    accumulator row, on synthetic dense-band starts: outputs 0-2 rows
    apart); float equal after the f32 rounding (float64 sums of exact
    products, in another order); "float-one-operand" with no hist."""
    fixed = case.startswith("fixed")
    taps, starts, coef, hist, x = _drift(fixed)
    if case == "fixed-direct":
        taps, coef = np.ascontiguousarray(taps[:, 1]), None
        rng = np.random.default_rng(8)
        starts = (starts[0] + np.cumsum(rng.integers(0, 3, N_OUT))
                  ).astype(np.int32)
        assert starts[-1] + taps.shape[-1] <= hist.shape[0] + x.shape[0]
    if case == "float-one-operand":
        x = np.concatenate([hist, x])
        hist = x[:0]
    plan = tfm.gather_plan_band(starts, taps.shape[-1],
                                n_accum=_n_accum(taps, fixed))
    band = tfm.gather_band(taps, starts, plan)
    X = torch.from_numpy(np.concatenate([hist, x])).t()
    T, S = torch.from_numpy(taps), torch.from_numpy(starts)
    got = _band_model(hist, x, taps, starts, plan, band, coef)
    if fixed:
        want = tfm.resample_gather_fixed_reference(
            X, T, S, None if coef is None else torch.from_numpy(coef))
    else:
        want = tfm.resample_gather_reference(X, T, S, raw=True)
    assert torch.equal(got, want)


# -- the plan ----------------------------------------------------------------

@pytest.mark.parametrize("fixed", [False, True], ids=["float", "fixed"])
def test_gather_plan_picks_the_form(fixed):
    """The band form wherever its band fits a CTA, the plan a CUDA step is
    built with (the same rule for every lane count and density): at drift
    q7 and at q0, the drift's sparsest band (N 8: density N / K 0.33
    float, 0.125 fixed), the same plans as before the stream form; the
    stream form at the steep 96000 -> 401 q3, whose band is too wide to be
    resident (16 outputs a tile, K 15104), the float rows form there for
    f32 samples."""
    for cfg, K in ((DRIFT, 144 if not fixed else 160),
                   ((44100, 44101, 0), 24 if not fixed else 64)):
        spec, _, step = _step(cfg, fixed)
        taps, starts = step.w[0], step.w[1].numpy()
        n_accum, N = _n_accum(taps, fixed), spec.filt_len
        plan = tfm.gather_plan(starts, N, n_accum=n_accum)
        assert plan == tfm.gather_plan_band(starts, N, n_accum=n_accum)
        assert plan.form == "band" and plan.taps == K
    spec, _, step = _step(STEEP, fixed)
    starts, N = step.w[1].numpy(), spec.filt_len
    n_accum = _n_accum(step.w[0], fixed)
    assert tfm.gather_plan_band(starts, N, n_accum=n_accum) is None
    plan = tfm.gather_plan(starts, N, n_accum=n_accum)
    assert plan == tfm.gather_plan_stream(starts, N, n_accum=n_accum)
    assert (plan.form, plan.outputs, plan.taps) == ("stream", 16, 15104)
    if not fixed:   # f32 samples (the single-stream route's): rows
        assert tfm.gather_plan_rows(starts, N).outputs == 8
        assert tfm.gather_plan(starts, N, x_itemsize=4).form == "rows"


def test_band_shared_memory_matches_the_source():
    """The host's band shared-memory formula and ceiling use the kernels'
    constants (``csrc/gather_fir.cu``, ``int8_wgmma.cuh``,
    ``fixed_wgmma.cuh``): a fixed CTA's planes, two rings of four 64-tap
    x stages and two output tiles of G / 2 rows, 144-byte rows; a float
    CTA's four 16-output bands at K + 4 doubles a row and two 72-element
    x windows."""
    src = (CSRC / "gather_fir.cu").read_text()
    i8 = (CSRC / "int8_wgmma.cuh").read_text()
    assert "constexpr int kMaxSmem = 232448;" in i8
    assert tfm.GATHER_BAND_SMEM_BYTES == 232448
    assert "constexpr int kRing = 4;" in i8
    assert "kRawPitch = kLanes * 2 + 16" in i8
    assert "kF64Pitch = kLanes + 8;" in src
    assert re.search(r"kF64Outputs \* \(K \+ 4\) \* 8 \+ 2 \* rows \* "
                     r"kF64Pitch \* x_bytes", src)
    assert tfm._band_smem(None, 2, 144, 192) == 64 * 148 * 8 + 2 * 192 * 144
    # kAccum 4: G 32, two planes of 128 columns; 2 x (4 x 9216 + 16 x 144)
    assert tfm._band_smem(4, 2, 160, 0) == (2 * 160 * 128
                                            + 2 * (4 * 9216 + 16 * 144) + 128)
    assert tfm._band_smem(1, 2, 160, 0) == (2 * 160 * 64
                                            + 2 * (4 * 9216 + 32 * 144) + 128)


# -- the wrappers and the step -----------------------------------------------

@pytest.mark.parametrize("fixed", [False, True], ids=["float", "fixed"])
def test_cpu_wrappers_take_the_plain_version_whatever_the_plan(fixed):
    """CPU tensors run the plain version with a band plan and its band (no
    launch counted under any key), equal to it without them."""
    taps, starts, coef, hist, x = _drift(fixed)
    n_accum = _n_accum(taps, fixed)
    plan = tfm.gather_plan_band(starts, taps.shape[-1], n_accum=n_accum)
    band = tfm.gather_band(taps, starts, plan)
    w = [torch.from_numpy(a) for a in (taps, starts)
         + (() if coef is None else (coef,))]
    fn = tfm.resample_gather_fixed if fixed else tfm.resample_gather
    before = dict(tfm.launches)
    got = fn(torch.from_numpy(x).t(), *w, hist=torch.from_numpy(hist).t(),
             plan=plan, band=band)
    assert tfm.launches == before
    assert torch.equal(got, fn(torch.from_numpy(np.concatenate([hist, x])).t(),
                               *w))


def test_launch_counts_hold_one_key_a_kernel():
    """``fm.launches`` holds one count a gather kernel, each launch counted
    once: the float rows form's under its scheme, the band and stream
    forms' under ``launch_key`` (the fixed gather has no rows form, so no
    "fixed" key)."""
    keys = [tfm.launch_key("highest", "rows")] + [
        tfm.launch_key(s, f) for s in ("highest", "fixed")
        for f in ("band", "stream")]
    assert sorted(tfm.launches) == sorted(keys) and len(set(keys)) == 5
    assert "fixed" not in tfm.launches
    assert (tfm.launch_key("highest", "rows"),
            tfm.launch_key("fixed", "band"),
            tfm.launch_key("highest", "stream")) == (
        "highest", "fixed_band", "highest_stream")


def test_step_weight_bytes_count_the_band():
    """A step's weight bytes (the step cache's budget) count the band its
    launch takes beside its weights."""
    _, _, step = _step(DRIFT, True)
    assert step.kernel_kw == {"plan": None, "band": None}
    base = tb._step_weight_bytes(step)
    assert base == sum(t.numel() * t.element_size() for t in step.w)
    starts = step.w[1].numpy()
    plan = tfm.gather_plan_band(starts, 128, n_accum=4)
    band = tfm.gather_band(step.w[0], starts, plan)
    banded = tb.BatchedStep(fn=step.fn, w=step.w, hist_rows=step.hist_rows,
                            chunk_rows=step.chunk_rows, zero_tail=0,
                            scheme=step.scheme,
                            kernel_kw=dict(plan=plan, band=band),
                            kernel="gather")
    assert tb._step_weight_bytes(banded) == (
        base + band.w.numel() + band.bias.numel() * 4)


# -- the stream form ---------------------------------------------------------

def _steep(fixed, n=N_STEEP, B=3):
    """The steep launch's first n outputs: (taps, starts, coef or None),
    its inputs (hist, x) on B lanes (plain random samples: these taps
    cannot drive a sum past 2^31)."""
    spec, bspec, step = _step(STEEP, fixed)
    hist, x = launch_inputs(step, bspec.in_per_launch, B, seed=5,
                            wrap=False)
    taps, starts = step.w[0][:n].numpy(), step.w[1][:n].numpy()
    coef = step.w[2][:n].numpy() if len(step.w) == 3 else None
    return taps, starts, coef, hist, x[:bspec.in_per_launch]


def _splits(n_st, split):
    """The stage ranges of a K split over ``split`` CTAs, as the stream
    kernels take them: [s * n_st // split, (s + 1) * n_st // split)."""
    return [(s * n_st // split, (s + 1) * n_st // split)
            for s in range(split)]


def _stream_model(hist, x, taps, starts, plan, band, coef=None, split=1):
    """NumPy model of the stream kernels; returns [batch, n_out] like the
    wrappers.  Tile t (plan.outputs outputs from o0) reads the axis rows
    starts[o0] + k, k < K, in stages of 32 (float) or 64 (fixed) taps, the
    stages split into ``split`` ranges (:func:`_splits`) whose partial
    sums are added in split order.  Float: the f32 band widened to
    float64, exact products, float64 sums, rounded once to f32.  Fixed:
    K position k reads row starts[o0] + full_perm(K)[k], x split into xh =
    x >> 8 and xl = (x & 255) - 128, four int8 dots a column, the partials
    and the bias added mod 2^32, then the Q15 epilogue."""
    fixed = taps.dtype == np.int16
    n_out, K, G = len(starts), plan.taps, plan.outputs
    s = starts.astype(np.int64)
    stage = 64 if fixed else 32
    ranges = [(a * stage, b * stage) for a, b in _splits(K // stage, split)]
    if not fixed:
        w = band.w.numpy().astype(np.float64)
        y = np.zeros((n_out, x.shape[1]), dtype=np.float64)
        for o0 in range(0, n_out, G):
            win = _axis_rows(hist, x, s[o0] + np.arange(K)).astype(np.float64)
            o1 = min(o0 + G, n_out)
            total = 0.0
            for a, b in ranges:
                total = total + w[o0:o1, a:b] @ win[a:b]
            y[o0:o1] = total
        return torch.from_numpy(y.astype(np.float32)).t()
    planes = band.w.numpy().astype(np.int64)      # [2, groups, C, K]
    bias = band.bias.numpy().astype(np.int64)     # [groups, C]
    n_acc = planes.shape[2] // G
    perm = ttf.full_perm(K)
    acc = np.zeros((n_out, n_acc, x.shape[1]), dtype=np.int64)
    for g in range(-(-n_out // G)):
        o0 = g * G
        xv = _axis_rows(hist, x, s[o0] + perm).astype(np.int64)
        xh, xl = xv >> 8, (xv & 255) - 128
        a = bias[g][:, None]
        for lo, hi in ranges:
            wh, wl = planes[0, g, :, lo:hi], planes[1, g, :, lo:hi]
            part = (65536 * (wh @ xh[lo:hi]) + 256 * (wh @ xl[lo:hi]
                    + wl @ xh[lo:hi]) + wl @ xl[lo:hi]) % 2 ** 32
            a = (a + part) % 2 ** 32                      # [C, B]
        a = a.reshape(n_acc, G, -1).transpose(1, 0, 2)   # [G, c, B]
        n = min(G, n_out - o0)
        acc[o0:o0 + n] = a[:n]
    a = torch.from_numpy(((acc + 2 ** 31) % 2 ** 32 - 2 ** 31)
                         .astype(np.int32))
    if n_acc == 1:
        return sat32pshr15(a[:, 0]).t()
    return fixed_interp_mix_rows(a[:, :, None, :],
                                 torch.from_numpy(coef)[:, :, None])[:, 0].t()


def _steep_case(case):
    """(taps, starts, coef, hist, x, n_accum) of a stream test case: float,
    fixed interpolated (four tap rows an output) or fixed direct (the
    second tap row alone: 32 outputs a group)."""
    fixed = case.startswith("fixed")
    taps, starts, coef, hist, x = _steep(fixed)
    if case == "fixed-direct":
        taps, coef = np.ascontiguousarray(taps[:, 1]), None
    return taps, starts, coef, hist, x, _n_accum(taps, fixed)


@pytest.mark.parametrize("case", ["float", "fixed-interp", "fixed-direct"])
def test_stream_plan_covers_every_window(case):
    """The stream plan: G outputs a tile (float 16, fixed 16 interpolated,
    32 direct), every output's window inside its tile's K taps from the
    tile's first start, K a whole number of stages (32 taps float, 64
    fixed) and the stages of every K split the kernels may take (1-8
    CTAs a tile) covering them once, in order; the launch's 401 outputs
    too, with K 15104."""
    taps, starts, _, _, _, n_accum = _steep_case(case)
    N = taps.shape[-1]
    _, _, step = _step(STEEP, n_accum is not None)
    for s in (starts, step.w[1].numpy()):
        plan = tfm.gather_plan_stream(s, N, n_accum=n_accum)
        G, K, stage = plan.outputs, plan.taps, 64 if n_accum else 32
        assert (plan.form, G) == ("stream", 32 if n_accum == 1 else 16)
        o = np.arange(len(s))
        off = s.astype(np.int64) - s[o // G * G]
        assert off.min() == 0 and (off + N).max() <= K < (off + N).max() \
            + stage
        assert K % stage == 0
        for split in range(1, 9):
            ranges = _splits(K // stage, split)
            assert ranges[0][0] == 0 and ranges[-1][1] == K // stage
            assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert K == 15104 if n_accum != 1 else K > 15104
    with pytest.raises(ValueError, match="int16"):
        tfm.gather_plan_stream(starts, N, x_itemsize=4)


@pytest.mark.parametrize("case", ["float", "fixed-interp", "fixed-direct"])
def test_stream_band_holds_the_taps(case):
    """The stream band: float f32[ceil(n_out / 16) * 16, K], row o the f32
    taps of output o from column starts[o] - starts[o - o % 16], zeros
    elsewhere; fixed, the band form's planes at G outputs a group:
    un-permuted, column c * G + j holds tap row c of output j at its
    offset, zeros elsewhere, and the bias is 128 * sum of each column."""
    taps, starts, _, _, _, n_accum = _steep_case(case)
    N, n = taps.shape[-1], len(starts)
    plan = tfm.gather_plan_stream(starts, N, n_accum=n_accum)
    G, K = plan.outputs, plan.taps
    band = tfm.gather_band(torch.from_numpy(taps), torch.from_numpy(starts),
                           plan)
    if n_accum is None:
        w = band.w.numpy()
        assert band.bias is None and w.dtype == np.float32
        want = np.zeros((-(-n // 16) * 16, K), dtype=np.float32)
        for o in range(n):
            d = starts[o] - starts[o // 16 * 16]
            want[o, d:d + N] = taps[o]
        assert np.array_equal(w, want)
        return
    groups = -(-n // G)
    assert tuple(band.w.shape) == (2, groups, n_accum * G, K)
    w16 = ttf.fixed_taps16(band.w).numpy()             # [groups, K, C]
    want = np.zeros((groups, K, n_accum, G), dtype=np.int16)
    t3 = taps.reshape(n, n_accum, N)
    for o in range(n):
        g, j = divmod(o, G)
        d = starts[o] - starts[g * G]
        want[g, d:d + N, :, j] = t3[o].T
    assert np.array_equal(w16, want.reshape(groups, K, n_accum * G))
    assert np.array_equal(band.bias.numpy(),
                          w16.astype(np.int32).sum(1) << 7)


@pytest.mark.parametrize("split", [1, 3])
@pytest.mark.parametrize("case", ["float", "fixed-interp", "fixed-direct"])
def test_stream_walk_model_equals_plain(case, split):
    """The stream kernels' walk over the steep launch's first 40 outputs
    (the last tile or group not full), hist read apart from x, K whole or
    split over three CTAs, equals the plain version on the concatenated
    axis: fixed bit for bit, float equal after the f32 rounding (float64
    sums of exact products, in another order)."""
    taps, starts, coef, hist, x, n_accum = _steep_case(case)
    plan = tfm.gather_plan_stream(starts, taps.shape[-1], n_accum=n_accum)
    band = tfm.gather_band(taps, starts, plan)
    X = torch.from_numpy(np.concatenate([hist, x])).t()
    T, S = torch.from_numpy(taps), torch.from_numpy(starts)
    got = _stream_model(hist, x, taps, starts, plan, band, coef, split)
    if n_accum is not None:
        want = tfm.resample_gather_fixed_reference(
            X, T, S, None if coef is None else torch.from_numpy(coef))
    else:
        want = tfm.resample_gather_reference(X, T, S, raw=True)
    assert torch.equal(got, want)


def test_stream_shared_memory_matches_the_source():
    """The host's stream shared-memory formula uses the kernels' constants
    (``csrc/gather_fir.cu``, ``int8_wgmma.cuh``): float, a ring of four
    stages of 16 band rows of 36 floats and 32 x rows of 264 samples (256
    lanes); fixed, a ring of six stages of both planes' two 32-tap
    K-slices of G * n_accum columns and two warpgroups' 64 x rows of 144
    bytes, then their output rows."""
    src = (CSRC / "gather_fir.cu").read_text()
    for line in ("constexpr int kF64StreamRing = 4;",
                 "constexpr int kFixedStreamRing = 6;",
                 "constexpr int kStreamWgs = 2;",
                 "constexpr int kF64StreamLanes = kWarps * 32;",
                 "constexpr int kF64StreamTaps = 32;",
                 "constexpr int kF64StreamBandPitch = kF64StreamTaps + 4;",
                 "constexpr int kF64StreamXPitch = kF64StreamLanes + 8;",
                 "constexpr int kWarps = kThreads / 32;",
                 "constexpr int kThreads = 256;"):
        assert line in src, line
    assert re.search(r"return kFixedStreamRing \* \(2 \* i8::kSub \* "
                     r"i8::kK \* Sh::kN \+\s+kStreamWgs \* i8::kRawBytes\)"
                     r" \+\s+"
                     r"kStreamWgs \* Sh::kWgRows \* i8::kRawPitch \+ 128;",
                     src)
    assert tfm._stream_smem(None) == 4 * (16 * 36 * 4 + 32 * 264 * 2)
    assert tfm._stream_smem(4) == (6 * (2 * 64 * 64 + 2 * 64 * 144)
                                   + 2 * 16 * 144 + 128)
    assert tfm._stream_smem(1) == (6 * (2 * 64 * 32 + 2 * 64 * 144)
                                   + 2 * 32 * 144 + 128)
    assert max(map(tfm._stream_smem, (None, 4, 1))) \
        <= tfm.GATHER_BAND_SMEM_BYTES


@pytest.mark.parametrize("case", ["float", "float-f32-samples", "fixed"])
def test_cpu_wrappers_take_the_plain_version_with_a_stream_plan(case):
    """CPU tensors run the plain version with a stream plan and its band
    (no launch counted), f32 samples included (only the card's stream
    kernels need int16), equal to it without them; a step's stream band
    counts in its weight bytes."""
    fixed = case == "fixed"
    taps, starts, coef, hist, x = _steep(fixed)
    if case == "float-f32-samples":
        hist, x = hist.astype(np.float32) + 0.5, x.astype(np.float32)
    plan = tfm.gather_plan_stream(starts, taps.shape[-1],
                                  n_accum=_n_accum(taps, fixed))
    band = tfm.gather_band(taps, starts, plan)
    w = [torch.from_numpy(a) for a in (taps, starts)
         + (() if coef is None else (coef,))]
    fn = tfm.resample_gather_fixed if fixed else tfm.resample_gather
    before = dict(tfm.launches)
    got = fn(torch.from_numpy(x).t(), *w, hist=torch.from_numpy(hist).t(),
             plan=plan, band=band)
    assert tfm.launches == before
    assert torch.equal(got, fn(torch.from_numpy(np.concatenate([hist, x])).t(),
                               *w))
    _, _, step = _step(STEEP, fixed)
    streamed = tb.BatchedStep(fn=step.fn, w=step.w, hist_rows=step.hist_rows,
                              chunk_rows=step.chunk_rows, zero_tail=0,
                              scheme=step.scheme,
                              kernel_kw=dict(plan=plan, band=band),
                              kernel="gather")
    assert tb._step_weight_bytes(streamed) == (
        tb._step_weight_bytes(step) + sum(
            t.numel() * t.element_size() for t in band if t is not None))
