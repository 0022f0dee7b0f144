"""The gather and fixed dense kernels' host side, the step cache's
``clear_step_cache`` and the JAX package's last public names, on the CPU.

The gather launch (``fm.resample_gather[_fixed]``) and the fixed dense
launch (``dense_fir.resample_dense_fixed``) run hand-written kernels on the
card (``csrc/gather_fir.cu``, ``csrc/dense_fir.cu``), which cannot run
here.  What surrounds them can:

- ``clear_step_cache`` empties the port's step memo, and the next
  ``make_batched_step`` builds a new step (the port's twin of
  ``tests/test_batch.py``'s step-cache tests);
- ``convert.s16_to_internal``, ``fir_matmul.resample_conv_tm`` and
  ``fir_matmul.fixed_weight_planes`` against the JAX package's, on seeded
  numpy inputs;
- ``gather_plan``: every output's window lies inside the rows its CTA
  stages and the CTA's shared memory fits, at 44100 -> 44101 q7, 44101 ->
  44100 q7, 48000 -> 44101 q7 and the steep 96000 -> 401 q3 (rows staged
  a piece at a time; the plan a CUDA step makes there is the stream
  form's), float and fixed; a CPU step makes no plan; and a
  NumPy model of the kernels' walk (CTA tiles, warps, the row loop, tap
  chunks, row pieces) equal to the plain versions, float and fixed,
  direct and interpolated, with tap chunks and row pieces forced;
- the fixed dense device weights: un-permuted they recompose the int16
  taps (zero columns and taps past R and L_pad), the bias is 128 * sum,
  and ``weights_from_jax(kernel="dense")`` builds them from a JAX step's
  planes;
- the wrappers run their plain versions for CPU tensors, count no launch,
  and refuse a device that is neither CPU nor CUDA.
"""

import math

import numpy as np
import pytest
import torch

from speex_resampler_tpu.ops import convert as jconv
from speex_resampler_tpu.ops import filter_design as jfd
from speex_resampler_tpu.ops import fir_matmul as jfm
from speex_resampler_tpu.parallel import batch as jb
from speex_resampler_tpu_torch.ops import convert as tconv
from speex_resampler_tpu_torch.ops import dense_fir as tdf
from speex_resampler_tpu_torch.ops import filter_design as tfd
from speex_resampler_tpu_torch.ops import fir_matmul as tfm
from speex_resampler_tpu_torch.ops import tiled_fir as ttf
from speex_resampler_tpu_torch.parallel import batch as tb

from fixed_inputs import launch_inputs

torch.set_num_threads(1)

VOIP = (44100, 48000, 3, 20)        # dense, group 1, stride 147, R 160
DOWN = (48000, 16000, 3, 20)        # dense, direct, R 96
UP = (16000, 48000, 3, 20)          # dense, R 129
# huge reduced denominators: the gather geometry
GATHER = {"44100-44101": (44100, 44101, 7), "44101-44100": (44101, 44100, 7),
          "48000-44101": (48000, 44101, 7), "96000-401": (96000, 401, 3)}


def _spec(i, o, q, fixed=False, jax=False):
    g = math.gcd(i, o)
    return (jfd if jax else tfd).design_filter(i // g, o // g, q,
                                               fixed_point=fixed)


def _gather_step(cfg, fixed, f0=0):
    spec = _spec(*cfg, fixed=fixed)
    bspec = tb._launch_geometry(spec, 44100, f0=f0)
    step = tb.make_batched_step(spec, bspec, device="cpu")
    assert step.kernel == "gather"
    return spec, bspec, step


# -- clear_step_cache --------------------------------------------------------

def test_clear_step_cache_empties_the_memo_and_rebuilds():
    """A memoized step is returned again until clear_step_cache; then the
    memo is empty and the next request builds a new step, equal in
    weights."""
    tb.clear_step_cache()
    spec = _spec(24000, 48000, 5)
    bspec = tb._launch_geometry(spec, 4096)
    s1 = tb.make_batched_step(spec, bspec, device="cpu")
    assert tb.make_batched_step(_spec(24000, 48000, 5), bspec,
                                device="cpu") is s1
    with tb._STEP_CACHE_LOCK:
        assert len(tb._STEP_CACHE) == 1
    tb.clear_step_cache()
    with tb._STEP_CACHE_LOCK:
        assert len(tb._STEP_CACHE) == 0
    s2 = tb.make_batched_step(spec, bspec, device="cpu")
    assert s2 is not s1
    assert all(torch.equal(a, b) for a, b in zip(s1.w, s2.w)
               if isinstance(a, torch.Tensor))
    tb.clear_step_cache()


def test_clear_step_cache_engines_stay_independent():
    """Engines built before and after a clear give the same samples (the
    step is stateless), and one built before keeps working after it."""
    tb.clear_step_cache()
    rng = np.random.default_rng(17)
    frames = rng.integers(-32768, 32768, (3, 5000, 2), dtype=np.int16)
    a = tb.BatchedResampler(3, 2, 24000, 48000, 5, device="cpu")
    tb.clear_step_cache()
    b = tb.BatchedResampler(3, 2, 24000, 48000, 5, device="cpu")
    assert a._step is not b._step
    ya = np.concatenate([a.process(frames), a.flush()], axis=1)
    yb = np.concatenate([b.process(frames), b.flush()], axis=1)
    assert np.array_equal(ya, yb)
    tb.clear_step_cache()


# -- the JAX package's last public names -------------------------------------

def test_s16_to_internal_equals_jax():
    x = np.random.default_rng(1).integers(-32768, 32768, (3, 257),
                                          dtype=np.int16)
    got = tconv.s16_to_internal(torch.from_numpy(x))
    want = np.asarray(jconv.s16_to_internal(x))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    assert np.array_equal(got.numpy(), want)
    assert tconv.s16_to_internal(torch.from_numpy(x),
                                 torch.float64).dtype == torch.float64


@pytest.mark.parametrize("exact", [True, False], ids=["exact-sums",
                                                      "sinc-weights"])
def test_resample_conv_tm_equals_jax(exact):
    """The time-major f32 product and WORD2INT.  With weights and samples
    whose every partial sum is exact in f32 (small integers over 64) the
    two packages agree bit for bit in any summation order; with the voip
    filter's padded weights, within the LSB contract (f32 sums in another
    order)."""
    from conftest import assert_lsb_close
    rng = np.random.default_rng(2)
    spec = _spec(44100, 48000, 3)
    from speex_resampler_tpu_torch.ops import phase as tph
    stride = 147
    w = tph.build_padded_weights(spec.phase_table, 147, 160, 0, 1)
    L = -(-w.shape[0] // stride) * stride
    w = np.pad(w, ((0, L - w.shape[0]), (0, 0))).astype(np.float32)
    if exact:
        w = (rng.integers(-8, 9, w.shape) / 64).astype(np.float32)
        x = rng.integers(-512, 512, (6 * stride + L, 5), dtype=np.int16)
    else:
        x = rng.integers(-32768, 32768, (6 * stride + L, 5), dtype=np.int16)
    got = tfm.resample_conv_tm(torch.from_numpy(x), torch.from_numpy(w),
                               stride=stride).numpy()
    want = np.asarray(jfm.resample_conv_tm(x, w, stride=stride))
    assert got.shape == want.shape == (6 * 160, 5)
    if exact:
        assert np.array_equal(got, want)
    else:
        assert_lsb_close(got.ravel(), want.ravel())


def test_fixed_weight_planes_equals_jax():
    """The balanced int8 split of the voip fixed dense taps, and of the
    extreme realizable taps, bit for bit with the JAX package's."""
    spec = _spec(44100, 48000, 3, fixed=True)
    bspec = tb._launch_geometry(spec, 4096, max_in_frames=882)
    w16 = tb.make_batched_step(spec, bspec, device="cpu").w[0].numpy()
    edge = np.array([[-32639, 32639, -1, 0, 1, 255, -256, 127]],
                    dtype=np.int16).T
    for w in (w16, edge):
        got = tfm.fixed_weight_planes(w)
        want = jfm.fixed_weight_planes(w)
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and np.array_equal(a, b)
        wh, wl0, bias = got
        assert np.array_equal(256 * wh.astype(np.int32) + wl0, w)


def test_public_names_match_the_jax_package():
    """Every name of the JAX package's ``__all__`` of these modules has its
    twin in the port's (the port may export more)."""
    for jmod, tmod in ((jconv, tconv), (jfm, tfm)):
        missing = set(jmod.__all__) - set(tmod.__all__)
        assert not missing, (jmod.__name__, missing)
        for name in tmod.__all__:
            assert hasattr(tmod, name), name
    assert callable(tb.clear_step_cache) and callable(jb.clear_step_cache)


# -- gather_plan and the kernels' walk ---------------------------------------

def _tiles(plan, n_out):
    for o0 in range(0, n_out, plan.outputs):
        yield o0, min(o0 + plan.outputs, n_out)


def _plan_of(spec, step, fixed, rows=False):
    """The plan a CUDA step of this spec makes (a CPU step makes none), or
    with ``rows`` the (float) rows form's plan over the same starts."""
    assert step.kernel_kw["plan"] is None
    n_accum = (4 if step.w[0].ndim == 3 else 1) if fixed else None
    if rows:
        return tfm.gather_plan_rows(step.w[1].numpy(), spec.filt_len), \
            n_accum
    return tfm.gather_plan(step.w[1].numpy(), spec.filt_len,
                           n_accum=n_accum), n_accum


def _pieces(span, kc, rows):
    """The row pieces [r0, r1) a CTA stages for one chunk."""
    return [(r0, min(r0 + rows, span + kc))
            for r0 in range(0, span + kc, rows)]


@pytest.mark.parametrize("fixed", [False, True], ids=["float", "fixed"])
@pytest.mark.parametrize("cfg", list(GATHER.values()), ids=list(GATHER))
def test_gather_plan_covers_every_window(cfg, fixed):
    """The rows form's plan (float only: the fixed gather has no rows
    form): for each CTA tile and chunk of KC taps, the pieces of at most
    ``rows`` rows it stages cover its start spread + KC, so every window's
    chunk, in order; taps plus rows fit the kernel's shared memory.  The
    drift ratios stage a chunk's rows at once; the steep decimation (8
    outputs' windows 1676 rows apart, past the most rows that fit beside
    one tap) in pieces.  The plan a CUDA step makes:
    the band form at the three drift ratios, every output's window inside
    its group's K taps from the group's first start (float: inside the
    rows its CTA stages), within the band's shared memory; the stream form
    at the steep decimation (its band too wide to be resident), every
    output's window inside its tile's K taps, K a whole number of
    stages."""
    spec, bspec, step = _gather_step(cfg, fixed)
    starts = step.w[1].numpy().astype(np.int64)
    N = spec.filt_len
    chosen, n_accum = _plan_of(spec, step, fixed)
    assert chosen.form == ("stream" if cfg == GATHER["96000-401"]
                           else "band")
    if chosen.form == "stream":
        o = np.arange(len(starts))
        G = chosen.outputs
        assert (starts - starts[o // G * G] + N).max() <= chosen.taps
        assert chosen.taps % (64 if fixed else 32) == 0
    if chosen.form == "band":
        G = chosen.outputs if fixed else 16
        o = np.arange(len(starts))
        assert (starts - starts[o // G * G] + N).max() <= chosen.taps
        if not fixed:
            cta = o // 64 * 64
            assert (starts[np.minimum(o // 16 * 16, len(starts) - 1)]
                    - starts[cta] + chosen.taps).max() <= chosen.rows
        assert tfm._band_smem(n_accum, 2, chosen.taps, chosen.rows) \
            <= tfm.GATHER_BAND_SMEM_BYTES
    if fixed:
        return
    plan, _ = _plan_of(spec, step, fixed, rows=True)
    assert plan.outputs in (8, 16, 32, 64) and 1 <= plan.taps <= N
    tap_bytes = 8
    smem = (plan.outputs * plan.taps * tap_bytes
            + plan.rows * tfm.GATHER_LANES * 2)
    assert smem <= tfm.GATHER_SMEM_BYTES
    assert (np.diff(starts) >= 0).all()
    n_pieces = widest = 0
    for o0, o1 in _tiles(plan, len(starts)):
        span = starts[o1 - 1] - starts[o0]
        widest = max(widest, span)
        for t0 in range(0, N, plan.taps):
            kc = min(plan.taps, N - t0)
            pieces = _pieces(span, kc, plan.rows)
            assert pieces[0][0] == 0 and pieces[-1][1] == span + kc
            assert all(a[1] == b[0] for a, b in zip(pieces, pieces[1:]))
            # output o's chunk reads rows (s_o - s_o0) + t, t < kc
            assert (starts[o0:o1] - starts[o0]).max() + kc <= span + kc
            n_pieces = max(n_pieces, len(pieces))
    if cfg == GATHER["48000-44101"]:   # decimation: windows spread wider
        assert N > 128 and starts[-1] - starts[0] > len(starts)
    if cfg == GATHER["96000-401"]:
        assert plan.outputs == 8 and n_pieces > 1
        assert 8 * tap_bytes + (widest + 1) * 128 > tfm.GATHER_SMEM_BYTES
    else:
        assert n_pieces == 1


def test_gather_plan_chunks_taps_and_refuses_what_cannot_fit():
    """Long windows fall to fewer outputs a CTA, then to tap chunks; a
    spread no CTA of 8 outputs can stage at once is staged in pieces
    (eight outputs, half the memory for taps); a fixed plan takes no rows
    form (the stream form where the band does not fit; no form for f32
    samples); starts must be sorted and N positive."""
    starts = np.arange(4096) * 3
    plan = tfm.gather_plan_rows(starts, 2000)
    assert plan.outputs == 8 and plan.taps < 2000
    assert (plan.outputs * plan.taps * 8 + plan.rows * 64 * 2
            <= tfm.GATHER_SMEM_BYTES)
    # f32 samples: 64 outputs' rows no longer fit beside their taps
    # (and its band, 173 taps wide, does not fit beside two f32 windows)
    assert tfm.gather_plan(starts, 128, x_itemsize=4) == tfm.GatherPlan(
        32, 128, 31 * 3 + 128)
    smem = tfm.GATHER_SMEM_BYTES
    assert tfm.gather_plan_rows(np.arange(64) * 200, 16) == tfm.GatherPlan(
        8, 16, (smem - 8 * 16 * 8) // 128)
    assert tfm.gather_plan(np.arange(64) * 200, 5000,
                           n_accum=4).form == "stream"
    with pytest.raises(ValueError, match="int16"):
        tfm.gather_plan(np.arange(64) * 200, 5000, n_accum=4, x_itemsize=4)
    with pytest.raises(ValueError, match="non-decreasing"):
        tfm.gather_plan(np.array([0, 2, 1]), 16)
    with pytest.raises(ValueError, match="N = 0"):
        tfm.gather_plan(np.arange(8), 0)


def _walk_piece(x, t3, starts, acc, o0, o1, kO, row0, r0, r1, t0, kc):
    """One staged piece of the walk: rows row0 + r, r0 <= r < r1, of x
    [batch, T] (zeros past T), each warp's outputs adding the taps of
    chunk t0 that fall on them, in row order."""
    batch, T = x.shape
    rows = row0 + np.arange(r0, r1)
    xs = np.where((rows < T)[:, None], x.T[np.minimum(rows, T - 1)], 0)
    base = starts[o0]
    for w0 in range(o0, o1, kO):
        outs = [min(o, o1 - 1) for o in range(w0, w0 + kO)]
        d = [starts[o] - base for o in outs]
        for v in range(max(d[0], r0), min(d[-1] + kc, r1)):
            xv = xs[v - r0]
            for j, o in enumerate(outs):
                t = v - d[j]
                if 0 <= t < kc and o < w0 + kO and o == w0 + j:
                    acc[o] += t3[o, :, t0 + t, None].astype(acc.dtype) * xv


def _walk_model(x, taps, starts, plan, coef=None):
    """NumPy model of ``csrc/gather_fir.cu``: CTA tiles of plan.outputs
    outputs, warps of plan.outputs / 8, the row loop over each warp's
    windows (row v is tap v - d_j of output j), tap chunks of plan.taps
    from the rows staged a piece of plan.rows at a time, the sums exact
    (float64 sums of exact products for float, int64 for fixed, wrapped at
    the end), then the epilogues.
    x: [batch, T]; returns [batch, n_out] like the wrappers."""
    fixed = taps.dtype == np.int16
    t3 = taps.reshape(taps.shape[0], -1, taps.shape[-1])      # [n, c, N]
    n_out, n_acc, N = t3.shape
    batch, T = x.shape
    kO = plan.outputs // 8
    acc = np.zeros((n_out, n_acc, batch), dtype=np.int64 if fixed
                   else np.float64)
    for o0, o1 in _tiles(plan, n_out):
        base, span = starts[o0], starts[o1 - 1] - starts[o0]
        for t0 in range(0, N, plan.taps):
            kc = min(plan.taps, N - t0)
            for r0, r1 in _pieces(span, kc, plan.rows):
                _walk_piece(x, t3, starts, acc, o0, o1, kO, base + t0,
                            r0, r1, t0, kc)
    if not fixed:
        y = acc[:, 0].astype(np.float32)
        return torch.from_numpy(y).t()
    a = torch.from_numpy(((acc + 2 ** 31) % 2 ** 32 - 2 ** 31)
                         .astype(np.int32))
    from speex_resampler_tpu_torch.ops.fixed_math import (
        fixed_interp_mix_rows, sat32pshr15)
    if n_acc == 1:
        return sat32pshr15(a[:, 0]).t()
    return fixed_interp_mix_rows(a[:, :, None, :],
                                 torch.from_numpy(coef)[:, :, None])[:, 0].t()


@pytest.mark.parametrize("case", ["float", "fixed-interp", "fixed-direct",
                                  "float-chunked", "fixed-chunked",
                                  "float-pieces", "fixed-pieces"])
def test_gather_walk_model_equals_plain(case):
    """The kernels' walk, modelled in NumPy at a few hundred outputs of
    the drift launch (44100 -> 44101 q7; "fixed-direct" takes one
    accumulator row as a direct filter), equals the plain versions: float
    raw sums within float64 rounding of each other (equal after the f32
    rounding here), fixed bit for bit with the wrap input on every third
    lane; with tap chunks forced (plans of 8 and 16 outputs, KC 48), and
    with rows staged in pieces (KC 48, 23 rows: three pieces a chunk, so
    pieces end inside windows)."""
    fixed = case.startswith("fixed")
    spec, bspec, step = _gather_step(GATHER["44100-44101"], fixed)
    hist, x = launch_inputs(step, bspec.in_per_launch, 6, seed=3,
                            wrap=fixed)
    X = np.concatenate([hist, x[:bspec.in_per_launch]])          # [T, B]
    n = 300
    taps, starts = step.w[0][:n].numpy(), step.w[1][:n].numpy()
    coef = step.w[2][:n].numpy() if len(step.w) == 3 else None
    if case == "fixed-direct":      # one accumulator row as a direct filter
        taps, coef = np.ascontiguousarray(taps[:, 0]), None
    plan = _plan_of(spec, step, fixed, rows=True)[0]
    if case.endswith("chunked"):
        plan = tfm.GatherPlan(8 if fixed else 16, 48,
                              int(starts[-1] - starts[0]) + 48)
    if case.endswith("pieces"):
        plan = tfm.GatherPlan(8 if fixed else 16, 48, 23)
    Xt = torch.from_numpy(X).t()
    if fixed:
        want = tfm.resample_gather_fixed_reference(
            Xt, torch.from_numpy(taps), torch.from_numpy(starts),
            None if coef is None else torch.from_numpy(coef))
        got = _walk_model(X.T, taps, starts.astype(np.int64), plan, coef)
        assert torch.equal(got, want)
    else:
        want = tfm.resample_gather_reference(
            Xt, torch.from_numpy(taps), torch.from_numpy(starts), raw=True)
        got = _walk_model(X.T, taps, starts.astype(np.int64), plan)
        assert torch.equal(got, want)


@pytest.mark.parametrize("fixed", [False, True], ids=["float", "fixed"])
def test_gather_wrappers_run_plain_on_cpu_and_refuse_other_devices(fixed):
    """CPU tensors: the plain version, no launch counted, a plan ignored;
    the step's form (hist and x apart) equals the concatenated axis; a
    device that is neither CPU nor CUDA raises."""
    spec, bspec, step = _gather_step(GATHER["44100-44101"], fixed)
    hist, x = launch_inputs(step, bspec.in_per_launch, 2, seed=1,
                            wrap=False)
    X = torch.cat([torch.from_numpy(hist),
                   torch.from_numpy(x[:bspec.in_per_launch])]).t()
    fn = tfm.resample_gather_fixed if fixed else tfm.resample_gather
    ref = (tfm.resample_gather_fixed_reference if fixed
           else tfm.resample_gather_reference)
    before = dict(tfm.launches)
    got = fn(X, *step.w, **step.kernel_kw)
    assert tfm.launches == before
    assert torch.equal(got, ref(X, *step.w))
    assert torch.equal(got, fn(X, *step.w))
    apart = fn(torch.from_numpy(x[:bspec.in_per_launch]).t(), *step.w,
               hist=torch.from_numpy(hist).t(), **step.kernel_kw)
    assert torch.equal(apart, got)
    h2, y = step.fn(torch.from_numpy(hist), torch.from_numpy(x), step.w)
    assert torch.equal(y, got.t()) and torch.equal(h2, X.t()[-len(hist):])
    meta = torch.empty(X.shape, dtype=X.dtype, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fn(meta, *step.w, **step.kernel_kw)


@pytest.mark.parametrize("fixed", [False, True], ids=["float", "fixed"])
def test_steep_decimation_gather_serves_on_cpu(fixed):
    """96000 -> 401 q3: a gather ratio whose 8 outputs' windows lie 1676
    rows apart, more than fit a CTA at once.  A CPU engine makes no plan
    and serves it with the plain version, equal to the JAX package's
    engine (fixed bit for bit, float within the LSB contract); a CUDA step
    would take the stream form."""
    from conftest import assert_lsb_close
    from speex_resampler_tpu.parallel.batch import (
        BatchedResampler as JaxEngine)
    rng = np.random.default_rng(21)
    frames = rng.integers(-32768, 32768, (2, 30000, 1), dtype=np.int16)
    got, want = [], []
    for eng, out in ((tb.BatchedResampler(2, 1, 96000, 401, 3, device="cpu",
                                          fixed_point=fixed), got),
                     (JaxEngine(2, 1, 96000, 401, 3, fixed_point=fixed),
                      want)):
        out += [np.asarray(eng.process(frames)), np.asarray(eng.flush())]
    tstep = tb.make_batched_step(
        _spec(96000, 401, 3, fixed=fixed),
        tb._launch_geometry(_spec(96000, 401, 3, fixed=fixed), 44100),
        device="cpu")
    assert tstep.kernel == "gather" and tstep.kernel_kw["plan"] is None
    got, want = np.concatenate(got, axis=1), np.concatenate(want, axis=1)
    assert got.shape == want.shape and got.shape[1] > 100
    if fixed:
        assert np.array_equal(got, want)
    else:
        assert_lsb_close(got.ravel(), want.ravel())


# -- the fixed dense kernel's weights ----------------------------------------

@pytest.mark.parametrize("cfg", [VOIP, DOWN, UP], ids=["R160-interp",
                                                       "R96-direct",
                                                       "R129-interp"])
def test_dense_fixed_device_weights_recompose_the_taps(cfg):
    """planes int8[2, 1, n_accum * R_pad, K_pad], un-permuted, give back
    the int16 taps of every column set (zeros past R and past L_pad); the
    bias is 128 * sum of each column; coef padded with zero columns; the
    tap table covers R_pad in the fixed CTA's rows."""
    spec = _spec(*cfg[:3], fixed=True)
    bspec = tb._launch_geometry(spec, 4096,
                                max_in_frames=int(cfg[3] * cfg[0] / 1000))
    step = tb.make_batched_step(spec, bspec, device="cpu")
    assert (step.kernel, step.scheme) == ("dense", "fixed")
    kw = step.kernel_kw
    n_accum, R = kw["n_accum"], kw["R"]
    assert R == bspec.group * bspec.den
    w16 = step.w[0].numpy()
    L, C = w16.shape
    assert C == n_accum * R
    w = step.w
    assert isinstance(w, tdf.FixedDenseInterpWeights if n_accum == 4
                      else tdf.FixedDenseWeights)
    planes, bias, coef, taps = w.planes, w.bias, w.coef_pad, w.taps
    rows = ttf.FIXED_ROWS[n_accum]
    R_pad = -(-R // rows) * rows
    K = -(-L // 32) * 32
    assert tuple(planes.shape) == (2, 1, n_accum * R_pad, K)
    back = ttf.fixed_taps16(planes)[0].numpy().reshape(K, n_accum, R_pad)
    assert np.array_equal(back[:L, :, :R], w16.reshape(L, n_accum, R))
    assert not back[L:].any() and not back[:, :, R:].any()
    assert np.array_equal(bias.numpy()[0],
                          back.reshape(K, -1).astype(np.int32).sum(0) << 7)
    assert w.w16 is w[0]
    if n_accum == 4:
        assert np.array_equal(coef.numpy()[0, :, :R], w.coef.numpy())
        assert not coef.numpy()[0, :, R:].any() and w.coef is w[1]
    else:
        assert coef is None and w.coef is None and len(w) == 4
    assert tuple(taps.shape) == (1, R_pad // rows, 2)


@pytest.mark.parametrize("cfg", [VOIP, DOWN], ids=["interp", "direct"])
def test_dense_fixed_weights_from_jax_planes(cfg):
    """A JAX fixed dense step's (wh, wl0, bias[, coef]) -> the port's
    device weights, kernel planes included, equal to the port's own step
    weights; the plain launch on them equals the JAX step bit for bit."""
    i, o, q, ms = cfg
    cap = int(ms * i / 1000)
    js, ts = _spec(i, o, q, fixed=True, jax=True), _spec(i, o, q, fixed=True)
    jspec = jb._launch_geometry(js, 4096, use_pallas=True, max_in_frames=cap)
    tspec = tb._launch_geometry(ts, 4096, max_in_frames=cap)
    jstep = jb.make_batched_step(js, jspec, use_pallas=True,
                                 pallas_interpret=True)
    tstep = tb.make_batched_step(ts, tspec, device="cpu")
    got = tb.weights_from_jax(tuple(np.asarray(a) for a in jstep.w), "fixed",
                              device="cpu", kernel="dense")
    assert len(got) == len(tstep.w) == (6 if len(jstep.w) == 4 else 4)
    for a, b in zip(got, tstep.w):
        assert a.dtype == b.dtype and torch.equal(a, b)
    hist, x = launch_inputs(tstep, tspec.in_per_launch, 5, seed=9)
    _, jy = jstep.fn(hist, x, jstep.w)
    y = tdf.resample_dense_fixed(torch.from_numpy(hist), torch.from_numpy(x),
                                 got, **tstep.kernel_kw)
    assert np.array_equal(y.numpy()[:tspec.out_per_launch], np.asarray(jy))


def test_dense_fixed_wrapper_guards():
    """CPU tensors run the plain version and count no launch; weights of
    the wrong form, a wrong R or stride, and a device without a kernel are
    refused."""
    spec = _spec(44100, 48000, 3, fixed=True)
    bspec = tb._launch_geometry(spec, 4096, max_in_frames=882)
    step = tb.make_batched_step(spec, bspec, device="cpu")
    kw = step.kernel_kw
    hist, x = (torch.from_numpy(a) for a in
               launch_inputs(step, bspec.in_per_launch, 3, 0, wrap=False))
    before = dict(tdf.launches)
    y = tdf.resample_dense_fixed(hist, x, step.w, **kw)
    assert tdf.launches == before
    assert torch.equal(y, tdf.resample_dense_fixed_reference(hist, x, step.w,
                                                             **kw))
    with pytest.raises(ValueError):
        tdf.resample_dense_fixed(hist, x, step.w[:5], **kw)
    with pytest.raises(TypeError):
        tdf.resample_dense_fixed(hist, x, step.w, **{**kw, "R": kw["R"] + 1})
    with pytest.raises(ValueError):
        tdf.resample_dense_fixed(hist, x, step.w,
                                 **{**kw, "stride": kw["stride"] + 1})
    bad = list(step.w)
    bad[2] = bad[2][:, :, :, :-32].contiguous()
    with pytest.raises(ValueError, match="planes"):
        tdf.resample_dense_fixed(hist, x, tuple(bad), **kw)
    meta = torch.empty(hist.shape, dtype=torch.int16, device="meta")
    with pytest.raises(ValueError):
        tdf.resample_dense_fixed(meta, x, step.w, **kw)
    meta_w = tuple(t.to("meta") for t in step.w)
    with pytest.raises(ValueError, match="no kernel"):
        tdf.resample_dense_fixed(hist.to("meta"), x.to("meta"), meta_w,
                                 **kw)


def test_new_kernel_modules_and_tools_load_no_jax_or_triton():
    """The gather and dense wrappers, ``chip_smoke.py`` and the tools that
    time the new kernels load neither jax, triton nor the JAX package, and
    build nothing at import."""
    import subprocess
    import sys
    from pathlib import Path
    code = (
        "import sys\n"
        "import speex_resampler_tpu_torch.ops.fir_matmul\n"
        "import speex_resampler_tpu_torch.ops.dense_fir\n"
        "sys.argv = ['x']\n"
        "import tools.gather_timing, tools.gather_ablate\n"
        "import tools.process_timing, chip_smoke\n"
        "assert 'gather' in chip_smoke.COUNTERS\n"
        "import speex_resampler_tpu_torch.ops._build as b\n"
        "assert b._lib is None\n"
        "print(sorted(m for m in ('jax', 'triton', 'speex_resampler_tpu')"
        " if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code],
                         cwd=Path(__file__).resolve().parent.parent,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
