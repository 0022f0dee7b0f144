"""The port's dense and gather geometries against the JAX package.

A ``max_latency_ms`` cap below one tiled or streamed unit (the voip
preset's hard 20 ms) lands in the dense geometry; a huge reduced
denominator (44100 -> 44101, clock drift) in the gather geometry.  On the
CPU:

- the dense kernel's plain version (``ops/dense_fir.resample_dense_reference``)
  against the JAX package's K3 (``resample_conv_tm_pallas`` in interpret
  mode) and its XLA twin (``fm.resample_conv_tm``), reached through each
  package's ``make_batched_step`` with the same history and chunk, at the
  voip shapes (R 160, 96, 129, and 32 < ROW_TILE), B 4 and 130: within the
  LSB contract (``conftest.assert_lsb_close``, f32 sums in another order);
- the fixed dense product and both gathers (plain torch on every device,
  ``ops/fir_matmul``) against the JAX package's: fixed bit-exact, with
  lanes that carry the wrap input (``fixed_inputs.wrap_input``); float
  gather within the LSB contract;
- launch geometry equal field for field over a matrix of configs and caps,
  both universes;
- the engine against the JAX engine (``use_pallas=True,
  pallas_interpret=True``) through process / flush / process;
- ``weights_from_jax`` and checkpoints across geometry families.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from speex_resampler_tpu.ops import filter_design as jfd
from speex_resampler_tpu.ops import fir_matmul as jfm
from speex_resampler_tpu.parallel import batch as jb
from speex_resampler_tpu.parallel.batch import BatchedResampler as JaxEngine
from speex_resampler_tpu_torch import BatchedResampler
from speex_resampler_tpu_torch.ops import dense_fir as tdf
from speex_resampler_tpu_torch.ops import filter_design as tfd
from speex_resampler_tpu_torch.ops import fir_matmul as tfm
from speex_resampler_tpu_torch.ops import phase as tph
from speex_resampler_tpu_torch.parallel import batch as tb

from conftest import assert_lsb_close
from fixed_inputs import launch_inputs

torch.set_num_threads(1)

# (in, out, quality, max_latency_ms)
VOIP = (44100, 48000, 3, 20)       # dense, group 1, stride 147, R 160
DOWN = (48000, 16000, 3, 20)       # dense, direct, group 96, R 96
UP = (16000, 48000, 3, 20)         # dense, group 43, R 129
NARROW = (48000, 16000, 3, 2)      # dense, group 32, R 32 < ROW_TILE
DRIFT = (44100, 44101, 7, None)    # gather
# the phases a launch runs at: 0 and the one a flush of 672 staged frames
# leaves at 44.1k->48k; 16k->48k (num 1) flushes always leave 0, so 1
# stands in; den 1 has no other phase
PHASES = {VOIP: (0, 84), DOWN: (0,), UP: (0, 1), NARROW: (0,)}


def _specs(cfg, fixed=False):
    i, o = cfg[:2]
    g = math.gcd(i, o)
    return (jfd.design_filter(i // g, o // g, cfg[2], fixed_point=fixed),
            tfd.design_filter(i // g, o // g, cfg[2], fixed_point=fixed))


def _cap(cfg):
    ms = cfg[3]
    return None if ms is None else int(ms * cfg[0] / 1000)


def _flush_f0(spec, staged: int) -> int:
    m = tph.producible_outputs(staged, 0, 0, spec.num, spec.den)
    return (m * spec.num) % spec.den


def _steps(cfg, f0, fixed=False, target=4096, **jax_kw):
    js, ts = _specs(cfg, fixed)
    jspec = jb._launch_geometry(js, target, use_pallas=True, f0=f0,
                                max_in_frames=_cap(cfg))
    tspec = tb._launch_geometry(ts, target, f0=f0, max_in_frames=_cap(cfg))
    assert dataclasses.asdict(jspec) == dataclasses.asdict(tspec)
    kw = dict(use_pallas=True, pallas_interpret=True)
    kw.update(jax_kw)
    jstep = jb.make_batched_step(js, jspec, **kw)
    tstep = tb.make_batched_step(ts, tspec, device="cpu")
    for f in ("hist_rows", "chunk_rows", "zero_tail", "scheme"):
        assert getattr(jstep, f) == getattr(tstep, f), f
    return jstep, tstep, tspec


def test_voip_flush_phase():
    assert _flush_f0(_specs(VOIP)[1], 672) == 84


DENSE_CASES = [(cfg, f0, B) for cfg in PHASES for f0 in PHASES[cfg]
               for B in (4, 130)]


@pytest.mark.parametrize(
    "cfg,f0,B", DENSE_CASES,
    ids=[f"{c[0]}-{c[1]}-{c[3]}ms-f0{f}-B{b}" for c, f, b in DENSE_CASES])
def test_dense_plain_matches_jax_k3_and_xla(cfg, f0, B):
    jstep, tstep, tspec = _steps(cfg, f0)
    assert tspec.kernel == tstep.kernel == "dense"
    R = tspec.group * tspec.den
    assert tstep.w[0].shape[1] == -(-R // 64) * 64
    assert tstep.kernel_kw["R"] == R
    js = _specs(cfg)[0]
    xla = jb.make_batched_step(
        js, jb._launch_geometry(js, 4096, use_pallas=True, f0=f0,
                                max_in_frames=_cap(cfg)), use_pallas=False)
    rng = np.random.default_rng(B + f0)
    hist = rng.integers(-32768, 32768, (tstep.hist_rows, B), dtype=np.int16)
    x = rng.integers(-32768, 32768, (tstep.chunk_rows, B), dtype=np.int16)
    th, ty = tstep.fn(torch.from_numpy(hist), torch.from_numpy(x), tstep.w)
    assert ty.shape == (tspec.out_per_launch, B)
    for step in (jstep, xla):
        jh, jy = step.fn(hist, x, step.w)
        assert_lsb_close(ty.numpy().ravel(), np.asarray(jy).ravel())
        assert np.array_equal(th.numpy(), np.asarray(jh))
    before = dict(tdf.launches)
    direct = tdf.resample_dense(torch.from_numpy(hist), torch.from_numpy(x),
                                tstep.w, **tstep.kernel_kw)
    assert tdf.launches == before
    assert torch.equal(direct, ty)


@pytest.mark.parametrize("cfg", [VOIP, DOWN, UP, NARROW],
                         ids=["R160", "R96", "R129", "R32"])
def test_padded_weights_and_sub_bands_cover_every_nonzero(cfg):
    """The kernel's weights: JAX's f32 [L_pad, R] padded with zero columns
    to R_pad = round64(R); each 16-column sub-band's [lo, hi) is exactly
    the span of its nonzero tap rows ((0, 0) if none), so the kernel, which
    walks only those, skips no nonzero weight.  The plain version on them
    equals the JAX package's K3 (interpret mode) within the LSB contract."""
    jstep, tstep, tspec = _steps(cfg, 0)
    R = tspec.group * tspec.den
    jw = np.asarray(jstep.w)
    w, bands = (t.numpy() for t in tstep.w)
    L, R_pad = w.shape
    assert R_pad % 64 == 0 and 0 <= R_pad - R < 64 and jw.shape == (L, R)
    assert np.array_equal(w[:, :R], jw) and not w[:, R:].any()
    assert bands.shape == (1, R_pad // 16, 2)
    for i, (lo, hi) in enumerate(bands[0]):
        rows = np.flatnonzero(w[:, 16 * i:16 * i + 16].any(axis=1))
        assert (lo, hi) == ((rows[0], rows[-1] + 1) if rows.size else (0, 0))
    rng = np.random.default_rng(R)
    hist = rng.integers(-32768, 32768, (tstep.hist_rows, 4), dtype=np.int16)
    x = rng.integers(-32768, 32768, (tstep.chunk_rows, 4), dtype=np.int16)
    ty = tdf.resample_dense_reference(torch.from_numpy(hist),
                                      torch.from_numpy(x), tstep.w,
                                      **tstep.kernel_kw)
    _, jy = jstep.fn(hist, x, jstep.w)
    n_out = tspec.out_per_launch
    assert_lsb_close(ty.numpy()[:n_out].ravel(), np.asarray(jy).ravel())


@pytest.mark.parametrize(
    "cfg,f0", [(VOIP, 0), (VOIP, 84), (DOWN, 0), (UP, 1)],
    ids=["44k1-48k-f0-0", "44k1-48k-f0-84", "48k-16k-direct",
         "16k-48k-direct-f0-1"])
def test_fixed_dense_matches_jax_bit_exact(cfg, f0):
    """The JAX package's fixed dense step (``fm.resample_conv_tm_fixed``,
    int8 planes, c-minor columns) and the port's (int16 taps, exact float64
    product), every third lane carrying the wrap input."""
    jstep, tstep, tspec = _steps(cfg, f0, fixed=True)
    assert tstep.kernel == "dense" and tstep.scheme == "fixed"
    assert tstep.kernel_kw["n_accum"] == (4 if cfg == VOIP else 1)
    hist, x = launch_inputs(tstep, tspec.in_per_launch, 7, seed=f0 + 3)
    jh, jy = jstep.fn(hist, x, jstep.w)
    th, ty = tstep.fn(torch.from_numpy(hist), torch.from_numpy(x), tstep.w)
    assert ty.shape == (tspec.out_per_launch, 7)
    assert int((ty.numpy() != np.asarray(jy)).sum()) == 0
    assert np.array_equal(th.numpy(), np.asarray(jh))


@pytest.mark.parametrize("f0", [0, "flush"])
@pytest.mark.parametrize("fixed", [False, True], ids=["float", "fixed"])
def test_gather_matches_jax(fixed, f0):
    """44100 -> 44101 q7: one block of 44100 frames -> 44101 outputs.
    Fixed (interpolated, 4 accumulators) bit-exact with the wrap input;
    float within the LSB contract."""
    ts = _specs(DRIFT, fixed)[1]
    f0 = _flush_f0(ts, 5900) if f0 == "flush" else 0
    jstep, tstep, tspec = _steps(DRIFT, f0, fixed=fixed)
    assert tspec.kernel == tstep.kernel == "gather"
    assert (tspec.in_per_launch, tspec.out_per_launch) == (44100, 44101)
    hist, x = launch_inputs(tstep, tspec.in_per_launch, 4, seed=f0,
                            wrap=fixed)
    jh, jy = jstep.fn(hist, x, jstep.w)
    th, ty = tstep.fn(torch.from_numpy(hist), torch.from_numpy(x), tstep.w)
    assert ty.shape == (44101, 4)
    if fixed:
        assert int((ty.numpy() != np.asarray(jy)).sum()) == 0
    else:
        assert_lsb_close(ty.numpy().ravel(), np.asarray(jy).ravel())
    assert np.array_equal(th.numpy(), np.asarray(jh))


@pytest.mark.parametrize("fixed", [False, True], ids=["float", "fixed"])
def test_gather_result_does_not_depend_on_the_tile(fixed):
    _, tstep, tspec = _steps(DRIFT, 0, fixed=fixed)
    hist, x = launch_inputs(tstep, tspec.in_per_launch, 3, seed=1,
                            wrap=fixed)
    X = torch.cat([torch.from_numpy(hist), torch.from_numpy(x)]).t()
    fn = tfm.resample_gather_fixed if fixed else tfm.resample_gather
    want = fn(X, *tstep.w)
    for tile in (1000, 4097):
        assert torch.equal(fn(X, *tstep.w, tile=tile), want)


def test_dense_twins_and_constants_equal_jax():
    assert tfm.MAX_PADDED_WEIGHT_BYTES == jfm.MAX_PADDED_WEIGHT_BYTES
    for num, den, n in ((147, 160, 48), (3, 1, 144), (1, 3, 48), (1, 2, 80),
                        (160, 147, 280), (12, 1, 3072), (5, 7, 16)):
        assert tfm.choose_group(num, den, n) == jfm.choose_group(num, den, n)
    assert tb._MAX_GATHER_OUT_FRAMES == jb._MAX_GATHER_OUT_FRAMES


# (config, target frames, caps in frames): caps below one tiled/streamed
# unit go dense; a gather config's cap floors its block count; a capped
# dense geometry whose padded weights pass 32 MB is re-routed to gather
GEOMETRY = [
    ((44100, 48000, 7), 9408, (None, 882, 3000, 9408, 20000)),
    ((44100, 48000, 3), 4096, (None, 147, 882, 2352)),
    ((48000, 16000, 3), 4096, (None, 96, 960)),
    ((16000, 48000, 3), 4096, (None, 320, 2000)),
    ((24000, 48000, 5), 4096, (None, 100, 1000)),
    ((44100, 24000, 5), 4096, (None, 500, 4000)),
    ((48000, 44100, 10), 20480, (None, 960, 20000)),
    ((44100, 16000, 7), 7056, (None, 882, 5000)),
    ((44100, 44101, 7), 200000, (None, 50000, 200000)),
    ((40950, 40960, 0), 70000, (None, 10000)),
]


@pytest.mark.parametrize("cfg,target,caps", GEOMETRY,
                         ids=["%d-%d-q%d" % g[0] for g in GEOMETRY])
def test_launch_geometry_equal_with_caps(cfg, target, caps):
    """Every BatchSpec field equals the JAX package's use_pallas=True
    choice, both universes, uncapped and under each cap; a cap below num
    frames is INVALID_ARG in both."""
    kinds = set()
    for fixed in (False, True):
        js, ts = _specs(cfg, fixed)
        for cap in caps:
            jspec = jb._launch_geometry(js, target, use_pallas=True,
                                        max_in_frames=cap)
            tspec = tb._launch_geometry(ts, target, max_in_frames=cap)
            assert dataclasses.asdict(jspec) == dataclasses.asdict(tspec)
            assert (jspec.in_per_launch, jspec.out_per_launch) == (
                tspec.in_per_launch, tspec.out_per_launch)
            assert cap is None or tspec.in_per_launch <= cap
            kinds.add(tspec.kernel)
        with pytest.raises(tb.ResamplerError) as e:
            tb._launch_geometry(ts, target, max_in_frames=ts.num - 1)
        assert e.value.code == tb.ResamplerErrorCode.INVALID_ARG
    if cfg == (40950, 40960, 0):
        assert kinds == {"streamed", "gather"}
    if cfg in ((44100, 48000, 3), (48000, 16000, 3), (16000, 48000, 3)):
        assert "dense" in kinds


S, C = 2, 2
CALLS = (3000, 1100, 2500)          # the flush after them moves f0
AFTER = (2600, 700)
# 44100 -> 44101: one launch (a 5900-frame remainder), a flush that moves
# f0, one more launch
SCHEDULES = {DRIFT: ((30000, 20000), (46000,))}


def _frames(n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-32768, 32768, (S, n, C), dtype=np.int16)


def _drive(eng, calls, after, seed=5):
    outs = [eng.process(_frames(n, seed + k)) for k, n in enumerate(calls)]
    outs.append(eng.flush())
    outs += [eng.process(_frames(n, seed + 10 + k))
             for k, n in enumerate(after)]
    outs.append(eng.flush())
    return outs


def _engines(cfg, fixed, scheme="auto"):
    i, o, q, ms = cfg
    kw = dict(fixed_point=fixed, max_latency_ms=ms, scheme=scheme)
    return (JaxEngine(S, C, i, o, q, use_pallas=True, pallas_interpret=True,
                      **kw),
            BatchedResampler(S, C, i, o, q, device="cpu", **kw))


@pytest.mark.parametrize("fixed", [False, True], ids=["float", "fixed"])
@pytest.mark.parametrize("cfg", [VOIP, DOWN, DRIFT],
                         ids=["voip-44k1-48k", "voip-48k-16k", "44k1-44k101"])
def test_engine_matches_jax_through_flush(cfg, fixed):
    jax_eng, port = _engines(cfg, fixed)
    kind = "gather" if cfg == DRIFT else "dense"
    assert port.bspec.kernel == port._step.kernel == jax_eng.bspec.kernel \
        == kind
    assert port._step.scheme == jax_eng._step.scheme \
        == ("fixed" if fixed else "highest")
    if cfg != DRIFT:
        assert port.launch_latency_ms <= 20
    calls, after = SCHEDULES.get(cfg, (CALLS, AFTER))
    want = _drive(jax_eng, calls, after)
    got = _drive(port, calls, after)
    assert port._f0 == jax_eng._f0
    assert port.launches > len(calls)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if fixed:
            assert int((g != w).sum()) == 0
        else:
            assert_lsb_close(g.ravel(), w.ravel())


def test_explicit_float_schemes_on_a_dense_engine_run_highest():
    """As in the JAX package, the dense and gather steps have one float
    scheme; a request for another serves "highest", an unknown one is
    INVALID_ARG."""
    for scheme in ("int8", "split5", "highest"):
        eng = BatchedResampler(S, C, 44100, 48000, 3, device="cpu",
                               max_latency_ms=20, scheme=scheme)
        assert (eng._step.kernel, eng._step.scheme) == ("dense", "highest")
    with pytest.raises(tb.ResamplerError):
        BatchedResampler(S, C, 44100, 48000, 3, device="cpu",
                         max_latency_ms=20, scheme="INT8")


@pytest.mark.parametrize("cfg,fixed", [(VOIP, False), (VOIP, True),
                                       (DOWN, True), (DRIFT, False),
                                       (DRIFT, True)],
                         ids=["dense-float", "dense-fixed-interp",
                              "dense-fixed-direct", "gather-float",
                              "gather-fixed"])
def test_weights_from_jax_equal_port_weights(cfg, fixed):
    """JAX's dense f32 [L_pad, R], its fixed (wh, wl0, bias[, coef]) with
    c-minor columns, and its gather (taps, starts[, coef]) -> the port's own
    step weights; a wrong fixed bias is refused."""
    jstep, tstep, tspec = _steps(cfg, 0, fixed=fixed)
    jw = (tuple(np.asarray(a) for a in jstep.w)
          if isinstance(jstep.w, tuple) else np.asarray(jstep.w))
    got = tb.weights_from_jax(jw, tstep.scheme, device="cpu",
                              kernel=tspec.kernel,
                              n_out=tspec.out_per_launch)
    assert len(got) == len(tstep.w)
    for a, b in zip(got, tstep.w):
        assert a.dtype == b.dtype and torch.equal(a, b)
    if tspec.kernel == "gather":     # JAX pads to its 2048-output tile
        assert len(jw[0]) > tspec.out_per_launch == len(got[0])
        with pytest.raises(ValueError, match="n_out"):
            tb.weights_from_jax(jw, tstep.scheme, device="cpu",
                                kernel="gather")
    if fixed and tspec.kernel == "dense":
        bad = (jw[0], jw[1], jw[2] + 1, *jw[3:])
        with pytest.raises(ValueError, match="bias"):
            tb.weights_from_jax(bad, "fixed", device="cpu", kernel="dense")
        if cfg == VOIP:      # c-minor -> accumulator-major columns
            R = tspec.group * tspec.den
            w16 = 256 * jw[0].astype(np.int32) + jw[1]
            assert np.array_equal(got[0][:, 2 * R + 5].numpy(),
                                  w16[:, 5 * 4 + 2])
            assert np.array_equal(got[1].numpy(), jw[3].T)


@pytest.mark.parametrize("fixed", [False, True], ids=["float", "fixed"])
def test_tiled_checkpoint_loads_in_a_capped_dense_engine(fixed):
    """A tiled engine's state (after a flush moved f0, with staged frames)
    restores in a voip-capped dense engine of the same config (history
    re-laid out from 16-aligned rows to filt_len-1), and both continue to
    the same samples (fixed bit for bit)."""
    i, o, q, ms = VOIP
    src = BatchedResampler(S, C, i, o, q, device="cpu", fixed_point=fixed,
                           scheme="highest" if not fixed else "auto")
    dst = BatchedResampler(S, C, i, o, q, device="cpu", fixed_point=fixed,
                           max_latency_ms=ms)
    assert (src.bspec.kernel, dst.bspec.kernel) == ("tiled", "dense")
    src.process(_frames(5000, 1))
    src.flush()
    src.process(_frames(1300, 2))
    state = src.state_dict()
    assert state["f0"] != 0 and len(state["staged"])
    dst.load_state_dict(state)
    assert dst._hist.shape[0] == dst.spec.filt_len - 1
    outs = {}
    for eng in (src, dst):
        outs[eng] = np.concatenate([eng.process(_frames(2500, 3)),
                                    eng.process(_frames(900, 4)),
                                    eng.flush()], axis=1)
    assert outs[src].shape == outs[dst].shape
    if fixed:
        assert np.array_equal(outs[src], outs[dst])
    else:
        assert_lsb_close(outs[src].ravel(), outs[dst].ravel())


@pytest.mark.parametrize("fixed", [False, True], ids=["float", "fixed"])
@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_dense_checkpoint_crosses_packages(direction, fixed):
    jax_eng, port = _engines(VOIP, fixed)
    src, dst = (jax_eng, port) if direction == "jax-to-port" \
        else (port, jax_eng)
    src.process(_frames(3000, 1))
    src.flush()
    src.process(_frames(600, 2))
    state = src.state_dict()
    assert state["f0"] != 0 and len(state["staged"])
    dst.load_state_dict(state)
    for n, seed in ((2500, 3), (900, 4)):
        f = _frames(n, seed)
        g, w = dst.process(f), src.process(f)
        assert g.shape == w.shape
        if fixed:
            assert np.array_equal(g, w)
        else:
            assert_lsb_close(g.ravel(), w.ravel())
    g, w = dst.flush(), src.flush()
    assert g.shape == w.shape


def test_dense_wrapper_guards():
    """On CPU tensors the wrapper runs the plain version and counts no
    launch; weights of the wrong type or taps of the wrong shape and a
    device without a kernel are refused."""
    _, tstep, tspec = _steps(VOIP, 0)
    hist, x = (torch.from_numpy(a) for a in
               launch_inputs(tstep, tspec.in_per_launch, 3, 0, wrap=False))
    kw = tstep.kernel_kw
    w, taps = tstep.w
    with pytest.raises(TypeError):
        tdf.resample_dense(hist, x, (w.double(), taps), **kw)
    with pytest.raises(ValueError):
        tdf.resample_dense(hist, x, (w, taps[:, :2]), **kw)
    with pytest.raises(ValueError):
        tdf.resample_dense(hist, x, tstep.w, stride=kw["stride"] + 1,
                           n_blocks=kw["n_blocks"], R=kw["R"])
    meta = torch.empty(hist.shape, dtype=torch.int16, device="meta")
    with pytest.raises(ValueError):
        tdf.resample_dense(meta, x, tstep.w, **kw)
