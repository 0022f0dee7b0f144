"""The port's fixed-point (Q15) universe against the JAX package, bit for bit.

``BatchedResampler(fixed_point=True)`` serves the speexdsp ``-DFIXED_POINT``
build: int16 taps, int32 accumulators that wrap, Q15 epilogues.  Its
contract is bit-exact, so every comparison here counts 0 mismatches:

- the torch epilogue twins (``ops/fixed_math``) against the NumPy macros
  and the JAX package's jnp twins at the int32 edges;
- the plain tiled and streamed versions (what the CUDA kernels are held
  against on the card) against ``resample_conv_tm_pallas_v3`` /
  ``_v4(scheme="fixed")`` in interpret mode, reached through each package's
  ``make_batched_step``, with random lanes and lanes carrying the wrap input
  (an accumulator past 2^31, ``fixed_inputs.wrap_input``);
- the CPU engine against the JAX fixed engine (interpret) and against the
  JAX package's host loops (``ops/fir_fixed.resample_fixed``) through
  process / flush / process;
- launch geometry, weights carried over from JAX steps, and checkpoints.

The JAX engine runs with ``use_pallas=True, pallas_interpret=True``: its
CPU default sends fixed specs to the dense XLA path, another geometry.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from speex_resampler_tpu.ops import filter_design as jfd
from speex_resampler_tpu.ops import fir_fixed
from speex_resampler_tpu.ops import fixed_math as jfm
from speex_resampler_tpu.parallel import batch as jb
from speex_resampler_tpu.parallel.batch import BatchedResampler as JaxEngine
from speex_resampler_tpu_torch import (BatchedResampler, ResamplerError,
                                       ResamplerErrorCode)
from speex_resampler_tpu_torch.ops import filter_design as tfd
from speex_resampler_tpu_torch.ops import fixed_math as tfm
from speex_resampler_tpu_torch.ops import phase as tph
from speex_resampler_tpu_torch.ops import streamed_fir as tsf
from speex_resampler_tpu_torch.ops import tiled_fir as ttf
from speex_resampler_tpu_torch.parallel import batch as tb

from conftest import AUDIO_TESTS
from fixed_inputs import launch_inputs

torch.set_num_threads(1)

# (in, out, quality, target_chunk_frames)
FLAGSHIP = (44100, 48000, 7, 2352)      # tiled, n_accum 4 (R 128, P 20)
DIRECT = (24000, 48000, 5, 2560)        # tiled, n_accum 1 (R 256, P 1)
SLICE = (48000, 44100, 10, 20480)       # streamed, n_accum 4 (P 147)
I32_MIN, I32_MAX = -2 ** 31, 2 ** 31 - 1


def _specs(i, o, q):
    g = math.gcd(i, o)
    return (jfd.design_filter(i // g, o // g, q, fixed_point=True),
            tfd.design_filter(i // g, o // g, q, fixed_point=True))


def _flush_f0(spec, staged: int) -> int:
    """Fractional phase a flush of ``staged`` frames leaves (from f0 0)."""
    m = tph.producible_outputs(staged, 0, 0, spec.num, spec.den)
    return (m * spec.num) % spec.den


def _steps(cfg, f0: int, kernel=None):
    """The JAX and port fixed steps of cfg at f0.  ``kernel="streamed"``
    on a tiled direct config feeds its weights (padded to K_pad) to the
    streamed kernel in both packages."""
    i, o, q, target = cfg
    js, ts = _specs(i, o, q)
    jspec = jb._launch_geometry(js, target, use_pallas=True, f0=f0)
    tspec = tb._launch_geometry(ts, target, f0=f0)
    assert dataclasses.asdict(jspec) == dataclasses.asdict(tspec)
    if kernel is not None:
        jspec = dataclasses.replace(jspec, kernel=kernel)
        tspec = dataclasses.replace(tspec, kernel=kernel)
    jstep = jb.make_batched_step(js, jspec, use_pallas=True,
                                 pallas_interpret=True)
    tstep = tb.make_batched_step(ts, tspec, device="cpu")
    assert jstep.scheme == tstep.scheme == "fixed"
    for f in ("hist_rows", "chunk_rows", "zero_tail"):
        assert getattr(jstep, f) == getattr(tstep, f), f
    return jstep, tstep, tspec


def _launch_matches_jax(jstep, tstep, tspec, B, seed):
    hist, x = launch_inputs(tstep, tspec.in_per_launch, B, seed)
    jh, jy = jstep.fn(hist, x, jstep.w)
    th, ty = tstep.fn(torch.from_numpy(hist), torch.from_numpy(x), tstep.w)
    assert ty.shape == (tspec.out_per_launch, B)
    assert int((ty.numpy() != np.asarray(jy)).sum()) == 0
    assert np.array_equal(th.numpy(), np.asarray(jh))


# -- epilogue twins ---------------------------------------------------------

def _edge_sums(rng):
    hi = 32767 << 15
    edges = [I32_MIN, I32_MIN + 1, I32_MAX, I32_MAX - (1 << 14),
             I32_MAX - (1 << 14) + 1, hi - 1, hi, hi + 1, -hi - 1, -hi,
             -hi + 1, 0, 1, -1, 1 << 14, -(1 << 14), (1 << 14) - 1]
    rand = rng.integers(I32_MIN, I32_MAX, 4000, dtype=np.int64)
    return np.concatenate([edges, rand]).astype(np.int32)


def test_epilogue_twins_match_numpy_and_jax_at_the_edges():
    """SATURATE32PSHR (low clamp -32767), MULT16_32_Q15 and the cubic mix,
    in int32 with wraparound: the torch twins equal the NumPy macros and
    the jnp twins at INT32_MIN/MAX, +-(32767<<15) +-1 and coef = -32768."""
    import jax.numpy as jnp
    rng = np.random.default_rng(0)
    s = _edge_sums(rng)
    want = tfm.to_word16(tfm.saturate32pshr(s, 15, 32767))
    got = tfm.sat32pshr15(torch.from_numpy(s)).numpy()
    assert got.dtype == np.int16 and np.array_equal(got, want)
    assert np.array_equal(got, np.asarray(jfm.sat32pshr15_jax(jnp.asarray(s))))
    assert got[list(s).index(I32_MIN)] == -32767

    a = np.resize(np.array([-32768, 32767, -1, 0, 1, -32767], np.int32),
                  s.shape)
    want = tfm.mult16_32_q15(a, s)
    got = tfm.mult16_32_q15_t(torch.from_numpy(a), torch.from_numpy(s))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), np.asarray(
        jfm.mult16_32_q15_jax(jnp.asarray(a), jnp.asarray(s))))

    R, lanes = 8, s.size // 32
    acc = s[:4 * R * lanes].reshape(4, R, lanes)
    coef = np.resize(np.array([-32768, 32767, -1, 12345, 0], np.int32),
                     (4, R))
    want = tfm.interp_mix_fixed(acc.transpose(1, 2, 0),
                                coef.T[:, None, :])          # [R, lanes]
    got = tfm.fixed_interp_mix_rows(torch.from_numpy(acc),
                                    torch.from_numpy(coef)).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got, np.asarray(jfm.fixed_interp_mix_rows_jax(
        jnp.asarray(acc.reshape(4 * R, lanes)), jnp.asarray(coef))))


def test_wrap_int32_wraps_like_the_accumulator():
    v = torch.tensor([2 ** 31, 2 ** 32 + 5, -2 ** 31 - 1, 2 ** 39 + 3, -7],
                     dtype=torch.float64)
    want = np.array([2 ** 31, 2 ** 32 + 5, -2 ** 31 - 1, 2 ** 39 + 3, -7],
                    dtype=np.int64).astype(np.int32)
    assert np.array_equal(ttf.wrap_int32(v).numpy(), want)


# -- plain versions against the JAX kernels ----------------------------------

@pytest.mark.parametrize("B", [4, 130])
@pytest.mark.parametrize("f0", ["0", "flush"])
@pytest.mark.parametrize("cfg", [FLAGSHIP, DIRECT],
                         ids=["44k1-48k-q7-n_accum4", "24k-48k-q5-n_accum1"])
def test_plain_tiled_matches_jax_v3(cfg, f0, B):
    """f0 "flush": the phase a flush of 3368 staged frames leaves at the
    flagship; at 24k->48k (num 1, den 2) every flush leaves 0, so the
    other phase, 1, stands in."""
    _, ts = _specs(*cfg[:3])
    if f0 == "flush":
        f0 = 1 if cfg == DIRECT else _flush_f0(ts, 3368)
        assert f0 != 0
    jstep, tstep, tspec = _steps(cfg, int(f0))
    assert tstep.kernel == "tiled"
    assert tstep.kernel_kw["n_accum"] == (1 if cfg == DIRECT else 4)
    _launch_matches_jax(jstep, tstep, tspec, B, seed=B + int(f0))


@pytest.mark.parametrize("cfg,kernel,f0,B", [
    (SLICE, None, 0, 130), (SLICE, None, 40, 4),
    (DIRECT, "streamed", 0, 4), (DIRECT, "streamed", 1, 130)],
    ids=["48k-44k1-q10-f0-0", "48k-44k1-q10-f0-40", "direct-streamed-f0-0",
         "direct-streamed-f0-1"])
def test_plain_streamed_matches_jax_v4(cfg, kernel, f0, B):
    """n_accum 4 at 48k->44.1k q10, and n_accum 1: a direct spec's weights
    fed to the streamed kernel (no direct config is streamed by itself)."""
    jstep, tstep, tspec = _steps(cfg, f0, kernel)
    assert tstep.kernel == "streamed"
    assert tstep.kernel_kw["n_accum"] == (1 if cfg == DIRECT else 4)
    assert tstep.w[0].shape[-1] % 128 == 0           # K_pad
    _launch_matches_jax(jstep, tstep, tspec, B, seed=B + f0)


def test_wrapper_guards_and_cpu_tensors_never_launch():
    _, tstep, tspec = _steps(FLAGSHIP, 0)
    hist, x = (torch.from_numpy(a) for a in
               launch_inputs(tstep, tspec.in_per_launch, 3, seed=0))
    kw = tstep.kernel_kw
    before = dict(tsf.launches)
    y = tsf.resample_streamed(hist, x, tstep.w, **kw)
    assert tsf.launches == before
    assert torch.equal(y, tsf.resample_streamed_reference(hist, x, tstep.w,
                                                          **kw))
    with pytest.raises(ValueError):
        tsf.resample_streamed(hist, x, tstep.w, **{**kw, "n_accum": 1})
    with pytest.raises(ValueError):
        tsf.resample_streamed(hist, x, tstep.w, **{**kw, "n_accum": 2})
    with pytest.raises(ValueError):
        tsf.resample_streamed(hist, x, tstep.w,
                              **{**kw, "scheme": "highest", "n_accum": 4})
    with pytest.raises(TypeError):
        tsf.resample_streamed(hist, x, (tstep.w[0].int(), *tstep.w[1:]),
                              **kw)


# -- geometry and weights -----------------------------------------------------

FIXED_CFGS = sorted({(i, o, q) for (_, i, o, _, q) in AUDIO_TESTS}
                    | {(48000, 44100, 10), (44100, 16000, 7)})


@pytest.mark.parametrize("cfg", FIXED_CFGS, ids=lambda c: "%d-%d-q%d" % c)
def test_fixed_geometry_equal(cfg):
    """BatchSpec (the kernel choice under the 6 MB fixed tiled cap
    included), R, every component's phase-tiled weights and offsets, and
    the Q15 cubic coefficients equal the JAX package's, at f0 0 and at the
    phase a flush leaves."""
    js, ts = _specs(*cfg)
    for target in (4096, 9408):
        jspec = jb._launch_geometry(js, target, use_pallas=True)
        tspec = tb._launch_geometry(ts, target)
        assert jspec.kernel in ("tiled", "streamed")
        assert dataclasses.asdict(jspec) == dataclasses.asdict(tspec)
    assert jb._tiled_R(js) == tb._tiled_R(ts)
    assert jb._tiled_weight_bytes_estimate(js) == \
        tb._tiled_weight_bytes_estimate(ts)
    n_cols = 1 if ts.use_direct else 4
    for f0 in (0, _flush_f0(ts, 3368)):
        for c in range(n_cols):
            jw = jb._tiled_weights(js, f0, component=c)
            tw = tb._tiled_weights(ts, f0, component=c)
            assert (jw.S, jw.R, jw.P, jw.K) == (tw.S, tw.R, tw.P, tw.K)
            assert np.array_equal(jw.offsets, tw.offsets)
            assert jw.w.dtype == tw.w.dtype == np.int16
            assert np.array_equal(jw.w, tw.w)
        if n_cols == 4:
            assert np.array_equal(jb._fixed_coef(js, f0, tw.P, tw.R),
                                  tb._fixed_coef(ts, f0, tw.P, tw.R))
    if cfg == (44100, 48000, 10):
        # float: tiled; fixed: 4 column sets of int16 pass the 6 MB cap
        assert tspec.kernel == "streamed"
        assert tb._launch_geometry(tfd.design_filter(147, 160, 10),
                                   4096).kernel == "tiled"


@pytest.mark.parametrize("cfg,kernel", [(FLAGSHIP, "tiled"),
                                        (DIRECT, "tiled"),
                                        (SLICE, "streamed")],
                         ids=["44k1-48k-q7", "24k-48k-q5", "48k-44k1-q10"])
def test_weights_from_jax_equal_port_weights(cfg, kernel):
    """JAX's int8 planes [2, P, C, K] (tiled) / [P, 2, C, K_pad] (streamed),
    bias and coefficients -> the port's K-major planes [2, P, C, K_pad],
    bias, coef, band widths and tap table, equal to the port's own step;
    a wrong bias is refused."""
    jstep, tstep, _ = _steps(cfg, 0)
    assert tstep.kernel == kernel
    jw = tuple(np.asarray(a) for a in jstep.w)
    got = tb.weights_from_jax(jw, "fixed", device="cpu", kernel=kernel)
    assert len(got) == len(tstep.w) == (4 if cfg == DIRECT else 5)
    assert got[-2].slices == tstep.w[-2].slices
    for a, b in zip(got[:-2] + got[-1:], tstep.w[:-2] + tstep.w[-1:]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    bad = (jw[0], jw[1] + 1, *jw[2:])
    with pytest.raises(ValueError, match="bias"):
        tb.weights_from_jax(bad, "fixed", device="cpu", kernel=kernel)


# -- the engine ---------------------------------------------------------------

S, C = 2, 2
CALLS = (3000, 1100, 2500)       # the flush after them moves f0
AFTER = (2600, 700)
# 48k->44.1k: two launches, a flush of 4040 staged frames (f0 -> 40), one
# more launch, and a flush that brings f0 back to 0 (the memoized step)
SCHEDULES = {SLICE: ((25000, 7000, 13000), (22040,))}


def _frames(n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-32768, 32768, (S, n, C), dtype=np.int16)


def _drive(eng, calls, after, seed=5):
    outs = [eng.process(_frames(n, seed + k)) for k, n in enumerate(calls)]
    outs.append(eng.flush())
    f0_flush = eng._f0
    outs += [eng.process(_frames(n, seed + 10 + k))
             for k, n in enumerate(after)]
    outs.append(eng.flush())
    return outs, f0_flush


@pytest.mark.parametrize("cfg", [FLAGSHIP, SLICE, DIRECT],
                         ids=["44k1-48k-q7-tiled", "48k-44k1-q10-streamed",
                              "24k-48k-q5-direct"])
def test_engine_matches_jax_and_host_loops(cfg):
    """process / flush / process: the CPU engine equals the JAX fixed engine
    call by call, and the whole stream equals the JAX package's host loops
    (ops/fir_fixed.resample_fixed) lane by lane."""
    i, o, q, target = cfg
    calls, after = SCHEDULES.get(cfg, (CALLS, AFTER))
    jax_eng = JaxEngine(S, C, i, o, q, target_chunk_frames=target,
                        use_pallas=True, pallas_interpret=True,
                        fixed_point=True)
    port = BatchedResampler(S, C, i, o, q, target_chunk_frames=target,
                            device="cpu", fixed_point=True)
    assert port.bspec.kernel == jax_eng.bspec.kernel == port._step.kernel
    assert port._step.scheme == jax_eng._step.scheme == "fixed"
    want, jf0 = _drive(jax_eng, calls, after)
    got, f0 = _drive(port, calls, after)
    assert f0 == jf0 and port._f0 == jax_eng._f0
    if cfg != DIRECT:
        assert f0 != 0
    assert port.launches > len(calls)
    for g, w in zip(got, want):
        assert g.shape == w.shape and int((g != w).sum()) == 0

    frames = np.concatenate(
        [_frames(n, 5 + k) for k, n in enumerate(calls)]
        + [_frames(n, 15 + k) for k, n in enumerate(after)], axis=1)
    y = np.concatenate(got, axis=1)                    # [S, m, C]
    spec = port.spec
    n_out = tph.producible_outputs(frames.shape[1], 0, 0, spec.num, spec.den)
    assert y.shape[1] == n_out
    X = np.concatenate([np.zeros((S, spec.filt_len - 1, C), np.int16),
                        frames], axis=1)
    X = X.transpose(0, 2, 1).reshape(S * C, -1)        # [B, T]
    ref = fir_fixed.resample_fixed(X, 0, 0, n_out, _specs(i, o, q)[0])
    assert np.array_equal(y.transpose(0, 2, 1).reshape(S * C, -1), ref)


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_checkpoint_crosses_packages(direction):
    """A fixed checkpoint (after a flush: f0 != 0, staged frames) restores
    in the other package's fixed engine and continues bit for bit."""
    i, o, q, target = FLAGSHIP
    jax_eng = JaxEngine(S, C, i, o, q, target_chunk_frames=target,
                        use_pallas=True, pallas_interpret=True,
                        fixed_point=True)
    port = BatchedResampler(S, C, i, o, q, target_chunk_frames=target,
                            device="cpu", fixed_point=True)
    src, dst = (jax_eng, port) if direction == "jax-to-port" \
        else (port, jax_eng)
    src.process(_frames(3000, 1))
    src.flush()
    src.process(_frames(1300, 2))
    state = src.state_dict()
    assert state["fixed_point"] is True
    assert state["f0"] != 0 and len(state["staged"])
    dst.load_state_dict(state)
    for n, seed in ((2500, 3), (900, 4)):
        f = _frames(n, seed)
        assert np.array_equal(dst.process(f), src.process(f))
    assert np.array_equal(dst.flush(), src.flush())


def test_universes_refuse_each_others_checkpoints():
    args = (S, C, 44100, 48000, 7)
    fixed = BatchedResampler(*args, device="cpu", fixed_point=True)
    flt = BatchedResampler(*args, device="cpu", scheme="highest")
    fixed.process(_frames(3000, 1))
    flt.process(_frames(3000, 1))
    for src, dst in ((fixed, flt), (flt, fixed)):
        with pytest.raises(ResamplerError) as e:
            dst.load_state_dict(src.state_dict())
        assert e.value.code == ResamplerErrorCode.INVALID_ARG
    assert fixed.state_dict()["fixed_point"] is True
    assert flt.state_dict()["fixed_point"] is False


@pytest.mark.parametrize("scheme", ["int8", "highest", "split5", "INT8"])
def test_float_scheme_on_a_fixed_engine_raises(scheme):
    """The fixed universe has one exact scheme ("auto" or "fixed"); any
    other request is INVALID_ARG, as in the JAX package.  A float engine
    refuses "fixed" the same way."""
    with pytest.raises(ResamplerError) as e:
        BatchedResampler(S, C, 44100, 48000, 7, device="cpu",
                         fixed_point=True, scheme=scheme)
    assert e.value.code == ResamplerErrorCode.INVALID_ARG
    eng = BatchedResampler(S, C, 44100, 48000, 7, device="cpu",
                           fixed_point=True, scheme="fixed")
    assert eng._step.scheme == "fixed"
    with pytest.raises(ResamplerError):
        BatchedResampler(S, C, 44100, 48000, 7, device="cpu",
                         scheme="fixed")


@pytest.mark.parametrize("cfg", [FLAGSHIP, SLICE],
                         ids=["44k1-48k-q7-tiled", "48k-44k1-q10-streamed"])
def test_fixed_latency_cap_requantizes_like_jax(cfg):
    """A max_latency_ms cap on a fixed config is re-quantized within its
    geometry (tiled units of S * periods per program, streamed units of
    S), as the JAX package does; a cap below one unit goes to the dense
    geometry, as in the JAX package."""
    js, ts = _specs(*cfg[:3])
    S = tb._launch_geometry(ts, 4096).S
    unit = S * (1 if cfg == SLICE else 20 // tb._launch_geometry(ts, 4096).P)
    for target, cap in ((4 * unit, int(1.7 * unit)), (10 * unit, 10 * unit),
                        (unit // 2, unit)):
        jspec = jb._launch_geometry(js, target, use_pallas=True,
                                    max_in_frames=cap)
        tspec = tb._launch_geometry(ts, target, max_in_frames=cap)
        assert jspec.in_per_launch <= cap
        assert dataclasses.asdict(jspec) == dataclasses.asdict(tspec)
    jspec = jb._launch_geometry(js, unit, use_pallas=True,
                                max_in_frames=unit - 1)
    tspec = tb._launch_geometry(ts, unit, max_in_frames=unit - 1)
    assert tspec.kernel == "dense" and tspec.in_per_launch <= unit - 1
    assert dataclasses.asdict(jspec) == dataclasses.asdict(tspec)


def test_step_cache_holds_the_fixed_slice_beside_the_float_one():
    """48k->44.1k q10: the fixed step (int16 [147, 512, 512], 77 MB) at two
    phases and the float highest step (f32, 38.5 MB) stay memoized
    together under the 256 MB bound."""
    _, fixed = _specs(*SLICE[:3])
    flt = tfd.design_filter(160, 147, 10)
    keys = [(fixed, 0, "auto"), (fixed, 40, "auto"), (flt, 0, "highest")]

    def step(spec, f0, scheme):
        return tb.make_batched_step(
            spec, tb._launch_geometry(spec, SLICE[3], f0=f0), device="cpu",
            scheme=scheme)

    steps = [step(*k) for k in keys]
    assert tb._step_weight_bytes(steps[0]) >= 147 * 512 * 512 * 2
    assert sum(map(tb._step_weight_bytes, steps)) \
        <= tb._STEP_CACHE_MAX_BYTES
    for k, s in zip(keys, steps):
        assert step(*k) is s


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchedResampler(S, C, 44100, 48000, 7, fixed_point=True)
