"""The port's native FIR twins, and its copies of the JAX package's
``ops/fir_exact.py``, ``ops/fir_fixed.py`` and ``models/presets.py``.

Each of the four ctypes bindings (``runtime/native.fir_{f32,q15}_{direct,
interp}``) equals the NumPy loops it twins bit for bit, and the port's
loops equal the JAX package's (native against native, NumPy against
NumPy), over direct and interpolated filters, both universes, the single
and double float accumulators, nonzero phase origins and a lazy huge-den
spec.  Also: the loop counters, the NumPy fallback with its logged warning
when the runtime cannot be built, and the presets' table and ``describe``.
"""

import logging

import numpy as np
import pytest

import speex_resampler_tpu.ops.fir_exact as jfe
import speex_resampler_tpu.ops.fir_fixed as jff
from speex_resampler_tpu.models import presets as jpresets
import speex_resampler_tpu_torch.ops.fir_exact as fe
import speex_resampler_tpu_torch.ops.fir_fixed as ff
from speex_resampler_tpu_torch.models import presets
from speex_resampler_tpu_torch.ops import filter_design as fd
from speex_resampler_tpu_torch.runtime import native as rt
from speex_resampler_tpu_torch.utils.errors import ResamplerError

CONFIGS = [
    # (in_rate, out_rate, q): every native code path
    (8000, 48000, 3),     # direct, den 6, the phase-grouped path
    (8000, 48000, 10),    # direct, double (q > 8: f64 accumulators)
    (48000, 16000, 9),    # direct, double, downsampling
    (44100, 48000, 5),    # interpolated, single (den 160)
    (48000, 44100, 10),   # interpolated, double
    (96000, 11025, 0),    # interpolated, q0
    (44100, 44101, 7),    # den 44101: the lazy-table regime
]


def _spec(in_rate, out_rate, q, fixed):
    import math
    g = math.gcd(in_rate, out_rate)
    return fd.design_filter(in_rate // g, out_rate // g, q, fixed_point=fixed)


def _run(mod, X, ls0, f0, n_out, spec):
    if spec.fixed_point:
        return mod.resample_fixed(X, ls0, f0, n_out, spec)
    return mod.resample_exact_state(X, ls0, f0, n_out, spec)


def _numpy(monkeypatch, *mods):
    """Disable the native hook of each module (its NumPy loops serve)."""
    for m in mods:
        name = "_native_fixed" if m in (ff, jff) else "_native_exact"
        monkeypatch.setattr(m, name, lambda *a, **k: None)


@pytest.fixture(autouse=True)
def _runtime():
    assert rt.load_runtime() is not None, "g++ build of the runtime failed"


@pytest.mark.parametrize("in_rate,out_rate,q", CONFIGS)
@pytest.mark.parametrize("fixed", [False, True])
@pytest.mark.parametrize("origin", [(0, 0), (17, -1)])
def test_twins_equal_numpy_and_jax(monkeypatch, in_rate, out_rate, q, fixed,
                                   origin):
    """Port native == port NumPy == JAX native == JAX NumPy, at f0 0 and
    at a mid-stream origin (ls0 17, f0 den - 1)."""
    spec = _spec(in_rate, out_rate, q, fixed)
    rng = np.random.default_rng(q * 7 + fixed)
    X = rng.integers(-32768, 32768, (2, 8192)).astype(
        np.int16 if fixed else np.float32)
    ls0, f0 = origin[0], origin[1] % spec.den
    n_out = max(4, min(((8192 - ls0 - spec.filt_len) * spec.den - f0)
                       // spec.num // 2, 3000))
    loops = ff.loops if fixed else fe.loops
    before = dict(loops)
    port_native = _run(ff if fixed else fe, X, ls0, f0, n_out, spec)
    assert loops["native"] == before["native"] + 1
    jax_native = _run(jff if fixed else jfe, X, ls0, f0, n_out, spec)
    _numpy(monkeypatch, fe, ff, jfe, jff)
    port_np = _run(ff if fixed else fe, X, ls0, f0, n_out, spec)
    assert loops["numpy"] == before["numpy"] + 1
    jax_np = _run(jff if fixed else jfe, X, ls0, f0, n_out, spec)
    assert port_native.dtype == np.int16
    for y in (port_np, jax_native, jax_np):
        assert np.array_equal(port_native, y)
    if not fixed:
        # the raw (process_float) sums of both packages' loops
        monkeypatch.undo()
        raw = fe.resample_exact_state(X, ls0, f0, n_out, spec, raw=True)
        assert raw.dtype == np.float32
        assert np.array_equal(raw, jfe.resample_exact_state(
            X, ls0, f0, n_out, spec, raw=True))


@pytest.mark.parametrize("binding", ["fir_q15_direct", "fir_q15_interp",
                                     "fir_f32_direct", "fir_f32_interp"])
def test_each_binding_equals_numpy_slices(binding):
    """Each binding called directly equals the NumPy slice loop of its
    module (fixed_output_slice, _direct_slice, _interp_slice)."""
    fixed = "q15" in binding
    direct = "direct" in binding
    spec = _spec(*((8000, 48000, 4) if direct else (44100, 48000, 6)),
                 fixed)
    rng = np.random.default_rng(3)
    X = rng.integers(-32768, 32768, (3, 4096)).astype(
        np.int16 if fixed else np.float32)
    t = 5 + np.arange(700, dtype=np.int64) * spec.num
    starts, phases = 2 + t // spec.den, t % spec.den
    fn = getattr(rt, binding)
    if fixed:
        want = ff.fixed_output_slice(X, starts, phases, spec)
        got = (fn(X, spec.phase_table, starts, phases) if direct else
               fn(X, spec.interp_taps, spec.interp_coef, starts, phases))
    elif direct:
        want = fe._direct_slice(X, starts, phases,
                                spec.phase_table.astype(np.float32),
                                double=False, raw=True)
        got = fn(X, spec.phase_table, starts, phases, False,
                 num=spec.num, den=spec.den)
    else:
        want = fe._interp_slice(X, starts, phases, spec, double=False,
                                raw=True)
        got = fn(X, spec.sinc_table, spec.oversample, spec.den,
                 spec.filt_len, starts, phases, False)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_float_interp_guard_refuses_out_of_table_offsets():
    """The float interpolated twin reads taps at offset + 4 + j*ov; where
    an offset (phase * ov mod 2^32) // den exceeds ov + 2 the hook returns
    None and the NumPy loop (which defines that gather) serves the call,
    as in the JAX package."""
    spec = _spec(44100, 48000, 5, False)
    assert not spec.use_direct
    X = np.zeros((1, 4096), np.float32)
    starts = np.zeros(2, np.int64)
    phases = np.array([0, 2 * spec.den], np.int64)
    assert (2 * spec.den * spec.oversample) // spec.den > spec.oversample + 2
    assert fe._native_exact(X, starts, phases, spec, False) is None
    assert jfe._native_exact(X, starts, phases, spec, False) is None
    assert fe._native_exact(X, starts[:1], phases[:1], spec,
                            False) is not None


def test_unbuildable_runtime_falls_back_with_a_warning(monkeypatch, caplog):
    """Without the runtime every binding returns None, one warning is
    logged, and the loops' NumPy path gives the same bits."""
    spec = _spec(44100, 48000, 5, True)
    X = np.random.default_rng(2).integers(-32768, 32768, (2, 4096)).astype(
        np.int16)
    want = ff.resample_fixed(X, 0, 0, 900, spec)
    monkeypatch.setattr(rt, "load_runtime", lambda: None)
    monkeypatch.setattr(rt, "_fir_warned", False)
    before = ff.loops["numpy"]
    with caplog.at_level(logging.WARNING, logger=rt.__name__):
        got = ff.resample_fixed(X, 0, 0, 900, spec)
        assert rt.fir_q15_direct(X, spec.interp_taps[:, 0], np.zeros(1),
                                 np.zeros(1)) is None
    assert np.array_equal(got, want) and ff.loops["numpy"] == before + 1
    warnings = [r for r in caplog.records if "NumPy loops" in r.message]
    assert len(warnings) == 1


def test_binding_rejects_mismatched_indices():
    spec = _spec(8000, 48000, 4, True)
    X = np.zeros((1, 512), np.int16)
    with pytest.raises(ResamplerError):
        rt.fir_q15_direct(X, spec.phase_table, np.zeros(4, np.int64),
                          np.zeros(3, np.int64))


def test_presets_equal_jax():
    assert list(presets.PRESETS) == list(jpresets.PRESETS)
    for name, p in presets.PRESETS.items():
        j = jpresets.PRESETS[name]
        assert (p.name, p.quality, p.target_chunk_ms, p.description,
                p.hard_latency) == (j.name, j.quality, j.target_chunk_ms,
                                    j.description, j.hard_latency)
        for rate in (8000, 44100, 96000):
            assert p.engine_kwargs(rate) == j.engine_kwargs(rate)
        for rates in ((44100, 48000), (48000, 8000), (24000, 24000)):
            assert presets.describe(name, *rates) == jpresets.describe(
                name, *rates)
    with pytest.raises(KeyError, match="unknown preset"):
        presets.get_preset("studio")
