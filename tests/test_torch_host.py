"""The PyTorch port's host layer equals the JAX package's bit for bit.

The port copies the JAX package's NumPy filter design, phase arithmetic,
launch geometry and int8 digit-plane decomposition (it must not import the
JAX package, whose __init__ loads jax).  These tests pin the copies to the
originals over the reference's integration matrix plus the streamed
48k->44.1k q10 config, which the port must refuse.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from speex_resampler_tpu.ops import filter_design as jfd
from speex_resampler_tpu.ops import pallas_fir as jpf
from speex_resampler_tpu.parallel import batch as jb
from speex_resampler_tpu_torch.ops import filter_design as tfd
from speex_resampler_tpu_torch.ops import phase as tph
from speex_resampler_tpu_torch.ops import tiled_fir as ttf
from speex_resampler_tpu_torch.parallel import batch as tb
from speex_resampler_tpu_torch import BatchedResampler

from conftest import AUDIO_TESTS

torch.set_num_threads(1)

TILED = sorted({(i, o, q) for (_, i, o, _, q) in AUDIO_TESTS})
STREAMED = [(48000, 44100, 10)]


def _specs(cfg):
    i, o, q = cfg
    g = math.gcd(i, o)
    return (jfd.design_filter(i // g, o // g, q),
            tfd.design_filter(i // g, o // g, q))


def _flush_f0(spec, staged: int) -> int:
    """Fractional phase a flush of ``staged`` frames leaves (from f0 0)."""
    m = tph.producible_outputs(staged, 0, 0, spec.num, spec.den)
    return (m * spec.num) % spec.den


@pytest.mark.parametrize("cfg", TILED + STREAMED)
def test_filter_spec_equal(cfg):
    js, ts = _specs(cfg)
    for f in dataclasses.fields(js):
        a, b = getattr(js, f.name), getattr(ts, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        elif f.name != "_phase_table":
            assert a == b, f.name
    assert js.phase_table.dtype == ts.phase_table.dtype
    assert np.array_equal(js.phase_table, ts.phase_table)
    assert (js.input_latency, js.output_latency) == (ts.input_latency,
                                                     ts.output_latency)


@pytest.mark.parametrize("cfg", TILED + STREAMED)
def test_launch_geometry_equal(cfg):
    """Tiled configs: BatchSpec, R, phase-tiled weights and offsets equal
    (at f0 0 and at the phase a flush leaves).  The streamed config: the
    JAX package picks the streamed kernel, the port refuses it."""
    js, ts = _specs(cfg)
    for target in (4096, 9408):
        jspec = jb._launch_geometry(js, target, use_pallas=True)
        if cfg in STREAMED:
            assert jspec.kernel == "streamed"
            with pytest.raises(NotImplementedError, match="K2"):
                tb._launch_geometry(ts, target)
            continue
        assert jspec.kernel == "tiled"
        assert dataclasses.asdict(jspec) == dataclasses.asdict(
            tb._launch_geometry(ts, target))
    if cfg in STREAMED:
        with pytest.raises(NotImplementedError):
            BatchedResampler(1, 1, *cfg, device="cpu")
        return
    assert jb._tiled_R(js) == tb._tiled_R(ts)
    assert jb._hist_rows_tiled(js.filt_len) == tb._hist_rows_tiled(
        ts.filt_len)
    for f0 in (0, _flush_f0(ts, 3368)):
        jw, tw = jb._tiled_weights(js, f0), tb._tiled_weights(ts, f0)
        assert (jw.S, jw.R, jw.P, jw.K) == (tw.S, tw.R, tw.P, tw.K)
        assert np.array_equal(jw.offsets, tw.offsets)
        assert jw.w.dtype == tw.w.dtype and np.array_equal(jw.w, tw.w)


@pytest.mark.parametrize("cfg", TILED)
def test_step_contract_and_int8_planes_equal(cfg):
    """hist_rows / chunk_rows / zero_tail of the built steps, the int8
    planes, bias, scales and certificate for 3 and 4 digits, and the
    digit count "auto" resolves (D=3, or 4 for the q10 filters)."""
    js, ts = _specs(cfg)
    jspec = jb._launch_geometry(js, 9408, use_pallas=True)
    tspec = tb._launch_geometry(ts, 9408)
    jstep = jb.make_batched_step(js, jspec, use_pallas=True,
                                 pallas_interpret=True, scheme="int8")
    tstep = tb.make_batched_step(ts, tspec, device="cpu", scheme="int8")
    for f in ("hist_rows", "chunk_rows", "zero_tail", "scheme"):
        assert getattr(jstep, f) == getattr(tstep, f), f
    assert np.array_equal(np.asarray(jstep.w[0]), tstep.w[0].numpy())
    assert np.array_equal(np.asarray(jstep.w[1]), tstep.w[1].numpy())

    w = tb._tiled_weights(ts, 0).w
    for digits in (3, 4):
        jp, tp = jpf.int8_weights(w, digits), ttf.int8_weights(w, digits)
        assert np.array_equal(jp[0], tp[0]) and jp[0].dtype == tp[0].dtype
        assert np.array_equal(jp[1], tp[1]) and jp[1].dtype == tp[1].dtype
        assert jp[2:] == tp[2:]
    want = jpf.int8_weights_auto(w, jb._INT8_CERT_GATE)
    scheme, int8p, scales = tb._resolve_scheme(w, "auto")
    assert scheme == "int8" and int8p[0].shape[0] == want[0].shape[0]
    assert int8p[0].shape[0] == (4 if cfg[2] == 10 else 3)
    assert scales == want[2]


@pytest.mark.parametrize("cfg", TILED)
def test_tap_ranges_cover_every_nonzero_weight(cfg):
    """The kernel walks only taps[m, tile] of each row tile; every nonzero
    weight must lie inside, and the range must be tight."""
    _, ts = _specs(cfg)
    w = tb._tiled_weights(ts, 0).w
    taps = ttf.tap_ranges(w != 0)
    P, K, R = w.shape
    for m in range(P):
        for i in range(R // ttf.ROW_TILE):
            lo, hi = taps[m, i]
            cols = w[m, :, i * ttf.ROW_TILE:(i + 1) * ttf.ROW_TILE]
            assert not cols[:lo].any() and not cols[hi:].any()
            assert cols[lo].any() and cols[hi - 1].any()
