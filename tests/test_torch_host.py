"""The PyTorch port's host layer equals the JAX package's bit for bit.

The port copies the JAX package's NumPy filter design, phase arithmetic,
launch geometry and int8 digit-plane decomposition (it must not import the
JAX package, whose __init__ loads jax).  These tests pin the copies to the
originals over the reference's integration matrix plus the streamed
configs 48k->44.1k q10 and 44.1k->16k q7.
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
STREAMED = [(48000, 44100, 10), (44100, 16000, 7)]


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
    # the lazy tables are built in both, so every field compares whatever
    # other tests of this process built before (design_filter is cached)
    js.phase_table, ts.phase_table
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
    """BatchSpec equal (the JAX package's kernel choice included), R,
    phase-tiled weights and offsets equal (at f0 0 and at the phase a flush
    leaves).  Streamed configs: also the built step's hist_rows,
    chunk_rows and zero_tail, and the port's engine builds that geometry."""
    js, ts = _specs(cfg)
    kind = "streamed" if cfg in STREAMED else "tiled"
    for target in (4096, 9408):
        jspec = jb._launch_geometry(js, target, use_pallas=True)
        tspec = tb._launch_geometry(ts, target)
        assert jspec.kernel == kind
        assert dataclasses.asdict(jspec) == dataclasses.asdict(tspec)
    if cfg in STREAMED:
        jstep = jb.make_batched_step(js, jspec, use_pallas=True,
                                     pallas_interpret=True, scheme="highest")
        tstep = tb.make_batched_step(ts, tspec, device="cpu",
                                     scheme="highest")
        for f in ("hist_rows", "chunk_rows", "zero_tail", "scheme"):
            assert getattr(jstep, f) == getattr(tstep, f), f
        eng = BatchedResampler(1, 1, *cfg, device="cpu")
        assert eng.bspec.kernel == eng._step.kernel == "streamed"
    assert jb._tiled_R(js) == tb._tiled_R(ts)
    assert jb._hist_rows_tiled(js.filt_len) == tb._hist_rows_tiled(
        ts.filt_len)
    for f0 in (0, _flush_f0(ts, 3368)):
        jw, tw = jb._tiled_weights(js, f0), tb._tiled_weights(ts, f0)
        assert (jw.S, jw.R, jw.P, jw.K) == (tw.S, tw.R, tw.P, tw.K)
        assert np.array_equal(jw.offsets, tw.offsets)
        assert jw.w.dtype == tw.w.dtype and np.array_equal(jw.w, tw.w)


@pytest.mark.parametrize("cfg", STREAMED)
def test_latency_cap_requantizes_streamed_like_jax(cfg):
    """A max_latency_ms cap on a streamed config: a cap the rounded quantum
    overflows is re-quantized in units of S (not the tiled unit), as the
    JAX package does; a cap below one S goes to the dense geometry, as in
    the JAX package."""
    js, ts = _specs(cfg)
    S = tb._launch_geometry(ts, 4096).S
    for target, cap in ((4 * S, int(1.7 * S)), (4 * S, 3 * S - 16),
                        (S // 2, S), (10 * S, 10 * S)):
        jspec = jb._launch_geometry(js, target, use_pallas=True,
                                    max_in_frames=cap)
        tspec = tb._launch_geometry(ts, target, max_in_frames=cap)
        assert jspec.kernel == "streamed" and jspec.in_per_launch <= cap
        assert dataclasses.asdict(jspec) == dataclasses.asdict(tspec)
    assert tb._launch_geometry(ts, 4 * S,
                               max_in_frames=int(1.7 * S)).n_blocks == \
        tspec.P
    jspec = jb._launch_geometry(js, S, use_pallas=True, max_in_frames=S - 1)
    tspec = tb._launch_geometry(ts, S, max_in_frames=S - 1)
    assert tspec.kernel == "dense" and tspec.in_per_launch <= S - 1
    assert dataclasses.asdict(jspec) == dataclasses.asdict(tspec)
    i, o, q = cfg
    eng = BatchedResampler(1, 1, i, o, q, device="cpu",
                           target_chunk_frames=4 * S,
                           max_latency_ms=1.7 * S / i * 1000)
    assert eng.in_frames_per_launch == S


@pytest.mark.parametrize("cfg", TILED)
def test_step_contract_and_int8_planes_equal(cfg):
    """hist_rows / chunk_rows / zero_tail of the built steps, the int8
    planes (the port's K-major, permuted device planes mapped back to tap
    order, their taps past K zero), bias, scales and certificate for 3 and
    4 digits, and the digit count "auto" resolves (D=3, or 4 for the q10
    filters)."""
    js, ts = _specs(cfg)
    jspec = jb._launch_geometry(js, 9408, use_pallas=True)
    tspec = tb._launch_geometry(ts, 9408)
    jstep = jb.make_batched_step(js, jspec, use_pallas=True,
                                 pallas_interpret=True, scheme="int8")
    tstep = tb.make_batched_step(ts, tspec, device="cpu", scheme="int8")
    for f in ("hist_rows", "chunk_rows", "zero_tail", "scheme"):
        assert getattr(jstep, f) == getattr(tstep, f), f
    jplanes = np.asarray(jstep.w[0])
    back = ttf.int8_n_major(tstep.w[0]).numpy()
    K = jplanes.shape[2]
    assert back.shape[2] == -(-K // 32) * 32
    assert np.array_equal(back[:, :, :K], jplanes)
    assert not back[:, :, K:].any()
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


@pytest.mark.parametrize("cfg", TILED + STREAMED)
def test_tap_ranges_cover_every_nonzero_weight(cfg):
    """The "highest" kernel walks only taps[m, sub-band] of each 16-row
    sub-band of its step's weights; every nonzero weight must lie inside,
    and the range must be tight.  Streamed weights are padded to K_pad
    rows, which lie outside."""
    _, ts = _specs(cfg)
    step = tb.make_batched_step(ts, tb._launch_geometry(ts, 9408),
                                device="cpu", scheme="highest")
    w, taps = (t.numpy() for t in step.w)
    assert np.array_equal(taps, ttf.tap_ranges(w != 0, ttf.SUB_ROWS))
    P, K, R = w.shape
    if cfg in STREAMED:
        assert K % 128 == 0 and taps.max() <= tb._tiled_weights(ts, 0).K
    for m in range(P):
        for i in range(R // ttf.SUB_ROWS):
            lo, hi = taps[m, i]
            cols = w[m, :, i * ttf.SUB_ROWS:(i + 1) * ttf.SUB_ROWS]
            assert not cols[:lo].any() and not cols[hi:].any()
            assert cols[lo].any() and cols[hi - 1].any()
