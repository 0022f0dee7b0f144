"""The port's functional step (speex_resampler_tpu_torch.functional)
against the port's engine and the JAX package's functional module.

The counterpart of tests/test_functional.py, case for case: the step must
be (a) identical to the stateful engine it exposes, (b) composable inside
a user's own torch function, and (c) correct in both numeric universes.
Against the JAX package's ``make_stream_fn(..., use_pallas=True,
pallas_interpret=True)`` with the scheme named, the shape contract
(in/out frames, history rows, latencies, scheme) must be equal and the
outputs int8 and fixed bit-identical, "highest" within the LSB contract
(conftest.assert_lsb_close).  ``resample_array`` is held against the JAX
package's (which runs its CPU geometry): fixed bit-identical, float within
the LSB contract.  On the CPU the step runs the kernels' plain versions;
``tests/test_torch_gpu.py`` holds its CUDA-graph capture on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speex_resampler_tpu import functional as jfn
from speex_resampler_tpu_torch import (BatchedResampler, ResamplerError,
                                       make_stream_fn, resample_array)
from speex_resampler_tpu_torch import functional as tfn
from speex_resampler_tpu_torch.parallel.mesh import join_lanes, split_lanes

from conftest import assert_lsb_close

torch.set_num_threads(1)


def _lanes_from_engine(out):
    # engine [S, n, C] -> lane-major [n, S*C]
    S, n, C = out.shape
    return out.transpose(1, 0, 2).reshape(n, S * C)


@pytest.mark.parametrize("fixed", [False, True])
def test_step_matches_engine(fixed):
    S, C = 3, 2
    rs = make_stream_fn(44100, 48000, 7, target_in_frames=600,
                        fixed_point=fixed, device="cpu")
    eng = BatchedResampler(S, C, 44100, 48000, 7, target_chunk_frames=600,
                           fixed_point=fixed, device="cpu")
    assert eng.in_frames_per_launch == rs.in_frames
    assert rs.scheme == ("fixed" if fixed else "int8")
    assert rs.device == torch.device("cpu") and rs.mesh == ()
    rng = np.random.default_rng(5)
    hist = rs.init(S * C)
    for _ in range(3):
        frames = rng.integers(-30000, 30000, (S, rs.in_frames, C),
                              dtype=np.int16)
        x_lanes = torch.from_numpy(_lanes_from_engine(frames))
        hist, y = rs.step(hist, x_lanes)
        out = eng.process(frames)
        assert out.shape[1] == rs.out_frames
        np.testing.assert_array_equal(y.numpy(), _lanes_from_engine(out))


@pytest.mark.parametrize("rates,scheme,fixed", [
    ((44100, 48000, 7), "int8", False),
    ((44100, 48000, 7), "highest", False),
    ((44100, 48000, 7), "auto", True),
    ((24000, 48000, 5), "auto", True),
    ((44100, 16000, 7), "int8", False),
], ids=["tiled-int8", "tiled-highest", "tiled-fixed", "direct-fixed",
        "streamed-int8"])
def test_step_matches_jax_step(rates, scheme, fixed):
    """The same seeded PCM through both packages' steps, quantum by
    quantum, with the histories carried."""
    kw = dict(target_in_frames=600, fixed_point=fixed, scheme=scheme)
    jrs = jfn.make_stream_fn(*rates, use_pallas=True, pallas_interpret=True,
                             **kw)
    trs = make_stream_fn(*rates, device="cpu", **kw)
    for field in ("in_frames", "out_frames", "hist_rows", "input_latency",
                  "output_latency", "fixed_point", "scheme"):
        assert getattr(trs, field) == getattr(jrs, field), field
    B = 4
    rng = np.random.default_rng(17)
    jh, th = jrs.init(B), trs.init(B)
    for _ in range(2):
        x = rng.integers(-32768, 32768, (trs.in_frames, B), dtype=np.int16)
        jh, jy = jrs.step(jh, jnp.asarray(x))
        th, ty = trs.step(th, torch.from_numpy(x))
        if trs.scheme == "highest":
            assert_lsb_close(ty.numpy().ravel(), np.asarray(jy).ravel())
        else:
            np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))


def test_step_composes_inside_a_torch_function():
    """The step as one stage of a user's function (resample, then window
    energies) equals the step alone, and the function's features are
    those of the step's output."""
    rs = make_stream_fn(24000, 48000, 5, target_in_frames=256, device="cpu")
    B = 4
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.integers(-20000, 20000, (rs.in_frames, B),
                                      dtype=np.int16))

    def pipeline(hist, pcm):
        hist, y = rs.step(hist, pcm)
        rms = y.float().square().mean(0).sqrt()
        return hist, y, rms

    hist0 = rs.init(B)
    h1, y1, rms = pipeline(hist0, x)
    h2, y2 = rs.step(hist0, x)  # un-fused reference
    assert torch.equal(y1, y2) and torch.equal(h1, h2)
    assert rms.shape == (B,) and float(rms.min()) > 0
    # hist0 is not written: the step is pure
    assert not rs.init(B).any() and not hist0.any()


def test_step_rejects_wrong_frame_count():
    rs = make_stream_fn(24000, 48000, 5, target_in_frames=256, device="cpu")
    with pytest.raises(ValueError):
        rs.step(rs.init(2), torch.zeros((rs.in_frames + 1, 2),
                                        dtype=torch.int16))
    with pytest.raises(ValueError):
        rs.step(rs.init(2), torch.zeros(rs.in_frames, dtype=torch.int16))


def test_latency_getters_match_engine():
    rs = make_stream_fn(44100, 48000, 7, target_in_frames=600, device="cpu")
    eng = BatchedResampler(1, 1, 44100, 48000, 7, target_chunk_frames=600,
                           device="cpu")
    assert rs.input_latency == eng.input_latency()
    assert rs.output_latency == eng.output_latency()


@pytest.mark.parametrize("fixed", [False, True])
def test_stream_fn_mesh_sharded_matches_unsharded(fixed):
    """The step under an 8-shard CPU mesh bit-matches the unsharded step
    (the lane axis is share-nothing; no collective)."""
    B = 16  # 2 lanes a shard
    plain = make_stream_fn(44100, 48000, 7, target_in_frames=600,
                           fixed_point=fixed, device="cpu")
    sharded = make_stream_fn(44100, 48000, 7, target_in_frames=600,
                             fixed_point=fixed, mesh=["cpu"] * 8)
    assert sharded.in_frames == plain.in_frames and sharded.device is None
    assert len(sharded.mesh) == 8
    rng = np.random.default_rng(13)
    hp, hs = plain.init(B), sharded.init(B)
    assert len(hs) == 8 and hs[0].shape == (plain.hist_rows, 2)
    for _ in range(2):
        x = torch.from_numpy(rng.integers(-30000, 30000,
                                          (plain.in_frames, B),
                                          dtype=np.int16))
        hp, yp = plain.step(hp, x)
        hs, ys = sharded.step(hs, split_lanes(x, sharded.mesh))
        assert len(ys) == 8
        assert torch.equal(join_lanes(ys), yp)
        assert torch.equal(join_lanes(hs), hp)


@pytest.mark.parametrize("fixed", [False, True])
def test_resample_array_shapes_and_duration(fixed):
    rng = np.random.default_rng(3)
    n = 8000
    mono = rng.integers(-25000, 25000, n, dtype=np.int16)
    stereo = rng.integers(-25000, 25000, (n, 2), dtype=np.int16)
    batch = np.stack([stereo, stereo[::-1]])
    kw = dict(fixed_point=fixed)

    y1 = resample_array(mono, 24000, 48000, 5, device="cpu", **kw)
    assert y1.ndim == 1
    y2 = resample_array(stereo, 24000, 48000, 5, device="cpu", **kw)
    assert y2.shape[1] == 2
    y3 = resample_array(batch, 24000, 48000, 5, device="cpu", **kw)
    assert y3.shape[0] == 2 and y3.shape[2] == 2
    # consistency across the accepted shapes
    np.testing.assert_array_equal(y3[0], y2)
    np.testing.assert_array_equal(
        y2[:, 0], resample_array(stereo[:, 0], 24000, 48000, 5,
                                 device="cpu", **kw))
    # duration invariant (the reference harness bound, src/test.ts:38-40)
    assert abs(len(y1) / 48000 - n / 24000) < 0.01
    # the JAX package's resample_array on the same arrays
    for ours, x in ((y1, mono), (y3, batch)):
        want = jfn.resample_array(x, 24000, 48000, 5, **kw)
        if fixed:
            np.testing.assert_array_equal(ours, want)
        else:
            assert_lsb_close(ours.ravel(), np.asarray(want).ravel())
    with pytest.raises(ValueError):
        resample_array(batch[None], 24000, 48000, 5, device="cpu")


def test_no_card_raises(monkeypatch):
    """Without a CUDA device the default ``device="cuda"`` step and array
    call raise; they never run on the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: make_stream_fn(44100, 48000, 7),
                 lambda: resample_array(np.zeros(100, np.int16), 44100,
                                        48000)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_zero_tail_is_shared_and_read_only():
    """The pad's zero rows are one tensor per (lanes, device), made once
    and never written by the step."""
    tails = tfn._ZeroTails(5)
    z = tails.get(3, torch.device("cpu"))
    assert z is tails.get(3, torch.device("cpu"))
    assert z.shape == (5, 3) and not z.any()
    assert tails.get(4, torch.device("cpu")) is not z
    with pytest.raises(ResamplerError):
        make_stream_fn(44100, 48000, 7, device="cpu", mesh=["cpu"])
