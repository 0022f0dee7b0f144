"""The port's split5 scheme (K1c, K2c) against the JAX package.

split5 computes each f32 product as five bf16 products,
``w_hi*x_hi + w_hi*x_lo + w_mid*x_hi + w_mid*x_lo + w_lo*x_hi`` (the
weights split in three bf16 terms, the int16 sample in two), summed in f32.
"auto" resolves it where the int8 certificate fails (96 kHz -> 8 kHz q10,
filt_len 3072); ``scheme="split5"`` asks for it anywhere.  On the CPU:

- the port's torch split equals the JAX package's ``split5_weights``
  (``ml_dtypes``) bit for bit;
- the plain tiled and streamed versions against ``resample_conv_tm_pallas_v3``
  / ``_v4(scheme="split5")`` in interpret mode, one launch, small B;
- "auto" resolves split5 at 96k->8k q10 in both packages;
- the engine with split5 against the JAX engine through process / flush /
  process.

Tolerance: the LSB contract (``conftest.assert_lsb_close``): the same five
products, f32 sums in another order.  The CUDA kernels are held against
the plain versions by tests/test_torch_gpu.py and chip_smoke.py.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from speex_resampler_tpu.ops import filter_design as jfd
from speex_resampler_tpu.ops import pallas_fir as jpf
from speex_resampler_tpu.parallel import batch as jb
from speex_resampler_tpu.parallel.batch import BatchedResampler as JaxEngine
from speex_resampler_tpu_torch import BatchedResampler
from speex_resampler_tpu_torch.ops import filter_design as tfd
from speex_resampler_tpu_torch.ops import streamed_fir as tsf
from speex_resampler_tpu_torch.ops import tiled_fir as ttf
from speex_resampler_tpu_torch.parallel import batch as tb

from conftest import assert_lsb_close
from fixed_inputs import launch_inputs

torch.set_num_threads(1)

# (in, out, quality, target_chunk_frames)
FLAGSHIP = (44100, 48000, 7, 2352)       # tiled, P 20, one launch unit
DECIMATE = (96000, 8000, 10, 4096)       # tiled, P 1, K 4600: auto split5
SLICE = (48000, 44100, 10, 20480)        # streamed, P 147, K_pad 512
SPEECH = (44100, 16000, 7, 7056)         # streamed, P 20


@pytest.fixture
def auto_resolves(monkeypatch):
    """The JAX package resolves "auto" as on the TPU, not as "highest"
    under interpret."""
    monkeypatch.setattr(jb, "AUTO_RESOLVE_UNDER_INTERPRET", True)


def _specs(cfg):
    i, o = cfg[:2]
    g = math.gcd(i, o)
    return (jfd.design_filter(i // g, o // g, cfg[2]),
            tfd.design_filter(i // g, o // g, cfg[2]))


def _steps(cfg, scheme):
    js, ts = _specs(cfg)
    jspec = jb._launch_geometry(js, cfg[3], use_pallas=True)
    tspec = tb._launch_geometry(ts, cfg[3])
    assert dataclasses.asdict(jspec) == dataclasses.asdict(tspec)
    jstep = jb.make_batched_step(js, jspec, use_pallas=True,
                                 pallas_interpret=True, scheme=scheme)
    tstep = tb.make_batched_step(ts, tspec, device="cpu", scheme=scheme)
    assert jstep.scheme == tstep.scheme == "split5"
    for f in ("hist_rows", "chunk_rows", "zero_tail"):
        assert getattr(jstep, f) == getattr(tstep, f), f
    return jstep, tstep, tspec


def _bits(planes) -> np.ndarray:
    """bf16 planes (ml_dtypes array or torch tensor) as int16 bit
    patterns."""
    if isinstance(planes, torch.Tensor):
        return planes.view(torch.int16).numpy()
    return np.asarray(planes).view(np.int16)


def _equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Same dtype and the same bits."""
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("cfg", [FLAGSHIP, DECIMATE, SLICE],
                         ids=["44k1-48k-q7", "96k-8k-q10", "48k-44k1-q10"])
def test_torch_split_equals_split5_weights(cfg):
    """The phase-tiled weights (streamed: padded to K_pad) split by torch
    (round to nearest even) equal the JAX package's ml_dtypes split bit
    for bit, and the three terms sum back to the weights within bf16's
    third-term precision."""
    _, ts = _specs(cfg)
    w = tb._tiled_weights(ts, 0).w
    if cfg == SLICE:
        K_pad = -(-w.shape[1] // 128) * 128
        w = np.pad(w, ((0, 0), (0, K_pad - w.shape[1]), (0, 0)))
    got = ttf.split5_weights(w)
    assert got.dtype == torch.bfloat16 and got.shape == (3, *w.shape)
    assert np.array_equal(_bits(got), _bits(jpf.split5_weights(w)))
    back = got.double().sum(dim=0).numpy()
    assert np.abs(back - w).max() <= 2.0 ** -24 * np.abs(w).max()


def test_torch_split_edges():
    """Ties to even, subnormals, signs and zero split as ml_dtypes does."""
    rng = np.random.default_rng(0)
    w = np.concatenate([
        rng.standard_normal(5000).astype(np.float32),
        np.float32([0.0, -0.0, 1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, -1e-40,
                    1e-39, 3.0e38, 1.0 + 2.0 ** -8 + 2.0 ** -20]),
        (rng.standard_normal(1000) * 1e-30).astype(np.float32)])
    assert np.array_equal(_bits(ttf.split5_weights(w)),
                          _bits(jpf.split5_weights(w)))


@pytest.mark.parametrize("B", [4, 130])
@pytest.mark.parametrize("cfg", [FLAGSHIP, DECIMATE],
                         ids=["44k1-48k-q7", "96k-8k-q10"])
def test_plain_tiled_split5_matches_jax_v3(cfg, B):
    jstep, tstep, tspec = _steps(cfg, "split5")
    assert tstep.kernel == "tiled"
    assert np.array_equal(_bits(tstep.w[0]), _bits(jstep.w))
    hist, x = launch_inputs(tstep, tspec.in_per_launch, B, seed=B,
                            wrap=False)
    jh, jy = jstep.fn(hist, x, jstep.w)
    th, ty = tstep.fn(torch.from_numpy(hist), torch.from_numpy(x), tstep.w)
    assert ty.shape == (tspec.out_per_launch, B)
    assert_lsb_close(ty.numpy().ravel(), np.asarray(jy).ravel())
    assert np.array_equal(th.numpy(), np.asarray(jh))
    before = dict(tsf.launches)
    direct = tsf.resample_streamed(torch.from_numpy(hist),
                                   torch.from_numpy(x), tstep.w,
                                   **tstep.kernel_kw)
    assert tsf.launches == before and torch.equal(direct, ty)


@pytest.mark.parametrize("cfg", [SLICE, SPEECH],
                         ids=["48k-44k1-q10", "44k1-16k-q7"])
def test_plain_streamed_split5_matches_jax_v4(cfg):
    """JAX streams [P, 3, R, K_pad] planes; weights_from_jax(kernel=
    "streamed") gives the port's own [3, P, K_pad, R] step weights."""
    jstep, tstep, tspec = _steps(cfg, "split5")
    assert tstep.kernel == "streamed"
    w = tb.weights_from_jax(np.asarray(jstep.w), "split5", device="cpu",
                            kernel="streamed")
    assert len(w) == len(tstep.w)
    assert all(_equal(a, b) for a, b in zip(w, tstep.w))
    hist, x = launch_inputs(tstep, tspec.in_per_launch, 4, seed=3,
                            wrap=False)
    _, jy = jstep.fn(hist, x, jstep.w)
    ty = tsf.resample_streamed_reference(torch.from_numpy(hist),
                                         torch.from_numpy(x), w,
                                         **tstep.kernel_kw)
    assert ty.shape == (tspec.out_per_launch, 4)
    assert_lsb_close(ty.numpy().ravel(), np.asarray(jy).ravel())


#: the split5 kernels' walk (csrc/split5_wgmma.cuh): K-slices of WGMMA_K
#: taps from each row tile's t_lo rounded down to WGMMA_K, copied in whole
#: stages of STAGE_TAPS taps
WGMMA_K, STAGE_TAPS = 16, 32


@pytest.mark.parametrize("cfg", [DECIMATE, SLICE, SPEECH],
                         ids=["96k-8k-q10", "48k-44k1-q10", "44k1-16k-q7"])
def test_kernel_walk_adds_only_zero_weights(cfg):
    """Every tap the tensor-core kernels copy or multiply outside a row
    tile's band [t_lo, t_hi) holds a zero weight in all three planes of
    that tile, and the band is tight, so the extra products are exact zeros
    and each of the five sums is the band's (taps past K are zero-filled in
    the kernel)."""
    _, ts = _specs(cfg)
    step = tb.make_batched_step(ts, tb._launch_geometry(ts, cfg[3]),
                                device="cpu", scheme="split5")
    planes, taps = step.w[0], step.w[-1].numpy()
    _, P, K, R = planes.shape
    nonzero = (planes != 0).any(dim=0).numpy()                  # [P, K, R]
    for m in range(P):
        for rt, (lo, hi) in enumerate(taps[m]):
            rows = nonzero[m, :, rt * ttf.ROW_TILE:(rt + 1) * ttf.ROW_TILE]
            band = rows.any(axis=1)                                # [K]
            assert hi > lo and band[lo] and band[hi - 1]
            begin = lo - lo % WGMMA_K
            end = begin + -(-(hi - begin) // STAGE_TAPS) * STAGE_TAPS
            assert begin <= lo and hi <= end < hi + STAGE_TAPS
            outside = np.ones(K, dtype=bool)
            outside[lo:hi] = False
            assert not band[outside].any()


def test_weights_from_jax_tiled_split5():
    jstep, tstep, _ = _steps(FLAGSHIP, "split5")
    got = tb.weights_from_jax(np.asarray(jstep.w), "split5", device="cpu")
    assert len(got) == len(tstep.w)
    assert all(_equal(a, b) for a, b in zip(got, tstep.w))


def test_auto_resolves_split5_like_jax(auto_resolves):
    """96k->8k q10: the int8 certificate is infinite at D = 3 and 4, so
    "auto" resolves split5 in both packages; at the flagship it stays
    int8 D = 3 and at 48k->44.1k q10 int8 D = 4."""
    for cfg, want in ((DECIMATE, ("split5", 3)), (FLAGSHIP, ("int8", 3)),
                      (SLICE, ("int8", 4))):
        js, ts = _specs(cfg)
        jspec = jb._launch_geometry(js, cfg[3], use_pallas=True)
        jstep = jb.make_batched_step(js, jspec, use_pallas=True,
                                     pallas_interpret=True, scheme="auto")
        tstep = tb.make_batched_step(ts, tb._launch_geometry(ts, cfg[3]),
                                     device="cpu", scheme="auto")
        assert tstep.scheme == jstep.scheme == want[0]
        lead = tstep.w[0].shape[0]        # [D, ...] / [3, ...]
        jw = np.asarray(jstep.w if want[0] == "split5" else jstep.w[0])
        jlead = jw.shape[0] if tstep.kernel == "tiled" else jw.shape[1]
        assert lead == jlead == want[1]
    eng = BatchedResampler(2, 1, 96000, 8000, 10, device="cpu")
    assert (eng._step.kernel, eng._step.scheme) == ("tiled", "split5")


@pytest.mark.parametrize("cfg,scheme", [(FLAGSHIP, "split5"),
                                        (SPEECH, "split5"),
                                        (DECIMATE, "auto")],
                         ids=["44k1-48k-q7-tiled", "44k1-16k-q7-streamed",
                              "96k-8k-q10-auto"])
def test_engine_matches_jax_through_flush(auto_resolves, cfg, scheme):
    i, o, q, target = cfg
    S, C = 2, 1
    jax_eng = JaxEngine(S, C, i, o, q, target_chunk_frames=target,
                        use_pallas=True, pallas_interpret=True,
                        scheme=scheme)
    port = BatchedResampler(S, C, i, o, q, target_chunk_frames=target,
                            device="cpu", scheme=scheme)
    assert port._step.scheme == jax_eng._step.scheme == "split5"
    assert port.bspec.kernel == jax_eng.bspec.kernel
    q_in = port.in_frames_per_launch
    calls, after = (2 * q_in + 500, q_in // 3), (q_in + 100,)
    rng = np.random.default_rng(7)
    frames = [rng.integers(-32768, 32768, (S, n, C), dtype=np.int16)
              for n in calls + after]
    outs = []
    for eng in (jax_eng, port):
        got = [eng.process(f) for f in frames[:len(calls)]]
        got.append(eng.flush())
        got += [eng.process(f) for f in frames[len(calls):]]
        got.append(eng.flush())
        outs.append(got)
    assert port._f0 == jax_eng._f0 and port.launches > 2
    for g, w in zip(outs[1], outs[0]):
        assert g.shape == w.shape
        assert_lsb_close(g.ravel(), w.ravel())
