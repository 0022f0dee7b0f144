"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one.  The file
imports neither jax nor the test conftest (which loads jax), so on a
machine with a GPU and no jax it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Tolerance: "int8" bit-identical (exact int32 digit sums, the same f32
epilogue order in both); "highest" max |err| <= 1 LSB with at most the
Poisson tie count of tests/conftest.py::lsb_tie_limit (f32 sums in
another order).
"""

import math

import numpy as np
import pytest
import torch

from speex_resampler_tpu_torch import BatchedResampler
from speex_resampler_tpu_torch.ops import filter_design as tfd
from speex_resampler_tpu_torch.ops import phase as tph
from speex_resampler_tpu_torch.ops import streamed_fir as tsf
from speex_resampler_tpu_torch.ops import tiled_fir as ttf
from speex_resampler_tpu_torch.parallel import batch as tb

pytestmark = pytest.mark.gpu

# the reference integration matrix (tests/conftest.py AUDIO_TESTS)
CONFIGS = [(44100, 48000, 7), (44100, 48000, 1), (44100, 48000, 10),
           (44100, 24000, 5), (24000, 48000, 5), (24000, 24000, 5),
           (24000, 48000, 10)]
# the streamed geometry: every 48k->44.1k quality, and 44.1k->16k q7
STREAMED = [(48000, 44100, 5), (48000, 44100, 7), (48000, 44100, 10),
            (44100, 16000, 7)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _compare(got, want, scheme):
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    if scheme == "int8":
        assert int((d > 0).sum()) == 0
        return
    lam = 5e-3 * d.size
    limit = lam + 4.0 * math.sqrt(lam * (1.0 - 5e-3)) + 2.0
    assert d.max() <= 1 and int((d > 0).sum()) <= limit


@pytest.mark.parametrize("scheme", ["highest", "int8"])
@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: "%d-%d-q%d" % c)
def test_kernel_matches_plain(cuda, cfg, scheme):
    """At f0 = 0 and at the phase a flush leaves, B = 2048 and B = 130."""
    i, o, q = cfg
    g = math.gcd(i, o)
    spec = tfd.design_filter(i // g, o // g, q)
    m = tph.producible_outputs(3368, 0, 0, spec.num, spec.den)
    for f0 in sorted({0, (m * spec.num) % spec.den}):
        bspec = tb._launch_geometry(spec, 9408, f0=f0)
        step = tb.make_batched_step(spec, bspec, device="cuda",
                                    scheme=scheme)
        for B in (2048, 130):
            rng = np.random.default_rng(B + f0)
            hist = torch.from_numpy(rng.integers(
                -32768, 32768, (step.hist_rows, B), dtype=np.int16)).cuda()
            x = np.zeros((step.chunk_rows, B), dtype=np.int16)
            x[:bspec.in_per_launch] = rng.integers(
                -32768, 32768, (bspec.in_per_launch, B), dtype=np.int16)
            x = torch.from_numpy(x).cuda()
            before = ttf.launches[scheme]
            got = ttf.resample_tiled(hist, x, step.w, **step.kernel_kw)
            want = ttf.resample_tiled_reference(hist, x, step.w,
                                                **step.kernel_kw)
            torch.cuda.synchronize()
            assert ttf.launches[scheme] == before + 1
            _compare(got.cpu().numpy(), want.cpu().numpy(), scheme)


@pytest.mark.parametrize("scheme", ["highest", "int8"])
def test_engine_cuda_matches_cpu(cuda, scheme):
    """process / flush / process on the card equals the CPU engine."""
    engines = [BatchedResampler(3, 2, 44100, 48000, 7, device=d,
                                target_chunk_frames=2352, scheme=scheme)
               for d in ("cuda", "cpu")]
    rng = np.random.default_rng(3)
    frames = [rng.integers(-32768, 32768, (3, n, 2), dtype=np.int16)
              for n in (5000, 900, 3000)]
    outs = []
    for eng in engines:
        got = [eng.process(frames[0]), eng.process(frames[1]), eng.flush(),
               eng.process(frames[2]), eng.flush()]
        outs.append(np.concatenate(got, axis=1))
    assert engines[0].launches == engines[1].launches > 2
    _compare(outs[0], outs[1], scheme)


@pytest.mark.parametrize("scheme", ["highest", "int8", "auto"])
@pytest.mark.parametrize("cfg", STREAMED, ids=lambda c: "%d-%d-q%d" % c)
def test_streamed_kernel_matches_plain(cuda, cfg, scheme):
    """One weight period per launch, at f0 = 0 and at the phase a flush of
    4040 staged frames leaves, B = 2048 and B = 130 ("auto" is int8 with
    D = 4 at q10, explicit "int8" D = 3)."""
    i, o, q = cfg
    g = math.gcd(i, o)
    spec = tfd.design_filter(i // g, o // g, q)
    m = tph.producible_outputs(4040, 0, 0, spec.num, spec.den)
    for f0 in sorted({0, (m * spec.num) % spec.den}):
        bspec = tb._launch_geometry(spec, 1, f0=f0)
        step = tb.make_batched_step(spec, bspec, device="cuda",
                                    scheme=scheme)
        assert step.kernel == "streamed"
        for B in (2048, 130):
            rng = np.random.default_rng(B + f0)
            hist = torch.from_numpy(rng.integers(
                -32768, 32768, (step.hist_rows, B), dtype=np.int16)).cuda()
            x = np.zeros((step.chunk_rows, B), dtype=np.int16)
            x[:bspec.in_per_launch] = rng.integers(
                -32768, 32768, (bspec.in_per_launch, B), dtype=np.int16)
            x = torch.from_numpy(x).cuda()
            before = tsf.launches[step.scheme]
            got = tsf.resample_streamed(hist, x, step.w, **step.kernel_kw)
            want = tsf.resample_streamed_reference(hist, x, step.w,
                                                   **step.kernel_kw)
            torch.cuda.synchronize()
            assert tsf.launches[step.scheme] == before + 1
            _compare(got.cpu().numpy(), want.cpu().numpy(), step.scheme)


@pytest.mark.parametrize("scheme", ["highest", "auto"])
def test_streamed_engine_cuda_matches_cpu(cuda, scheme):
    """48k->44.1k q10: process / flush / process on the card equals the CPU
    engine, and every launch went through the streamed kernel."""
    engines = [BatchedResampler(3, 2, 48000, 44100, 10, device=d,
                                scheme=scheme) for d in ("cuda", "cpu")]
    rng = np.random.default_rng(4)
    frames = [rng.integers(-32768, 32768, (3, n, 2), dtype=np.int16)
              for n in (25000, 20000, 22000)]
    outs = []
    for eng in engines:
        before = dict(tsf.launches)
        got = [eng.process(frames[0]), eng.process(frames[1]), eng.flush(),
               eng.process(frames[2]), eng.flush()]
        outs.append(np.concatenate(got, axis=1))
        scheme_run = eng._step.scheme
        n = tsf.launches[scheme_run] - before[scheme_run]
        assert n == (eng.launches if eng.device.type == "cuda" else 0)
    assert engines[0]._step.kernel == "streamed"
    assert engines[0].launches == engines[1].launches > 2
    _compare(outs[0], outs[1], engines[0]._step.scheme)
