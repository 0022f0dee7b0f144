"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one.  The file
imports neither jax nor the test conftest (which loads jax), so on a
machine with a GPU and no jax it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Tolerance: "int8" bit-identical (exact int32 digit sums, the same f32
epilogue order in both); "fixed" bit-identical (exact int16 dots wrapped
mod 2^32, the Q15 epilogue in int32); "highest" and "split5" max |err| <= 1
LSB with at most the Poisson tie count of tests/conftest.py::lsb_tie_limit
(f32 sums in another order).
"""

import dataclasses
import gc
import json
import math

import numpy as np
import pytest
import torch

from speex_resampler_tpu_torch import (BatchedResampler, FleetResampler,
                                       SpeexResampler)
from speex_resampler_tpu_torch.functional import make_stream_fn
from speex_resampler_tpu_torch.ops import _build
from speex_resampler_tpu_torch.ops import dense_fir as tdf
from speex_resampler_tpu_torch.ops import filter_design as tfd
from speex_resampler_tpu_torch.ops import fir_matmul as tfm
from speex_resampler_tpu_torch.ops import phase as tph
from speex_resampler_tpu_torch.ops import streamed_fir as tsf
from speex_resampler_tpu_torch.ops import tiled_fir as ttf
from speex_resampler_tpu_torch.parallel import batch as tb
from speex_resampler_tpu_torch.utils.launches import step_kernel
from speex_resampler_tpu_torch.utils.profiling import reset_spans, span_totals
from speex_resampler_tpu_torch.probes import (
    batched_dot as pbd, fixed_interp_anatomy as pfa, fixed_walk,
    kernel_anatomy as pka,
    mosaic_int_dot_bench as pid, mxu_peak as pmp, mxu_shape_probe as pms,
    prec_bench as ppb, tc_rate as ptr, v3_bench as pv3b,
    v3_overhead_anatomy as pv3, v4_k_layout as pkl,
    v4_overhead_anatomy as pv4, v5_int8_bench as pv5)
from speex_resampler_tpu_torch.probes import served_tiled

from fixed_inputs import block_origins, launch_inputs, wrap_column

pytestmark = pytest.mark.gpu

# the reference integration matrix (tests/conftest.py AUDIO_TESTS)
CONFIGS = [(44100, 48000, 7), (44100, 48000, 1), (44100, 48000, 10),
           (44100, 24000, 5), (24000, 48000, 5), (24000, 24000, 5),
           (24000, 48000, 10)]
# the streamed geometry: every 48k->44.1k quality, and 44.1k->16k q7
STREAMED = [(48000, 44100, 5), (48000, 44100, 7), (48000, 44100, 10),
            (44100, 16000, 7)]


def _key(step) -> str:
    """The launch-count key of a step's launches (the one launcher's:
    its scheme, "int8_resident" for the resident int8 kernel)."""
    return step_kernel(step)[0][1]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _compare(got, want, scheme):
    """Asserts the scheme's tolerance; returns (mismatches, tie limit)."""
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    if scheme == "int8":
        assert int((d > 0).sum()) == 0
        return 0, 0.0
    lam = 5e-3 * d.size
    limit = lam + 4.0 * math.sqrt(lam * (1.0 - 5e-3)) + 2.0
    assert d.max() <= 1 and int((d > 0).sum()) <= limit
    return int((d > 0).sum()), limit


# "highest" and "int8" also at B = 129 (x rows not 16-byte aligned: 2-byte
# loads) and 64 (half of the f32 kernels' 128-lane CTA tile, the streamed
# int8 kernel's whole 64-lane tile)
LANES = {"highest": (2048, 130, 129, 64), "int8": (2048, 130, 129, 64)}


@pytest.mark.parametrize("scheme", ["highest", "int8"])
@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: "%d-%d-q%d" % c)
def test_kernel_matches_plain(cuda, cfg, scheme):
    """At f0 = 0 and at the phase a flush leaves, B = 2048 and B = 130
    (and 129, 64 under "highest"); each launch's first windows start
    inside the history."""
    i, o, q = cfg
    g = math.gcd(i, o)
    spec = tfd.design_filter(i // g, o // g, q)
    m = tph.producible_outputs(3368, 0, 0, spec.num, spec.den)
    for f0 in sorted({0, (m * spec.num) % spec.den}):
        bspec = tb._launch_geometry(spec, 9408, f0=f0)
        step = tb.make_batched_step(spec, bspec, device="cuda",
                                    scheme=scheme)
        assert block_origins(step)[0] < step.hist_rows
        for B in LANES[scheme]:
            rng = np.random.default_rng(B + f0)
            hist = torch.from_numpy(rng.integers(
                -32768, 32768, (step.hist_rows, B), dtype=np.int16)).cuda()
            x = np.zeros((step.chunk_rows, B), dtype=np.int16)
            x[:bspec.in_per_launch] = rng.integers(
                -32768, 32768, (bspec.in_per_launch, B), dtype=np.int16)
            x = torch.from_numpy(x).cuda()
            before = tsf.launches[_key(step)]
            got = tsf.resample_streamed(hist, x, step.w, **step.kernel_kw)
            want = tsf.resample_streamed_reference(hist, x, step.w,
                                                   **step.kernel_kw)
            torch.cuda.synchronize()
            assert tsf.launches[_key(step)] == before + 1
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
    4040 staged frames leaves, B = 2048 and B = 130, and 129, 64 under
    "highest" and "int8" ("auto" is int8 with D = 4 at q10, explicit
    "int8" D = 3);
    each launch's first windows start inside the history."""
    i, o, q = cfg
    g = math.gcd(i, o)
    spec = tfd.design_filter(i // g, o // g, q)
    m = tph.producible_outputs(4040, 0, 0, spec.num, spec.den)
    for f0 in sorted({0, (m * spec.num) % spec.den}):
        bspec = tb._launch_geometry(spec, 1, f0=f0)
        step = tb.make_batched_step(spec, bspec, device="cuda",
                                    scheme=scheme)
        assert step.kernel == "streamed"
        assert block_origins(step)[0] < step.hist_rows
        for B in LANES.get(step.scheme, (2048, 130)):
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


def test_streamed_f32_band_reaching_k_pad(cuda):
    """streamed_fir_f32_kernel where tiles' bands end at K_pad: the 48k ->
    44.1k q10 weights moved down so their last nonzero tap row is K_pad - 1
    (their band ends at 434 of 512 as served), so the last stage's weight
    rows past K_pad are zero-filled, not read.  B = 2048, 130, 129, 64."""
    spec = tfd.design_filter(160, 147, 10)
    bspec = tb._launch_geometry(spec, 20480)
    step = tb.make_batched_step(spec, bspec, device="cuda",
                                scheme="highest")
    w = step.w[0].cpu().numpy()
    K_pad = w.shape[1]
    shift = K_pad - int(np.flatnonzero((w != 0).any(axis=(0, 2)))[-1]) - 1
    assert shift > 0
    moved = tsf.device_weights_streamed(np.roll(w, shift, axis=1),
                                        "highest", "cuda")
    bands = moved[1].cpu().numpy()
    tiles = bands.reshape(bands.shape[0], -1, 4, 2)       # 4 sub-bands a tile
    lo, hi = tiles[..., 0].min(axis=2), tiles[..., 1].max(axis=2)
    assert hi.max() == K_pad
    assert (lo + -(-(hi - lo) // 16) * 16 > K_pad).any()  # 16-tap stages
    for B in (2048, 130, 129, 64):
        hist, x = (torch.from_numpy(a).cuda() for a in launch_inputs(
            step, bspec.in_per_launch, B, seed=B, wrap=False))
        before = tsf.launches["highest"]
        got = tsf.resample_streamed(hist, x, moved, **step.kernel_kw)
        want = tsf.resample_streamed_reference(hist, x, moved,
                                               **step.kernel_kw)
        torch.cuda.synchronize()
        assert tsf.launches["highest"] == before + 1
        _compare(got.cpu().numpy(), want.cpu().numpy(), "highest")


@pytest.mark.parametrize("kernel", ["tiled", "streamed"])
def test_f32_misaligned_weights_raise(cuda, kernel):
    """The f32 kernels copy weight rows 16 bytes at a time: a contiguous
    weight view 4 bytes off a 16-byte boundary raises before any launch
    (the count stays), and the next aligned launch still matches plain."""
    cfg = (44100, 48000, 7, 9408) if kernel == "tiled" else \
        (48000, 44100, 10, 20480)
    spec = tfd.design_filter(*_reduced(*cfg[:2]), cfg[2])
    bspec = tb._launch_geometry(spec, cfg[3])
    step = tb.make_batched_step(spec, bspec, device="cuda", scheme="highest")
    assert step.kernel == kernel
    module = tsf
    launch = tsf.resample_streamed
    w, bands = step.w
    buf = torch.zeros(w.numel() + 4, dtype=torch.float32, device="cuda")
    off = buf[1:1 + w.numel()].view(w.shape)
    off.copy_(w)
    assert off.is_contiguous() and off.data_ptr() % 16 == 4
    hist, x = (torch.from_numpy(a).cuda() for a in launch_inputs(
        step, bspec.in_per_launch, 130, seed=130, wrap=False))
    before = module.launches["highest"]
    with pytest.raises(RuntimeError, match="misaligned"):
        launch(hist, x, (off, bands), **step.kernel_kw)
    assert module.launches["highest"] == before
    got = launch(hist, x, step.w, **step.kernel_kw)
    plain = tsf.resample_streamed_reference
    want = plain(hist, x, step.w, **step.kernel_kw)
    torch.cuda.synchronize()
    assert module.launches["highest"] == before + 1
    _compare(got.cpu().numpy(), want.cpu().numpy(), "highest")


def _reduced(i: int, o: int) -> tuple:
    g = math.gcd(i, o)
    return i // g, o // g


def _fixed_step(cfg, f0: int, kernel: str):
    """The fixed step of cfg at f0; kernel="streamed" on a tiled direct
    config feeds its weights, padded to K_pad, to the streamed kernel."""
    i, o, q, target = cfg
    spec = tfd.design_filter(*_reduced(i, o), q, fixed_point=True)
    bspec = tb._launch_geometry(spec, target, f0=f0)
    bspec = dataclasses.replace(bspec, kernel=kernel)
    return bspec, tb.make_batched_step(spec, bspec, device="cuda")


# (in, out, quality, target frames), kernel, n_accum
FIXED = [((44100, 48000, 7, 9408), "tiled", 4),
         ((24000, 48000, 5, 4096), "tiled", 1),
         ((48000, 44100, 10, 20480), "streamed", 4),
         ((24000, 48000, 5, 4096), "streamed", 1)]


@pytest.mark.parametrize("cfg,kernel,n_accum", FIXED,
                         ids=["tiled-44k1-48k-q7", "tiled-24k-48k-q5",
                              "streamed-48k-44k1-q10", "streamed-24k-48k-q5"])
def test_fixed_kernel_matches_plain(cuda, cfg, kernel, n_accum):
    """The int8 tensor-core kernels (csrc/fixed_wgmma.cuh): bit-identical
    (0 mismatches) at f0 = 0 and at the phase a flush leaves, B = 2048,
    130, 129 (x rows not 16-byte aligned: 2-byte loads) and 64 (one
    64-lane CTA tile), every third lane carrying the wrap input (an
    accumulator past 2^31); and on one weight cycle (n_blocks = P) at B =
    64, fewer tiles than SMs (4 at 24k->48k q5, 80 at q7), so each
    persistent CTA takes one tile."""
    i, o, q, _ = cfg
    spec = tfd.design_filter(*_reduced(i, o), q, fixed_point=True)
    m = tph.producible_outputs(3368, 0, 0, spec.num, spec.den)
    module = tsf
    for f0 in sorted({0, (m * spec.num) % spec.den}):
        bspec, step = _fixed_step(cfg, f0, kernel)
        assert (step.kernel, step.scheme) == (kernel, "fixed")
        assert step.kernel_kw["n_accum"] == n_accum
        assert step.w[0].dtype == torch.int8 and step.w[0].shape[-1] % 32 == 0
        for B in (2048, 130, 129, 64):
            hist, x = (torch.from_numpy(a).cuda() for a in launch_inputs(
                step, bspec.in_per_launch, B, seed=B + f0))
            launch = tsf.resample_streamed
            plain = tsf.resample_streamed_reference
            before = module.launches["fixed"]
            got = launch(hist, x, step.w, **step.kernel_kw)
            want = plain(hist, x, step.w, **step.kernel_kw)
            torch.cuda.synchronize()
            assert module.launches["fixed"] == before + 1
            assert int((got != want).sum()) == 0
        kw = dict(step.kernel_kw, n_blocks=step.w[-1].shape[0])
        hist, x = (torch.from_numpy(a).cuda() for a in launch_inputs(
            step, bspec.in_per_launch, 64, seed=7 + f0))
        got = tsf.resample_streamed(hist, x, step.w, **kw)
        want = tsf.resample_streamed_reference(hist, x, step.w, **kw)
        torch.cuda.synchronize()
        assert got.shape == want.shape
        assert int((got != want).sum()) == 0


def _edge_inputs(step, n_in: int, B: int, seed: int):
    """``tools/fixed_ablate.py``'s edge inputs on the card: the wrap input
    on every third lane and rows of -32768 and 32767 on the others."""
    hist, x = launch_inputs(step, n_in, B, seed, wrap=True)
    x[0:n_in:97, 1::3] = -32768
    x[1:n_in:89, 2::3] = 32767
    hist[::5, 1::3] = -32768
    return torch.from_numpy(hist).cuda(), torch.from_numpy(x).cuda()


@pytest.mark.parametrize("cfg,kernel", [
    ((44100, 48000, 7, 16464), "tiled"), ((48000, 44100, 10, 20480),
                                          "streamed")],
    ids=["q7-cell-K1e", "q10-cell-K2d"])
def test_fixed_resident_walk_matches_plain(cuda, cfg, kernel):
    """The persistent fixed kernel at the fixed cells' quanta, bit-identical
    to the plain version at f0 = 0 and after a flush, B = 2048, 130, 129
    (2-byte x loads) and 64, on ``tools/fixed_ablate.py``'s wrap and
    extreme inputs; its band loads are ``resident_bands`` of its bands'
    widths, CTAs and the library's ``fixed_fir_band_tiles`` (n_blocks / P
    x lane tiles where at least 6 tiles share a band: every B here at q7, 7
    blocks a phase; at q10, one block a phase, B = 130, 129 and 64 walk
    streamed and load none).  Where it walks resident, the walk's witness
    (``probes.fixed_walk``: the served walk recording each CTA's run of
    tiles and its band loads on the card) gives the host's runs
    (``resident_runs``) and loads CTA by CTA, and the served output."""
    from speex_resampler_tpu_torch.utils.launches import (fixed_counts,
                                                          reset_launches)
    i, o, q, _ = cfg
    spec = tfd.design_filter(*_reduced(i, o), q, fixed_point=True)
    m = tph.producible_outputs(3368, 0, 0, spec.num, spec.den)
    lib = _build.load()
    for f0 in sorted({0, (m * spec.num) % spec.den}):
        bspec, step = _fixed_step(cfg, f0, kernel)
        kw = step.kernel_kw
        widths = step.w[-2]
        assert kw["n_accum"] == 4 and widths.widest == (6 if q == 7 else 9)
        for B in (2048, 130, 129, 64):
            hist, x = _edge_inputs(step, bspec.in_per_launch, B, B + f0)
            reset_launches()
            got = tsf.resample_streamed(hist, x, step.w, **kw)
            want = tsf.resample_streamed_reference(hist, x, step.w, **kw)
            torch.cuda.synchronize()
            assert int((got != want).sum()) == 0, (f0, B)
            _, ctas, tiles, bands = fixed_counts()
            per_band = lib.fixed_fir_band_tiles(4, widths.widest,
                                                kw["n_blocks"], bspec.P, B)
            share = kw["n_blocks"] // bspec.P * -(-B // 64)
            assert per_band == (share if share >= 6 else 0)
            assert per_band or q == 10 and B < 2048
            assert bands == tsf.resident_bands(widths, per_band, ctas)
            assert (bands > 0) == (per_band > 0)
            if per_band:
                walked, record = fixed_walk.walk(
                    hist, x, step.w, ctas=ctas,
                    **{k: kw[k] for k in ("n_blocks", "shift", "num", "den",
                                          "f0")})
                assert torch.equal(record, fixed_walk.model_record(
                    widths, per_band, ctas)), (f0, B)
                assert int(record[:, 2].sum()) == bands
                assert torch.equal(walked, got)
    reset_launches()


@pytest.mark.parametrize("cfg,B,n_blocks", [
    ((48000, 44100, 10, 20480), 2048, None), ((24000, 48000, 5, 4096), 64, 1)],
    ids=["q10-B2048", "24k-48k-q5-one-block-B64"])
def test_fixed_launch_counts_tiles_and_ctas(cuda, cfg, B, n_blocks):
    """The port's counters of the fixed launches (``speex.kernel.fixed.
    launches`` / ``.ctas`` / ``.tiles``, read by ``utils/launches.
    fixed_counts``): the tiles are n_blocks x row tiles x ceil(B / 64),
    18,816 at 48k->44.1k q10, B = 2048, walked by one persistent CTA an
    SM, so more than one tile a CTA; one block of 24k->48k q5 (n_accum 1,
    P = 1) at B = 64 is 4 tiles, one a CTA.  reset_launches() sets them
    to 0."""
    from speex_resampler_tpu_torch.utils.launches import (fixed_counts,
                                                          reset_launches)
    bspec, step = _fixed_step(cfg, 0, "streamed")
    kw = dict(step.kernel_kw)
    if n_blocks is not None:
        kw["n_blocks"] = n_blocks
    hist, x = (torch.from_numpy(a).cuda() for a in launch_inputs(
        step, bspec.in_per_launch, B, seed=5))
    reset_launches()
    assert fixed_counts() == (0, 0, 0, 0)
    got = tsf.resample_streamed(hist, x, step.w, **kw)
    want = tsf.resample_streamed_reference(hist, x, step.w, **kw)
    torch.cuda.synchronize()
    assert int((got != want).sum()) == 0
    rows = ttf.FIXED_ROWS[kw["n_accum"]]
    tiles = kw["n_blocks"] * (bspec.R // rows) * -(-B // 64)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert tsf.launches["fixed"] == 1
    launched, ctas, counted, bands = fixed_counts()
    assert (launched, counted) == (1, tiles)
    if n_blocks is None:
        assert tiles == 18816 and ctas == min(tiles, sms)
        assert counted / ctas > 1
        assert bands == tsf.resident_bands(step.w[-2], 32, ctas) > 0
    else:
        assert tiles == 4 and ctas == tiles and bands == 0
    reset_launches()
    assert fixed_counts() == (0, 0, 0, 0)


def test_fixed_counts_of_the_cells_launches(cuda):
    """One call of each fixed cell's step at its 2048 lanes counts one
    launch of min(tiles, SMs) persistent CTAs over its tiles (17,920 at
    44.1k->48k q7, 16464 frames, K1e; 18,816 at 48k->44.1k q10, K2d),
    holding each (phase, row tile) band resident: 210 band loads at q7 and
    716 at q10 on 132 SMs; a float phase-tiled launch and a fixed dense
    launch count none."""
    from speex_resampler_tpu_torch.utils.launches import (fixed_counts,
                                                          launch_counts,
                                                          reset_launches)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator().manual_seed(11)

    def call(spec, bspec, scheme="auto", B=2048):
        nonlocal step
        step = tb.make_batched_step(spec, bspec, device="cuda",
                                    scheme=scheme)
        hist = torch.zeros((step.hist_rows, B), dtype=torch.int16,
                           device="cuda")
        x = torch.randint(-20000, 20000, (bspec.in_per_launch, B),
                          generator=gen, dtype=torch.int16).cuda()
        reset_launches()
        step.fn(hist, x, step.w)
        torch.cuda.synchronize()
        return launch_counts()

    step = None
    for (i, o, q, target), tiles, per_band, loads in (
            ((44100, 48000, 7, 16464), 17920, 224, 210),
            ((48000, 44100, 10, 20480), 18816, 32, 716)):
        spec = tfd.design_filter(*_reduced(i, o), q, fixed_point=True)
        call(spec, tb._launch_geometry(spec, target))
        bands = tsf.resident_bands(step.w[-2], per_band, min(tiles, sms))
        assert fixed_counts() == (1, min(tiles, sms), tiles, bands)
        assert sms != 132 or bands == loads
    spec = tfd.design_filter(147, 160, 7)
    assert call(spec, tb._launch_geometry(spec, 2352), "highest")
    assert fixed_counts() == (0, 0, 0, 0)
    spec = tfd.design_filter(147, 160, 3, fixed_point=True)
    bspec = tb._launch_geometry(spec, 882, max_in_frames=882)
    assert bspec.kernel == "dense"
    assert call(spec, bspec) == {"dense": {"fixed": 1}}
    assert fixed_counts() == (0, 0, 0, 0)
    reset_launches()


@pytest.mark.parametrize("streams,channels", [(3, 2), (65, 2), (43, 3),
                                              (32, 2)],
                         ids=["B6", "B130", "B129", "B64"])
@pytest.mark.parametrize("cfg", [(44100, 48000, 7, 2352),
                                 (48000, 44100, 10, 20480),
                                 (24000, 48000, 5, 2560)],
                         ids=["44k1-48k-q7", "48k-44k1-q10", "24k-48k-q5"])
def test_fixed_engine_cuda_matches_cpu(cuda, cfg, streams, channels):
    """fixed_point=True: process / flush / process on the card equals the
    CPU engine bit for bit, every launch through the fixed kernel, at B =
    streams * channels lanes (130, 129 and 64 besides 6); one stream's
    first channel carries full-scale +-32767 runs."""
    i, o, q, target = cfg
    engines = [BatchedResampler(streams, channels, i, o, q, device=d,
                                fixed_point=True, target_chunk_frames=target)
               for d in ("cuda", "cpu")]
    module = tsf
    rng = np.random.default_rng(5)
    frames = [rng.integers(-32768, 32768, (streams, n, channels),
                           dtype=np.int16)
              for n in (2 * target + 500, 900, 3000)]
    for f in frames:
        f[0, :, 0] = np.where(np.arange(f.shape[1]) // 7 % 2, 32767, -32767)
    outs = []
    for eng in engines:
        before = module.launches["fixed"]
        got = [eng.process(frames[0]), eng.process(frames[1]), eng.flush(),
               eng.process(frames[2]), eng.flush()]
        outs.append(np.concatenate(got, axis=1))
        n = module.launches["fixed"] - before
        assert n == (eng.launches if eng.device.type == "cuda" else 0)
    assert engines[0]._step.scheme == "fixed"
    assert engines[0].launches == engines[1].launches > 2
    assert np.array_equal(outs[0], outs[1])


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


# dense launches (in, out, quality, max_in_frames): the voip 20 ms shapes
# (R 160, 96, 129), R 32 < ROW_TILE, and a 32 MB weight matrix (19990 ->
# 20000 q10 capped below one streamed unit: L_pad 3998, R 2000)
DENSE = [(44100, 48000, 3, 882), (48000, 16000, 3, 960),
         (16000, 48000, 3, 320), (48000, 16000, 3, 96),
         (19990, 20000, 10, 2998)]


@pytest.mark.parametrize("cfg", DENSE, ids=lambda c: "%d-%d-q%d-cap%d" % c)
def test_dense_kernel_matches_plain(cuda, cfg):
    """dense_fir_f32_kernel against its plain version at f0 = 0 and at
    phase 1 (where den > 1), B = 2048, 130, 129 and 64."""
    i, o, q, cap = cfg
    spec = tfd.design_filter(*_reduced(i, o), q)
    for f0 in sorted({0, 1 % spec.den}):
        bspec = tb._launch_geometry(spec, 4096, f0=f0, max_in_frames=cap)
        step = tb.make_batched_step(spec, bspec, device="cuda")
        assert (step.kernel, step.scheme) == ("dense", "highest")
        for B in (2048, 130, 129, 64):
            hist, x = (torch.from_numpy(a).cuda() for a in launch_inputs(
                step, bspec.in_per_launch, B, seed=B + f0, wrap=False))
            before = tdf.launches["highest"]
            got = tdf.resample_dense(hist, x, step.w, **step.kernel_kw)
            want = tdf.resample_dense_reference(hist, x, step.w,
                                                **step.kernel_kw)
            torch.cuda.synchronize()
            assert tdf.launches["highest"] == before + 1
            _compare(got.cpu().numpy(), want.cpu().numpy(), "highest")


@pytest.mark.parametrize("cfg,scheme,kernel", [
    ((96000, 8000, 10, 4096), "auto", "tiled"),
    ((44100, 48000, 7, 9408), "split5", "tiled"),
    ((48000, 44100, 10, 20480), "split5", "streamed"),
    ((44100, 16000, 7, 7056), "split5", "streamed")],
    ids=["tiled-96k-8k-q10-auto", "tiled-44k1-48k-q7", "streamed-48k-44k1-q10",
         "streamed-44k1-16k-q7"])
def test_split5_kernel_matches_plain(cuda, cfg, scheme, kernel):
    """streamed_fir_split5_kernel in the tiled geometry (K 4600 at 96k->8k
    q10, where "auto" resolves split5; the flagship) and the streamed one
    (P 147 and P 20) against their plain versions, at f0 = 0 and at the
    phase a flush of 4040 frames leaves, B = 2048, 130, 129 (rows not
    16-byte aligned, so 2-byte loads) and 64 (one warpgroup's lanes).  Each
    case's mismatch count is printed."""
    i, o, q, target = cfg
    spec = tfd.design_filter(*_reduced(i, o), q)
    m = tph.producible_outputs(4040, 0, 0, spec.num, spec.den)
    module = tsf
    for f0 in sorted({0, (m * spec.num) % spec.den}):
        bspec = tb._launch_geometry(spec, target, f0=f0)
        step = tb.make_batched_step(spec, bspec, device="cuda",
                                    scheme=scheme)
        assert (step.kernel, step.scheme) == (kernel, "split5")
        launch = tsf.resample_streamed
        plain = tsf.resample_streamed_reference
        for B in (2048, 130, 129, 64):
            hist, x = (torch.from_numpy(a).cuda() for a in launch_inputs(
                step, bspec.in_per_launch, B, seed=B + f0, wrap=False))
            before = module.launches["split5"]
            got = launch(hist, x, step.w, **step.kernel_kw)
            want = plain(hist, x, step.w, **step.kernel_kw)
            torch.cuda.synchronize()
            assert module.launches["split5"] == before + 1
            mism, limit = _compare(got.cpu().numpy(), want.cpu().numpy(),
                                   "split5")
            print(f"split5 {kernel} {i}->{o} q{q} f0={f0} B={B}: {mism} "
                  f"mismatches of {got.numel()} ({mism / got.numel():.2e}), "
                  f"tie limit {limit:.0f}")


@pytest.mark.parametrize("cfg,kw,kind", [
    ((44100, 48000, 3), dict(max_latency_ms=20), "dense"),
    ((44100, 48000, 3), dict(max_latency_ms=20, fixed_point=True), "dense"),
    ((44100, 44101, 7), {}, "gather"),
    ((44100, 44101, 7), dict(fixed_point=True), "gather"),
    ((96000, 8000, 10), {}, "tiled")],
    ids=["dense-voip", "dense-voip-fixed", "gather", "gather-fixed",
         "tiled-split5-96k-8k"])
def test_new_paths_cuda_match_cpu(cuda, cfg, kw, kind):
    """process / flush / process on the card equals the CPU engine (fixed:
    bit for bit).  Every one of these engines launches its kernel once per
    engine launch on the card (dense and fixed dense, the gathers, split5)
    and none on the CPU."""
    engines = [BatchedResampler(3, 2, *cfg, device=d, **kw)
               for d in ("cuda", "cpu")]
    step = engines[0]._step
    assert step.kernel == kind
    assert all(t.is_cuda for t in step.w)
    q_in = engines[0].in_frames_per_launch
    rng = np.random.default_rng(6)
    frames = [rng.integers(-32768, 32768, (3, n, 2), dtype=np.int16)
              for n in (2 * q_in + 500, q_in // 3 + 7, q_in + 900)]
    counts = (tsf.launches, tdf.launches, tfm.launches)
    outs = []
    for eng in engines:
        before = [dict(c) for c in counts]
        got = [eng.process(frames[0]), eng.process(frames[1]), eng.flush(),
               eng.process(frames[2]), eng.flush()]
        outs.append(np.concatenate(got, axis=1))
        ran = sum(c[k] - b[k] for c, b in zip(counts, before) for k in c)
        assert ran == (eng.launches if eng.device.type == "cuda" else 0)
    assert engines[0].launches == engines[1].launches > 2
    if step.scheme == "fixed":
        assert np.array_equal(outs[0], outs[1])
    else:
        _compare(outs[0], outs[1], step.scheme)


def _edge_inputs(step, n_in: int, B: int, seed: int):
    """launch_inputs with rows of -32768 and 32767 in every window and
    -32768 history rows, on the card."""
    hist, x = launch_inputs(step, n_in, B, seed=seed, wrap=False)
    x[0:n_in:97] = -32768
    x[1:n_in:89] = 32767
    hist[::5] = -32768
    return torch.from_numpy(hist).cuda(), torch.from_numpy(x).cuda()


@pytest.mark.parametrize("scheme,D", [("auto", 4), ("int8", 3),
                                      ("int8", 2), ("int8", 1)],
                         ids=["D4", "D3", "D2", "D1"])
def test_streamed_int8_edges_match_plain(cuda, scheme, D):
    """streamed_fir_int8_kernel (int8 tensor cores) at 48k->44.1k q10, D =
    4 ("auto") and 3 (explicit "int8"), and the same weights decomposed
    into 2 and 1 digit planes (``int8_weights(digits=D)``): the warpgroups
    split the digit planes at D = 4 and 2, the rows at 3 and 1.  With x =
    -32768 and 32767 rows in every window and -32768 history rows: 0
    mismatches against the plain version at f0 = 0 and 40, B = 2048, 130,
    129 and 64, one launch counted each."""
    spec = tfd.design_filter(160, 147, 10)
    for f0 in (0, 40):
        bspec = tb._launch_geometry(spec, 20480, f0=f0)
        step = tb.make_batched_step(spec, bspec, device="cuda",
                                    scheme=scheme)
        assert (step.kernel, step.scheme) == ("streamed", "int8")
        if D < 3:
            ptw = tb._tiled_weights(spec, f0)
            K_pad = step.w[0].shape[-1]
            planes, bias, scales, _ = ttf.int8_weights(
                np.pad(ptw.w, ((0, 0), (0, K_pad - ptw.K), (0, 0))),
                digits=D)
            step = dataclasses.replace(
                step, w=tsf.device_weights_streamed((planes, bias), "int8",
                                                    "cuda"),
                kernel_kw={**step.kernel_kw, "scales": scales})
        assert step.w[0].shape[0] == D
        n_in = bspec.in_per_launch
        for B in (2048, 130, 129, 64):
            hist, x = _edge_inputs(step, n_in, B, B + f0)
            before = tsf.launches["int8"]
            got = tsf.resample_streamed(hist, x, step.w, **step.kernel_kw)
            want = tsf.resample_streamed_reference(hist, x, step.w,
                                                   **step.kernel_kw)
            torch.cuda.synchronize()
            assert tsf.launches["int8"] == before + 1
            assert int((got != want).sum()) == 0


def _q10_int8_step(f0: int, D: int):
    """The float 48k->44.1k q10 step at f0 ("auto": D = 4), or its weights
    decomposed into D digit planes (``int8_weights(digits=D)``)."""
    spec = tfd.design_filter(160, 147, 10)
    bspec = tb._launch_geometry(spec, 20480, f0=f0)
    step = tb.make_batched_step(spec, bspec, device="cuda")
    assert (step.kernel, step.scheme) == ("streamed", "int8")
    if step.w[0].shape[0] != D:
        ptw = tb._tiled_weights(spec, f0)
        K_pad = step.w[0].shape[-1]
        planes, bias, scales, _ = ttf.int8_weights(
            np.pad(ptw.w, ((0, 0), (0, K_pad - ptw.K), (0, 0))), digits=D)
        step = dataclasses.replace(
            step, w=tsf.device_weights_streamed((planes, bias), "int8",
                                                "cuda"),
            kernel_kw={**step.kernel_kw, "scales": scales})
    return bspec, step


@pytest.mark.parametrize("D,B", [(4, 2048), (4, 1001), (2, 2048), (4, 320)],
                         ids=["D4-B2048", "D4-B1001", "D2-B2048",
                              "D4-B320"])
def test_streamed_int8_resident_walk_matches_plain(cuda, D, B):
    """K2b at 48k->44.1k q10, f0 = 0 and 40: where its digits pair up, its
    widest band (12 K-slices at D = 4, 11 at D = 2) fits one band buffer
    and at least 6 tiles
    share a band (the library's ``int8_fir_band_tiles``: 32 at B = 2048,
    16 at B = 1001, whose x rows take 2-byte loads; B = 320 leaves 5, so
    it streams), its persistent CTAs hold each band resident.  0 outputs
    differ from the plain version; at D = 4 none from the launch forced
    onto the streamed walk (the parent's walk) by the rule's input, band
    widths whose widest band passes one buffer's room.  The port's int8
    counters: 1 launch; min(tiles, SMs) CTAs over n_blocks x 2 x ceil(B /
    64) tiles and ``resident_bands`` band loads where it holds bands
    resident, else a CTA a tile and none."""
    from speex_resampler_tpu_torch.utils.launches import (int8_counts,
                                                          reset_launches)
    lib = _build.load()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for f0 in (0, 40):
        bspec, step = _q10_int8_step(f0, D)
        kw = step.kernel_kw
        widths, P = step.w[2], bspec.P
        assert step.w[0].shape[0] == D
        assert widths.widest == {4: 12, 2: 11}[D]
        share = kw["n_blocks"] // P * -(-B // 64)
        per_band = lib.int8_fir_band_tiles(D, widths.widest, kw["n_blocks"],
                                           P, B)
        assert per_band == (share if share >= 6 else 0)
        assert (per_band > 0) == (B != 320)
        tiles = tsf.int8_tiles(kw["n_blocks"], bspec.R, B)
        hist, x = _edge_inputs(step, bspec.in_per_launch, B, B + f0)
        reset_launches()
        got = tsf.resample_streamed(hist, x, step.w, **kw)
        want = tsf.resample_streamed_reference(hist, x, step.w, **kw)
        torch.cuda.synchronize()
        assert int((got != want).sum()) == 0, (f0, B)
        ctas = min(tiles, sms) if per_band else tiles
        bands = tsf.resident_bands(widths, per_band, ctas)
        assert int8_counts() == (1, ctas, tiles, bands)
        assert (bands > 0) == (per_band > 0)
        if D == 4:
            wide = ttf.BandWidths(widths.slices[:-1]
                                  + (step.w[0].shape[3] // 32,))
            assert lib.int8_fir_band_tiles(D, wide.widest, kw["n_blocks"],
                                           P, B) == 0
            reset_launches()
            streamed = tsf.resample_streamed(
                hist, x, (step.w[0], step.w[1], wide, step.w[3]), **kw)
            torch.cuda.synchronize()
            assert torch.equal(streamed, got)
            assert int8_counts() == (1, tiles, tiles, 0)
    reset_launches()


# The profiled call of test_int8_counts_equal_the_launch_grid, in a process
# of its own: run in this one ahead of the gather counts' test, its profiler
# run left that test's traces without kernel records on the H100.
_INT8_GRID_CALL = """
import json, math, sys
import torch
sys.path.insert(0, "tests")
from test_torch_gpu import _q10_int8_step
from fixed_inputs import launch_inputs
from speex_resampler_tpu_torch.utils.launches import (int8_counts,
                                                      reset_launches)
bspec, step = _q10_int8_step(0, 4)
hist, x = (torch.from_numpy(a).cuda() for a in launch_inputs(
    step, bspec.in_per_launch, 2048, seed=3, wrap=False))
step.fn(hist, x, step.w)          # warm-up: the library is loaded
torch.cuda.synchronize()
reset_launches()
acts = [torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA]
with torch.profiler.profile(activities=acts) as prof:
    step.fn(hist, x, step.w)
    torch.cuda.synchronize()
prof.export_chrome_trace(sys.argv[1])
grids = [math.prod(e["args"]["grid"]) for e in json.load(
    open(sys.argv[1]))["traceEvents"] if e.get("cat") == "kernel"
    and "streamed_fir_int8_kernel" in e.get("name", "")]
print(json.dumps({"grids": grids, "counts": int8_counts(),
                  "slices": step.w[2].slices}))
"""


def test_int8_counts_equal_the_launch_grid(cuda, tmp_path):
    """One call of the float q10 step (``stage.q10``'s, D = 4) at 2048
    lanes, profiled in a process of its own: the port's int8 counters
    (``utils/launches.int8_counts``) give 1 launch, CTAs equal to the grid
    the profiler's trace records for ``streamed_fir_int8_kernel``
    (min(9,408 tiles, SMs): one persistent CTA an SM), 9,408 tiles (147
    blocks x 2 row tiles x 32 lane tiles) and the host's band loads
    (``resident_bands`` of the 294 bands' widths, 32 tiles a band): ~22
    tiles a band load on 132 SMs."""
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-c", _INT8_GRID_CALL,
                          str(tmp_path / "trace.json")], cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(r["grids"]) == 1, r["grids"]
    grid = r["grids"][0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tiles = 147 * 2 * 32
    assert grid == min(tiles, sms)
    widths = ttf.BandWidths(tuple(r["slices"]))
    bands = tsf.resident_bands(widths, 32, grid)
    assert tuple(r["counts"]) == (1, grid, tiles, bands)
    assert len(widths.slices) == 294 and bands > 294
    if sms == 132:
        assert 20 < tiles / bands < 25


@pytest.mark.parametrize("kind", ["dense", "streamed-int8", "tiled-int8"])
def test_graph_replay_equals_eager(cuda, kind):
    """resample_dense (voip), resample_streamed(scheme="int8") at 48k ->
    44.1k q10 and at the flagship (the resident kernel) captured in
    a CUDA graph: a replay equals the eager launch, and after new inputs
    are copied into the captured buffers, a replay equals the eager launch
    on them."""
    if kind == "dense":
        spec = tfd.design_filter(147, 160, 3)
        bspec = tb._launch_geometry(spec, 4096, max_in_frames=882)
        launch = tdf.resample_dense
    elif kind == "tiled-int8":
        spec = tfd.design_filter(147, 160, 7)
        bspec = tb._launch_geometry(spec, 9408)
        launch = tsf.resample_streamed
    else:
        spec = tfd.design_filter(160, 147, 10)
        bspec = tb._launch_geometry(spec, 20480)
        launch = tsf.resample_streamed
    step = tb.make_batched_step(spec, bspec, device="cuda")
    assert step.kernel == kind.split("-")[0]
    assert step.scheme == ("highest" if kind == "dense" else "int8")
    inputs = [[torch.from_numpy(a).cuda() for a in launch_inputs(
        step, bspec.in_per_launch, 256, seed=s, wrap=False)] for s in (1, 2)]
    hist, x = inputs[0]

    def run():
        return launch(hist, x, step.w, **step.kernel_kw)

    eager = [launch(h, xx, step.w, **step.kernel_kw) for h, xx in inputs]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = run()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager[0])
    hist.copy_(inputs[1][0])
    x.copy_(inputs[1][1])
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager[1])


@pytest.mark.parametrize("fixed", [False, True], ids=["int8", "fixed"])
def test_stream_fn_graph_equals_eager(cuda, fixed):
    """make_stream_fn's step at the flagship (B = 256) plus a feature
    stage (256-frame window energies) captured in one CUDA graph on static
    hist and x buffers, the history carried in place: three replays, each
    on new frames copied into x, equal the eager stage's outputs,
    energies and histories bit for bit; the kernel counter moves once, at
    capture."""
    rs = make_stream_fn(44100, 48000, 7, target_in_frames=9408,
                        fixed_point=fixed)
    assert rs.scheme == ("fixed" if fixed else "int8")
    B = 256
    rng = np.random.default_rng(4)
    xs = [torch.from_numpy(rng.integers(-32768, 32768, (rs.in_frames, B),
                                        dtype=np.int16)).cuda()
          for _ in range(3)]

    def stage(h, x):
        h2, y = rs.step(h, x)
        e = (y.float() / 32768).view(-1, 256, B).square().mean(1)
        return h2, y, e

    h, eager = rs.init(B), []
    for x in xs:
        h, y, e = stage(h, x)
        eager.append((h, y, e))
    hist, xbuf = rs.init(B), xs[0].clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        stage(hist, xbuf)
    torch.cuda.current_stream().wait_stream(side)
    key = "fixed" if fixed else "int8_resident"
    before = tsf.launches[key]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        h_out, y_out, e_out = stage(hist, xbuf)
        hist.copy_(h_out)
    assert tsf.launches[key] == before + 1
    for x, (h, y, e) in zip(xs, eager):
        xbuf.copy_(x)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(y_out, y) and torch.equal(e_out, e)
        assert torch.equal(hist, h)
    assert tsf.launches[key] == before + 1


# kernel -> (in, out, quality, target frames), fixed, scheme, geometry
BARE = {
    "K1a": ((44100, 48000, 7, 9408), False, "highest", "tiled"),
    "K1b": ((44100, 48000, 7, 9408), False, "auto", "tiled"),
    "K1c": ((44100, 48000, 7, 9408), False, "split5", "tiled"),
    "K1d": ((24000, 48000, 5, 4096), True, "auto", "tiled"),
    "K1e": ((44100, 48000, 7, 9408), True, "auto", "tiled"),
    "K2a": ((48000, 44100, 10, 20480), False, "highest", "streamed"),
    "K2b-D4": ((48000, 44100, 10, 20480), False, "auto", "streamed"),
    "K2b-D3": ((48000, 44100, 10, 20480), False, "int8", "streamed"),
    "K2c": ((48000, 44100, 10, 20480), False, "split5", "streamed"),
    "K2d-n4": ((48000, 44100, 10, 20480), True, "auto", "streamed"),
    "K2d-n1": ((24000, 48000, 5, 4096), True, "auto", "streamed"),
}


def _unaligned_copy(x: torch.Tensor) -> torch.Tensor:
    """x's values in a contiguous tensor that starts 2 bytes past a 16-byte
    boundary (so its kernel takes the 2-byte x loads)."""
    flat = torch.empty(x.numel() + 1, dtype=torch.int16, device=x.device)
    out = flat[1:].view(x.shape)
    out.copy_(x)
    assert out.data_ptr() % 16 == 2
    return out


@pytest.mark.parametrize("kernel", list(BARE))
def test_bare_quantum_equals_zero_tailed_chunk(cuda, kernel):
    """Every tiled and streamed CUDA kernel given the bare n_in-row quantum
    (rows past its end zero-filled by the kernel's staging, never read)
    returns the output of the same launch on the zero-tailed chunk of
    chunk_rows rows, bit for bit, at B = 2048 and at B = 130; the int8
    and fixed launches also equal the plain version on the bare quantum
    (exact).  Half the quantum, whose windows read past its end with
    nonzero taps, equals the quantum with those rows zeroed.  K1b's bare
    quantum also runs off a 16-byte boundary (the 2-byte x loads), equal
    again."""
    (i, o, q, target), fixed, scheme, geometry = BARE[kernel]
    spec = tfd.design_filter(*_reduced(i, o), q, fixed_point=fixed)
    bspec = dataclasses.replace(tb._launch_geometry(spec, target),
                                kernel=geometry)
    step = tb.make_batched_step(spec, bspec, device="cuda", scheme=scheme)
    assert step.kernel == geometry
    if kernel.startswith("K2b"):
        assert step.w[0].shape[0] == int(kernel[-1])
    launch, plain = tsf.resample_streamed, tsf.resample_streamed_reference
    n_in = bspec.in_per_launch
    for B in (2048, 130):
        hist, chunk = (torch.from_numpy(a).cuda() for a in launch_inputs(
            step, n_in, B, seed=B, wrap=False))
        bare = chunk[:n_in].clone()
        before = tsf.launches[_key(step)]
        want = launch(hist, chunk, step.w, **step.kernel_kw)
        got = launch(hist, bare, step.w, **step.kernel_kw)
        torch.cuda.synchronize()
        assert tsf.launches[_key(step)] == before + 2
        assert torch.equal(got, want)
        if step.scheme in ("int8", "fixed"):
            assert torch.equal(got, plain(hist, bare, step.w,
                                          **step.kernel_kw))
        # half the quantum: windows with nonzero taps read past x's end
        cut = chunk.clone()
        cut[n_in // 2:] = 0
        assert torch.equal(
            launch(hist, chunk[:n_in // 2].clone(), step.w, **step.kernel_kw),
            launch(hist, cut, step.w, **step.kernel_kw))
        if kernel == "K1b" and B == 2048:
            odd = launch(hist, _unaligned_copy(bare), step.w,
                         **step.kernel_kw)
            torch.cuda.synchronize()
            assert torch.equal(odd, want)


@pytest.mark.parametrize("geometry", ["tiled", "streamed"])
def test_stream_fn_graph_on_bare_quanta(cuda, geometry):
    """make_stream_fn's step (K1b at the flagship, K2b at 48k -> 44.1k
    q10; B = 256) eagerly on quanta that are slices of one int16 pool, as
    a device-resident caller holds them: no copy (no ``speex.step.pad``
    span) and the output of the same quanta cloned.  Then the step
    captured in a CUDA graph on a bare static quantum, the history
    carried in place: each replay on new frames copied into it equals the
    eager step, and no copy is made at capture."""
    rates, target = (((44100, 48000, 7), 9408) if geometry == "tiled"
                     else ((48000, 44100, 10), 20480))
    rs = make_stream_fn(*rates, target_in_frames=target)
    key = "int8_resident" if geometry == "tiled" else "int8"
    B = 256
    rng = np.random.default_rng(12)
    pool = torch.from_numpy(rng.integers(-32768, 32768, (3, rs.in_frames, B),
                                         dtype=np.int16)).cuda()
    reset_spans()
    h, eager = rs.init(B), []
    for k in range(3):
        h, y = rs.step(h, pool[k])
        eager.append((h, y))
    assert "speex.step.pad" not in span_totals()
    h = rs.init(B)
    for k in range(3):
        h, y = rs.step(h, pool[k].clone())
        assert torch.equal(y, eager[k][1]) and torch.equal(h, eager[k][0])
    hist, xbuf = rs.init(B), pool[0].clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        rs.step(hist, xbuf)
    torch.cuda.current_stream().wait_stream(side)
    before = tsf.launches[key]
    reset_spans()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        h_out, y_out = rs.step(hist, xbuf)
        hist.copy_(h_out)
    assert "speex.step.pad" not in span_totals()
    assert tsf.launches[key] == before + 1
    for k, (h, y) in enumerate(eager):
        xbuf.copy_(pool[k])
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(y_out, y) and torch.equal(hist, h)


@pytest.mark.parametrize("D", [1, 2, 3, 4])
def test_tiled_int8_digits_match_plain(cuda, D):
    """tiled_fir_int8_kernel<D> (the resident band, int8 tensor cores) on
    the flagship's weights decomposed into D digit planes
    (``int8_weights(digits=D)``): 0 mismatches against the plain version
    at f0 = 0 and at the phase a flush leaves, B = 2048, 130, 129 and 64,
    with x = -32768 and 32767 rows; every band fits the resident kernel."""
    spec = tfd.design_filter(147, 160, 7)
    m = tph.producible_outputs(3368, 0, 0, spec.num, spec.den)
    for f0 in (0, (m * spec.num) % spec.den):
        bspec = tb._launch_geometry(spec, 9408, f0=f0)
        base = tb.make_batched_step(spec, bspec, device="cuda",
                                    scheme="highest")
        planes, bias, scales, _ = ttf.int8_weights(
            tb._tiled_weights(spec, f0).w, digits=D)
        w = ttf.device_weights((planes, bias), "int8", "cuda")
        assert w[2] <= _build.load().tiled_fir_int8_max_slices(D)
        step = dataclasses.replace(base, w=w, scheme="int8", kernel_kw={
            **base.kernel_kw, "scheme": "int8", "scales": scales})
        for B in (2048, 130, 129, 64):
            hist, x = _edge_inputs(step, bspec.in_per_launch, B, B + f0)
            before = tsf.launches["int8_resident"]
            got = tsf.resample_streamed(hist, x, w, **step.kernel_kw)
            want = tsf.resample_streamed_reference(hist, x, w,
                                                   **step.kernel_kw)
            torch.cuda.synchronize()
            assert tsf.launches["int8_resident"] == before + 1
            assert int((got != want).sum()) == 0


def _synthetic_int8(D, P, K, R, bands, seed, amp):
    """Random digit planes [D, P, K, R] of magnitude < amp, zero outside
    bands[(m, row tile)] = (lo, hi) (int32 sums stay exact), as device
    weights, with D scales."""
    rng = np.random.default_rng(seed)
    planes = rng.integers(-amp, amp, (D, P, K, R), dtype=np.int8)
    for (m, rt), (lo, hi) in bands.items():
        planes[:, m, :lo, rt * 64:(rt + 1) * 64] = 0
        planes[:, m, hi:, rt * 64:(rt + 1) * 64] = 0
    bias = (rng.standard_normal((P, R)) * 100).astype(np.float32)
    scales = tuple(float(2.0 ** (8 * d - 31)) for d in range(D))
    return ttf.device_weights((planes, bias), "int8", "cuda"), scales


@pytest.mark.parametrize("case", ["long-D3", "long-D4", "resident-D1",
                                  "resident-D4"])
def test_tiled_int8_band_edges_match_plain(cuda, case):
    """Synthetic tiled int8 launches.  "long": 1000-tap bands (33
    K-slices) past the resident kernel's shared memory, so the step's
    weights carry their band widths in place of their slice count
    (``int8_launch_weights``) and the launch takes
    streamed_fir_int8_kernel, on its streamed walk (such a band passes
    its one band buffer's room too).  "resident": an all-zero row
    tile, a band ending at K, odd slice counts, bands of 1 to 8 K-slices,
    at closed-form origins of a 208-row period and f0 11.  0 mismatches
    against the plain version at B = 2048, 130, 129 and 64; the chunk's
    first quarter alone, its windows reading past its end with nonzero
    taps, equals the chunk with the rest zeroed (rows past x's end read as
    zero)."""
    kind, D = case.split("-D")
    D = int(D)
    if kind == "long":
        bands = {(m, rt): (16 + 40 * m + 7 * rt, 1016 + 40 * m + 7 * rt)
                 for m in range(2) for rt in range(2)}
        w, scales = _synthetic_int8(D, 2, 1280, 128, bands, D, amp=16)
        # origins floor16(128 k + 37): a period of 256 rows
        origin = dict(shift=37, num=1, den=1, f0=0)
        n_blocks, H, T, key = 8, 1040, 2048, "int8"
        assert w[2] > _build.load().tiled_fir_int8_max_slices(D)
    else:
        bands = {(0, 0): (0, 0), (0, 1): (5, 70), (1, 0): (200, 256),
                 (1, 1): (33, 250), (2, 0): (0, 256), (2, 1): (64, 96)}
        w, scales = _synthetic_int8(D, 3, 256, 128, bands, 10 + D, amp=128)
        # P R num / den = 3 * 128 * 13 / 24 = 208 rows a period
        origin = dict(shift=5, num=13, den=24, f0=11)
        n_blocks, H, T, key = 15, 256, 1200, "int8_resident"
        assert w[2] <= _build.load().tiled_fir_int8_max_slices(D)
    w = tsf.int8_launch_weights(w)
    assert (type(w[2]) is int) == (kind == "resident")
    kw = dict(n_blocks=n_blocks, scheme="int8", scales=scales, **origin)
    for B in (2048, 130, 129, 64):
        rng = np.random.default_rng(B)
        hist = torch.from_numpy(rng.integers(-32768, 32768, (H, B),
                                             dtype=np.int16)).cuda()
        x = torch.from_numpy(rng.integers(-32768, 32768, (T, B),
                                          dtype=np.int16)).cuda()
        before = tsf.launches[key]
        got = tsf.resample_streamed(hist, x, w, **kw)
        want = tsf.resample_streamed_reference(hist, x, w, **kw)
        torch.cuda.synchronize()
        assert tsf.launches[key] == before + 1
        assert int((got != want).sum()) == 0
        cut = x.clone()
        cut[T // 4:] = 0
        assert torch.equal(
            tsf.resample_streamed(hist, x[:T // 4].clone(), w, **kw),
            tsf.resample_streamed(hist, cut, w, **kw))


def test_tiled_int8_launcher_guards(cuda):
    """The resident kernel's C entry point refuses planes or bias off a
    16-byte boundary or K % 32 != 0 (cudaErrorMisalignedAddress), a span
    past K / 32 or past its shared memory, and a weight period P R num /
    den that is not a whole multiple of 16 rows, before any launch."""
    spec = tfd.design_filter(147, 160, 7)
    bspec = tb._launch_geometry(spec, 9408)
    step = tb.make_batched_step(spec, bspec, device="cuda", scheme="int8")
    planes, bias, slices, taps = step.w
    kw = step.kernel_kw
    hist, x = (torch.from_numpy(a).cuda() for a in launch_inputs(
        step, bspec.in_per_launch, 64, seed=1, wrap=False))
    y = torch.empty((kw["n_blocks"] * bspec.R, 64), dtype=torch.int16,
                    device="cuda")
    lib = _build.load()
    D, P, R, K = planes.shape
    s = tuple(kw["scales"]) + (0.0,) * (4 - D)

    def call(ptr, k, span, b=bias.data_ptr(), den=kw["den"]):
        return lib.tiled_fir_int8(
            hist.data_ptr(), x.data_ptr(), y.data_ptr(), taps.data_ptr(),
            ptr, b, D, *s, span, hist.shape[0], x.shape[0], 64, R, k, P,
            kw["n_blocks"], kw["shift"], kw["num"], den, kw["f0"],
            torch.cuda.current_stream().cuda_stream)
    for err in (call(planes.data_ptr() + 4, K, slices),
                call(planes.data_ptr(), K - 16, slices),
                call(planes.data_ptr(), K, slices, bias.data_ptr() + 4)):
        assert b"misaligned" in lib.streamed_fir_error_string(err)
    assert call(planes.data_ptr(), K, K // 32 + 1) != 0
    assert call(planes.data_ptr(), K, slices, den=kw["den"] + 1) != 0
    if lib.tiled_fir_int8_max_slices(D) < K // 32:
        assert call(planes.data_ptr(), K,
                    lib.tiled_fir_int8_max_slices(D) + 1) != 0
    assert call(planes.data_ptr(), K, slices) == 0
    torch.cuda.synchronize()
    want = tsf.resample_streamed_reference(hist, x, step.w, **kw)
    assert torch.equal(y, want)


@pytest.mark.parametrize("streams,channels", [(65, 2), (43, 3), (32, 2)],
                         ids=["B130", "B129", "B64"])
def test_tiled_int8_engine_cuda_matches_cpu(cuda, streams, channels):
    """The flagship engine ("auto" = int8, D = 3): process / flush /
    process on the card equals the CPU engine bit for bit, every launch
    through the tiled int8 kernel."""
    engines = [BatchedResampler(streams, channels, 44100, 48000, 7,
                                device=d, target_chunk_frames=2352)
               for d in ("cuda", "cpu")]
    rng = np.random.default_rng(7)
    frames = [rng.integers(-32768, 32768, (streams, n, channels),
                           dtype=np.int16) for n in (5200, 900, 3000)]
    for f in frames:
        f[0, :, 0] = np.where(np.arange(f.shape[1]) // 7 % 2, 32767, -32768)
    outs = []
    for eng in engines:
        before = tsf.launches["int8_resident"]
        got = [eng.process(frames[0]), eng.process(frames[1]), eng.flush(),
               eng.process(frames[2]), eng.flush()]
        outs.append(np.concatenate(got, axis=1))
        n = tsf.launches["int8_resident"] - before
        assert n == (eng.launches if eng.device.type == "cuda" else 0)
    assert engines[0]._step.scheme == "int8"
    assert engines[0].launches == engines[1].launches > 2
    assert np.array_equal(outs[0], outs[1])


def _fleet_serve(fleet, frames, rng):
    """Ragged pushes (odd streams as bytes cut at odd offsets), poll,
    flush, pull every stream."""
    for s in range(fleet.n_streams):
        f = frames[s]
        cuts = sorted(rng.integers(1, f.shape[0], 2).tolist())
        for a, b in zip([0] + cuts, cuts + [f.shape[0]]):
            if s % 2:
                raw = f[a:b].astype("<i2").tobytes()
                fleet.push_bytes(s, raw[:len(raw) // 2 | 1])
                fleet.push_bytes(s, raw[len(raw) // 2 | 1:])
            else:
                fleet.push(s, f[a:b])
    fleet.poll()
    fleet.flush()
    return [fleet.pull(s) for s in range(fleet.n_streams)]


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("fixed", [False, True], ids=["int8", "fixed"])
@pytest.mark.parametrize("streams", [4, 65], ids=["B8", "B130"])
def test_fleet_cuda_matches_cpu(cuda, streams, fixed, depth):
    """FleetResampler on the card (native stager, pinned slabs, the
    upload / compute / readback streams) equals the CPU fleet bit for bit
    at the flagship, float ("auto" = int8) and fixed, each fleet launch
    one kernel launch."""
    q = 2352
    rng = np.random.default_rng(streams)
    frames = rng.integers(-32768, 32768, (streams, 4 * q, 2),
                          dtype=np.int16)
    lens = 3 * q + rng.integers(0, q, streams)
    frames = [frames[s, :lens[s]] for s in range(streams)]
    outs = []
    scheme = "fixed" if fixed else "int8"
    key = "fixed" if fixed else "int8_resident"
    for device in ("cuda", "cpu"):
        fleet = FleetResampler(streams, 2, 44100, 48000, 7, device=device,
                               fixed_point=fixed, target_chunk_frames=q,
                               pipeline_depth=depth)
        assert fleet.stager_kind == "native"
        before = tsf.launches[key]
        outs.append(_fleet_serve(fleet, frames, np.random.default_rng(1)))
        if device == "cuda":
            assert fleet._step.scheme == scheme
            assert all(s._pinned.is_pinned() for s in fleet._slabs)
            assert all(b.is_pinned() for b in fleet._readback_bufs)
            assert tsf.launches[key] - before == fleet.stats.launches == 4
            assert not fleet.degraded
    for a, b in zip(*outs):
        assert a.shape == b.shape and np.array_equal(a, b)


def test_fleet_readback_fault_degrades_with_a_warning(cuda):
    """A fault surfacing where a launch's readback is synchronized
    degrades the CUDA fleet (cause, counter, warning) and keeps the exact
    per-stream counts as zeros."""
    class _BadEvent:
        def synchronize(self):
            raise RuntimeError("injected readback fault")

    from speex_resampler_tpu_torch.utils.host import Readback
    q = 2352
    rng = np.random.default_rng(3)
    frames = rng.integers(-32768, 32768, (4, 2 * q, 2), dtype=np.int16)
    fleets = [FleetResampler(4, 2, 44100, 48000, 7, target_chunk_frames=q)
              for _ in range(2)]
    bad = fleets[0]
    real = bad._readback
    bad._readback = lambda i, y: Readback(_BadEvent(), real(i, y).wait())
    for f in fleets:
        for s in range(4):
            f.push(s, frames[s])
    fleets[1].poll()
    with pytest.warns(RuntimeWarning, match="degraded"):
        assert bad.poll() == 2
    assert bad.degraded and "injected" in str(bad.degraded_cause)
    assert bad.degraded_launches == 2
    for s in range(4):
        got, want = bad.pull(s), fleets[1].pull(s)
        assert got.shape == want.shape and not got.any() and want.any()


@pytest.mark.parametrize("fixed", [False, True], ids=["int8", "fixed"])
def test_batched_two_slab_pipeline_equals_one_launch_a_call(cuda, fixed):
    """process() of four quanta (launch i+1 queued before launch i is read
    back, two pinned slabs) gives the same bits as four calls of one
    quantum each, and as the CPU engine."""
    q = 2352
    rng = np.random.default_rng(11)
    frames = rng.integers(-32768, 32768, (65, 4 * q + 300, 2),
                          dtype=np.int16)
    outs = []
    for device, calls in (("cuda", 1), ("cuda", 4), ("cpu", 1)):
        eng = BatchedResampler(65, 2, 44100, 48000, 7, device=device,
                               fixed_point=fixed, target_chunk_frames=q)
        if device == "cuda":
            assert all(s._pinned.is_pinned() for s in eng._slabs)
        n = frames.shape[1] // calls
        got = [eng.process(frames[:, k * n:(k + 1) * n])
               for k in range(calls)] + [eng.flush()]
        outs.append(np.concatenate(got, axis=1))
        assert not eng.degraded
    assert np.array_equal(outs[0], outs[1]) and np.array_equal(outs[0],
                                                                outs[2])


@pytest.mark.parametrize("cfg", [(16, 44100, 48000, 7), (64, 48000, 44100, 10),
                                 (2, 44100, 44101, 7)],
                         ids=["16ch", "64ch-q10", "gather"])
def test_core_device_route_cuda_matches_cpu(cuda, cfg):
    """ResamplerCore's device route on the card (one f32 matmul a call;
    the gather route at 44.1k -> 44.101k) against the same core on the
    CPU: within 1 LSB under the tie bound over ragged, capacity-bound
    calls, with TF32 switched on around the card's core (the route turns
    it off for its matmul and restores it)."""
    from speex_resampler_tpu_torch import ResamplerCore
    c, i, o, q = cfg
    x = np.random.default_rng(3).integers(-32768, 32768, (24000, c),
                                          dtype=np.int16)
    cores = [ResamplerCore(c, i, o, i, o, q, engine="device", device=d)
             for d in ("cuda", "cpu")]
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        outs = [[core.process_interleaved(x[a:b], cap)
                 for a, b, cap in ((0, 9000, 10 ** 9), (9000, 9001, 5),
                                   (9001, 20000, 700),
                                   (20000, 24000, 10 ** 9))]
                for core in cores]
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    for got, want in zip(*outs):
        assert got.shape == want.shape
        _compare(got, want, "highest")
    assert not cores[0].degraded and cores[0].device.type == "cuda"


def test_multifleet_bucket_churn_frees_device_memory(cuda):
    """Buckets evicted past max_idle_buckets = 0 close their fleets: the
    device memory allocated returns to its level after the first eviction
    (the step weights stay in the shared step cache), and the pinned host
    buffers are dropped."""
    from speex_resampler_tpu_torch.runtime import MultiFleet
    # earlier tests' cyclic garbage holding device memory is collected
    # now, not by a collection that happens to run between two levels
    gc.collect()
    mf = MultiFleet(channels=2, capacity_per_bucket=64,
                    target_chunk_frames=2048, max_idle_buckets=0)
    x = np.random.default_rng(4).integers(-32768, 32768, (5000, 2),
                                          dtype=np.int16)
    keys = [(44100, 48000, 7), (24000, 48000, 5), (44100, 24000, 5)]
    levels = []
    for rnd in range(3):
        for i, key in enumerate(keys):
            sid = f"{rnd}-{i}"
            mf.add_stream(sid, *key)
            fleet = mf._buckets[key].fleet
            mf.push(sid, x)
            mf.poll()
            mf.end_stream(sid)
            assert mf.pull(sid).shape[0] > 0
            assert key not in mf._buckets and fleet._slabs == []
            assert fleet._readback_bufs == [] and fleet._hist is None
            torch.cuda.synchronize()
            levels.append(torch.cuda.memory_allocated())
    assert not mf.degraded
    assert levels[len(keys):] == [levels[len(keys) - 1]] * (2 * len(keys)), \
        levels


# -- the tensor-core probes (speex_resampler_tpu_torch.probes) --------------
# Each probe kernel against its plain version at the TPU probe's full
# shape, 0 mismatches: the rate kernel at every SHAPES and CASES entry and
# the served N-tiles (one copy of each tile, and filling the card), the
# int8 block's variants at N = 32 and 64, the fixed ladder's rungs.

# and an odd count of int8 K-slices an iteration (3 at K_pad 96, one x
# block a CTA at 15 CTAs an SM): the slice after the last whole pair
RATE_CASES = sorted(
    {(d, C, K, pmp.LB, None, 1) for d in ptr.DTYPES for C, K in pmp.SHAPES}
    | {(d, C, K, LB, None, 1) for d, C, K, LB in pms.CASES}
    | {(d, C, K, pmp.LB, n, s) for d in ptr.DTYPES
       for C, K, n, s in pmp.SERVED}
    | {("int8", 64, 96, 64, 64, 15)}, key=str)


@pytest.mark.parametrize("case", RATE_CASES, ids=lambda c: "%s-%dx%d-lb%d-n%s-sm%d" % c)
def test_probe_rate_kernel_matches_plain(cuda, case):
    dtype, C, K, LB, n, per_sm = case
    w, x = ptr.operands(C, K, LB, seed=C + K + LB, device="cuda")
    want = ptr.rate_reference(w, x, dtype)
    assert torch.equal(ptr.tc_rate(w, x, dtype, n=n, iters=20), want)
    rl = ptr.RateLaunch(w, x, dtype, n, per_sm=per_sm)
    assert rl.n_ctas >= rl.plan.units
    assert torch.equal(rl.run(16), want)


@pytest.mark.parametrize("n", pv4.N_TILES)
@pytest.mark.parametrize("variant", pv4.VARIANTS)
def test_probe_int8_anatomy_matches_plain(cuda, variant, n):
    w8, x16, x8 = pv4.inputs(seed=11, device="cuda")
    x16[0, ::7], x16[1, ::7] = -32768, 32767
    x = x8 if variant == "mxu_only" else x16
    want = pv4.anatomy_reference(variant, w8, x)
    assert torch.equal(pv4.anatomy(variant, w8, x, n=n), want)
    al = pv4.AnatomyLaunch(variant, w8, x, n)
    assert torch.equal(al.run(17), want)


@pytest.mark.parametrize("rung", pfa.RUNGS)
def test_probe_fixed_ladder_matches_plain(cuda, rung):
    planes, bias, coef, xh, x16 = pfa.inputs(seed=12)
    w = planes[0].to(torch.int64) * 256 + planes[1].to(torch.int64)
    c = int(w[:pfa.R].abs().sum(1).argmax())
    x16 = x16.numpy().copy()
    assert wrap_column(w[c].numpy(), x16, np.arange(0, pfa.LB, 5)) > 2 ** 31
    x16[0, 1::7], x16[1, 1::7] = -32768, 32767
    args = [t.cuda() for t in (planes, bias, coef)]
    x = pfa.rung_input(rung, xh.cuda(), torch.from_numpy(x16).cuda())
    want = pfa.ladder_reference(rung, *args, x)
    assert torch.equal(pfa.ladder(rung, *args, x), want)
    assert torch.equal(pfa.LadderLaunch(rung, *args, x).run(16), want)


def test_probe_build_error_raises(cuda, tmp_path, monkeypatch):
    """A probe source that does not compile raises from the wrapper on CUDA
    tensors (no plain-version fallback), and again on the next call."""
    import shutil
    copy = tmp_path / "csrc"
    shutil.copytree(_build._PROBE_CSRC, copy)
    src = copy / "probes" / "tc_rate.cu"
    src.write_text(src.read_text() + "\nthis does not compile;\n")
    monkeypatch.setattr(_build, "_PROBE_CSRC", copy)
    monkeypatch.setattr(_build, "_probe_lib", None)
    w, x = ptr.operands(128, 264, 128, device="cuda")
    before = ptr.launches
    for _ in range(2):
        with pytest.raises(RuntimeError, match="nvcc failed"):
            ptr.tc_rate(w, x, "int8")
    assert ptr.launches == before and _build._probe_lib is None


# -- probes P5-P8 ----------------------------------------------------------
# Each kernel against its plain version at the TPU probe's full shape and at
# one ragged shape: 0 mismatches for P5 (full and hoist also equal to the
# served K1b), P7 and P6's nodot; max |err| <= 1 within the tie bound for
# P6's other variants (full also equal to the served f32 kernel, the same
# body) and P8's precisions.

@pytest.mark.parametrize("B", [2048, 208])
@pytest.mark.parametrize("variant", pv3.VARIANTS)
def test_probe_v3_anatomy_matches_plain(cuda, variant, B):
    g = pv3.geometry()
    w, kw = pv3.weights(g, "cuda"), pv3.launch_kw(g, "cuda")
    hist, x = pv3.inputs(g, B=B, seed=13, device="cuda")
    x[0:g.in_per_launch:97] = -32768
    x[1:g.in_per_launch:89] = 32767
    hist.random_(-32768, 32768)
    want = pv3.anatomy_reference(variant, hist, x, w, **kw)
    got = pv3.anatomy(variant, hist, x, w, **kw)
    assert torch.equal(got, want)
    if variant in ("full", "hoist"):
        assert torch.equal(got, pv3.served(hist, x, w, **kw))
    if variant == "hoist":
        al = pv3.AnatomyLaunch(variant, hist, x, w, **kw)
        assert pv3.split_check(al, hist, x)["split_mismatches"] == 0


def _wide(form, w, x, seed):
    """Full-range int16 / int32 operands for the wide forms."""
    rng = np.random.default_rng(seed)
    lo, hi, dt = ((-2 ** 31, 2 ** 31, np.int32) if form == "i32i32"
                  else (-32768, 32768, np.int16))
    if form in ("i16i16", "i16i8", "i32i32"):
        w = torch.from_numpy(rng.integers(lo, hi, tuple(w.shape)).astype(dt))
    if form in ("i16i16", "i32i32"):
        x = torch.from_numpy(rng.integers(lo, hi, tuple(x.shape)).astype(dt))
    return w.cuda(), x.cuda()


@pytest.mark.parametrize("shape", [(512, 264, 128), (256, 100, 64)],
                         ids=["full", "ragged"])
@pytest.mark.parametrize("form", list(pid.FORMS))
def test_probe_int_dot_matches_plain(cuda, form, shape):
    C, K, LB = shape
    w, x = _wide(form, *pid.inputs(C, K, LB, seed=C + K), seed=K)
    want = pid.int_dot_reference(w, x, form)
    assert torch.equal(pid.int_dot(w, x, form, iters=17), want)
    if form != "bf16bf16":
        il = pid.int_dot_launch(w, x, form)
        assert il.n_ctas >= il.plan.units
        assert torch.equal(il.run(16), want)


@pytest.mark.parametrize("B", [2048, 136])
@pytest.mark.parametrize("variant", pka.VARIANTS)
def test_probe_f32_anatomy_matches_plain(cuda, variant, B):
    g = pka.geometry()
    w, kw = pka.weights(g, "cuda"), pka.launch_kw(g, "cuda")
    x16 = pka.inputs(g, B=B, seed=14, device="cuda")
    x16[0, ::7], x16[1, ::7] = -32768, 32767
    x = pka.variant_input(variant, x16)
    got = pka.anatomy(variant, x, w, **kw)
    want = pka.anatomy_reference(variant, x, w, **kw)
    _compare(got.cpu().numpy(), want.cpu().numpy(),
             "int8" if variant == "nodot" else "highest")
    if variant == "full":
        served = served_tiled(x16.new_zeros((0, B)), x16, w,
                              scheme="highest", **kw)
        assert torch.equal(got, served)


@pytest.mark.parametrize("shape", [(64, 2048), (5, 136)],
                         ids=["full", "ragged"])
@pytest.mark.parametrize("mode", ppb.PRECISIONS)
def test_probe_prec_matches_plain(cuda, mode, shape):
    n_blocks, B = shape
    g = ppb.geometry(n_blocks)
    w = torch.from_numpy(g.w).cuda()
    x = ppb.inputs(g, B=B, seed=15, device="cuda")
    x[0, ::7], x[1, ::7] = -32768, 32767
    got = ppb.prec(mode, w, x, n_blocks)
    want = ppb.prec_reference(mode, w, x, n_blocks)
    _compare(got.cpu().numpy(), want.cpu().numpy(), "highest")


# -- probes P9-P12 ---------------------------------------------------------
# Each kernel against its plain version at the TPU probe's full shape and at
# a ragged one: 0 mismatches for P9's int8 and P10; max |err| <= 1 within
# the tie bound for P9's split5, P11 and P12.  P9's kernels are the served
# tiled bodies with no history (equal to resample_tiled at H = 0), P11's
# forms and the served f32 kernel are one FMA chain (equal bit for bit),
# P12's conv is P6's full.

@pytest.mark.parametrize("B", [2048, 200])
@pytest.mark.parametrize("scheme", pv5.SCHEMES)
def test_probe_v5_bench_matches_plain(cuda, scheme, B):
    g = pv5.geometry()
    w, kw = pv5.weights(g, scheme, "cuda"), pv5.launch_kw(g, scheme, "cuda")
    x = pv5.inputs(g, B=B, seed=16, device="cuda")
    x[0::97], x[1::89] = -32768, 32767
    got = pv5.bench(scheme, x, w, **kw)
    want = pv5.bench_reference(scheme, x, w, **kw)
    _compare(got.cpu().numpy(), want.cpu().numpy(), scheme)
    served = served_tiled(x.new_zeros((0, B)), x, w, scheme=scheme, **kw)
    assert torch.equal(got, served)


@pytest.mark.parametrize("form", pkl.FORMS)
@pytest.mark.parametrize("K", pkl.KS + (100,))
def test_probe_k_layout_matches_plain(cuda, K, form):
    w, x = pkl.operands(K, form, seed=K, device="cuda")
    want = pkl.k_layout_reference(w, x, form)
    assert torch.equal(pkl.k_layout(w, x, form, iters=17), want)
    rl = pkl.k_layout_launch(w, x, form)
    assert rl.n_ctas >= rl.plan.units and rl.plan.reps == 16
    assert torch.equal(rl.run(16), want)


@pytest.mark.parametrize("B", [2048, 136])
@pytest.mark.parametrize("case", [("m-loop", 128), ("m-loop", 64),
                                  ("batched", 128)], ids=str)
def test_probe_batched_dot_matches_plain(cuda, case, B):
    form, lanes = case
    g = pbd.geometry()
    w, kw = pbd.weights(g, "cuda"), pbd.launch_kw(g, "cuda")
    hist, x = pbd.inputs(g, B=B, seed=17, device="cuda")
    hist.random_(-32768, 32768)
    x[0:g.n_in:97], x[1:g.n_in:89] = -32768, 32767
    got = pbd.batched_dot(form, hist, x, w, lanes=lanes, **kw)
    want = pbd.batched_dot_reference(form, hist, x, w, **kw)
    _compare(got.cpu().numpy(), want.cpu().numpy(), "highest")
    # the served f32 kernel at this launch: one FMA chain in tap order
    assert torch.equal(got, served_tiled(hist, x, w, scheme="highest", **kw))
    if form == "batched":
        bl = pbd.BatchedLaunch(form, hist, x, w, **kw)
        assert torch.equal(bl.run_patches(),
                           pbd.patches_reference(hist, x, g.K, **kw))


@pytest.mark.parametrize("B", [2048, 136])
def test_probe_v3_bench_step_matches_plain(cuda, B):
    g = pka.geometry()
    w, kw = pka.weights(g, "cuda"), pka.launch_kw(g, "cuda")
    x, chunk, hist = pv3b.inputs(g, B=B, seed=18, device="cuda")
    hist.random_(-32768, 32768)
    assert torch.equal(pv3b.conv(x, w, **kw), pka.anatomy("full", x, w, **kw))
    h, y = pv3b.step(hist, chunk, w, **kw)
    h2, y2 = pv3b.step_reference(hist, chunk, w, **kw)
    assert torch.equal(h, h2)
    _compare(y.cpu().numpy(), y2.cpu().numpy(), "highest")
    # the step captured in a CUDA graph gives the eager step's bits
    out = {}

    def fn():
        out["h"], out["y"] = pv3b.step(hist, chunk, w, **kw)
    pv3b.graph_ms(fn, reps=2)
    torch.cuda.synchronize()
    assert torch.equal(out["h"], h) and torch.equal(out["y"], y)


# -- the gather and fixed dense kernels --------------------------------------

def _gather_step(fixed: bool, f0: int = 0):
    spec = tfd.design_filter(44100, 44101, 7, fixed_point=fixed)
    bspec = tb._launch_geometry(spec, 44100, f0=f0)
    step = tb.make_batched_step(spec, bspec, device="cuda")
    assert step.kernel == "gather"
    return bspec, step


def _forced(step, form: str, taps=None):
    """The launch arguments of a gather step with its form forced: an
    explicit plan of that form (and, for the band and stream forms, its
    band) over the step's starts, for its taps or ``taps``."""
    taps = step.w[0] if taps is None else taps
    starts = step.w[1].cpu().numpy()
    N = taps.shape[-1]
    n_accum = None
    if step.scheme == "fixed":
        n_accum = 4 if taps.ndim == 3 else 1
    if form == "rows":       # float only
        return dict(plan=tfm.gather_plan_rows(starts, N))
    planner = (tfm.gather_plan_band if form == "band"
               else tfm.gather_plan_stream)
    plan = planner(starts, N, n_accum=n_accum)
    return dict(plan=plan, band=tfm.gather_band(taps, starts, plan))


def _graph_equals_eager(fn, want):
    """fn captured in a CUDA graph (after a warm-up on a side stream)
    replays to ``want`` bit for bit."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)


@pytest.mark.parametrize("B", [2048, 130, 129, 64])
@pytest.mark.parametrize("f0", [0, 5900])
@pytest.mark.parametrize("fixed,form", [(False, "rows"), (False, "band"),
                                        (True, "band")],
                         ids=["float-rows", "float-band", "fixed-band"])
def test_gather_kernels_match_plain(cuda, fixed, form, f0, B):
    """The forms of the gather kernels (the fixed one has no rows form),
    each forced through an explicit plan, at the drift launch (44100 ->
    44101 q7, 44101 outputs, N 128), on transposed views of time-major
    memory, the axis in one operand and as the step passes it (hist and x
    apart, bit for bit the same), and replayed from a CUDA graph (bit for
    bit): fixed 0 mismatches with the wrap input on every third lane;
    float max |err| <= 1 within the tie bound, its raw f32 sums within one
    f32 rounding of the plain version's; one launch counted a call, under
    its kernel's key.  The step itself takes the band form here."""
    bspec, step = _gather_step(fixed, f0)
    assert step.kernel_kw["plan"].form == "band"
    hist, x = (torch.from_numpy(a).cuda() for a in launch_inputs(
        step, bspec.in_per_launch, B, seed=B + f0, wrap=fixed))
    X = torch.cat([hist, x]).t()
    fn = tfm.resample_gather_fixed if fixed else tfm.resample_gather
    ref = (tfm.resample_gather_fixed_reference if fixed
           else tfm.resample_gather_reference)
    kw = _forced(step, form)
    key = tfm.launch_key(step.scheme, form)
    before = dict(tfm.launches)
    got = fn(X, *step.w, **kw)
    apart = fn(x[:bspec.in_per_launch].t(), *step.w, hist=hist.t(), **kw)
    want = ref(X, *step.w)
    torch.cuda.synchronize()
    assert tfm.launches == {**before, key: before[key] + 2}
    assert torch.equal(apart, got)
    assert got.shape == want.shape == (B, bspec.out_per_launch)
    _compare(got.cpu().numpy(), want.cpu().numpy(),
             "int8" if fixed else "highest")
    _graph_equals_eager(lambda: fn(x[:bspec.in_per_launch].t(), *step.w,
                                   hist=hist.t(), **kw), got)
    if not fixed:
        g = fn(X, *step.w, raw=True, **kw)
        w = ref(X, *step.w, raw=True)
        ulp = torch.abs(torch.nextafter(w, w + 1) - w)
        assert bool(((g - w).abs() <= ulp).all())


@pytest.mark.parametrize("starts", ["drift", "synthetic"])
@pytest.mark.parametrize("B", [2048, 130, 64])
def test_gather_band_fixed_direct(cuda, B, starts):
    """gather_fir_fixed_band_kernel<1> (64 outputs a group) on direct
    taps (each drift output's largest accumulator row) over the drift
    starts or synthetic dense-band ones (outputs 0-2 rows apart): 0
    mismatches against the plain version, with the wrap input on every
    third lane."""
    bspec, step = _gather_step(True)
    taps4 = step.w[0]
    rows = taps4.abs().sum(-1).argmax(1)
    taps = taps4[torch.arange(taps4.shape[0], device="cuda"), rows]
    taps = taps.contiguous()
    S = step.w[1]
    if starts == "synthetic":
        n, N = S.numel(), taps.shape[-1]
        s = np.cumsum(np.random.default_rng(B).integers(0, 3, n))
        last = step.hist_rows + bspec.in_per_launch - N
        S = torch.from_numpy(np.minimum(s, last).astype(np.int32)).cuda()
    hist, x = launch_inputs(step, bspec.in_per_launch, B, seed=B, wrap=False)
    from fixed_inputs import wrap_column
    o = int(np.flatnonzero(S.cpu().numpy() >= step.hist_rows)[0])
    t = taps[o].cpu().numpy().astype(np.int64)
    x = x.copy()
    assert wrap_column(t, x, np.arange(0, B, 3),
                       int(S[o]) - step.hist_rows) > 2 ** 31
    hist, x = torch.from_numpy(hist).cuda(), torch.from_numpy(x).cuda()
    X = torch.cat([hist, x]).t()
    want = tfm.resample_gather_fixed_reference(X, taps, S)
    s_host = S.cpu().numpy()
    plan = tfm.gather_plan_band(s_host, taps.shape[-1], n_accum=1)
    assert plan.outputs == 64
    kw = dict(plan=plan, band=tfm.gather_band(taps, s_host, plan))
    got = tfm.resample_gather_fixed(x[:bspec.in_per_launch].t(), taps, S,
                                    hist=hist.t(), **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _steep_step(fixed: bool):
    spec = tfd.design_filter(96000, 401, 3, fixed_point=fixed)
    bspec = tb._launch_geometry(spec, 44100)
    step = tb.make_batched_step(spec, bspec, device="cuda")
    assert step.kernel == "gather"
    return bspec, step


@pytest.mark.parametrize("B", [130, 64])
@pytest.mark.parametrize("fixed", [False], ids=["float"])
def test_gather_kernels_stage_rows_in_pieces(cuda, fixed, B):
    """96000 -> 401 q3, a steep gather decimation (N 11496, 8 outputs'
    windows 1676 rows apart): the float rows form's plan, forced, stages
    each chunk's rows in pieces, and the kernel equals its plain version
    within the tie bound, hist apart and one operand alike (the fixed
    gather has no rows form)."""
    bspec, step = _steep_step(fixed)
    plan = _forced(step, "rows")["plan"]
    assert plan.outputs == 8 and plan.form == "rows"
    assert plan.rows < 1676 + plan.taps
    hist, x = (torch.from_numpy(a).cuda() for a in launch_inputs(
        step, bspec.in_per_launch, B, seed=B, wrap=False))
    X = torch.cat([hist, x]).t()
    fn = tfm.resample_gather_fixed if fixed else tfm.resample_gather
    ref = (tfm.resample_gather_fixed_reference if fixed
           else tfm.resample_gather_reference)
    got = fn(x[:bspec.in_per_launch].t(), *step.w, hist=hist.t(), plan=plan)
    one = fn(X, *step.w, plan=plan)
    want = ref(X, *step.w)
    torch.cuda.synchronize()
    assert torch.equal(got, one)
    _compare(got.cpu().numpy(), want.cpu().numpy(),
             "int8" if fixed else "highest")


@pytest.mark.parametrize("B", [2048, 130, 64, 2])
@pytest.mark.parametrize("fixed", [False, True], ids=["float", "fixed"])
def test_gather_stream_kernels_match_plain(cuda, fixed, B):
    """The steep decimation's own plan, the stream form
    (gather_fir_f64mma_stream_kernel, gather_fir_fixed_stream_kernel<4>:
    16 outputs a tile, K 15104, split over CTAs where the card has room),
    against the plain version: fixed bit for bit, float within the tie
    bound and its raw f32 sums within one f32 rounding; hist read in place
    and the axis as one operand bit for bit alike, and a CUDA graph's
    replay bit for bit the eager launch; one launch counted a call, under
    the stream key."""
    bspec, step = _steep_step(fixed)
    kw = dict(step.kernel_kw)
    assert kw["plan"].form == "stream" and kw["plan"].taps == 15104
    hist, x = (torch.from_numpy(a).cuda() for a in launch_inputs(
        step, bspec.in_per_launch, B, seed=B, wrap=False))
    X = torch.cat([hist, x]).t()
    fn = tfm.resample_gather_fixed if fixed else tfm.resample_gather
    ref = (tfm.resample_gather_fixed_reference if fixed
           else tfm.resample_gather_reference)
    key = tfm.launch_key(step.scheme, "stream")
    before = dict(tfm.launches)
    got = fn(x[:bspec.in_per_launch].t(), *step.w, hist=hist.t(), **kw)
    one = fn(X, *step.w, **kw)
    want = ref(X, *step.w)
    torch.cuda.synchronize()
    assert tfm.launches == {**before, key: before[key] + 2}
    assert torch.equal(got, one)
    assert got.shape == want.shape == (B, bspec.out_per_launch)
    _compare(got.cpu().numpy(), want.cpu().numpy(),
             "int8" if fixed else "highest")
    _graph_equals_eager(lambda: fn(x[:bspec.in_per_launch].t(), *step.w,
                                   hist=hist.t(), **kw), got)
    if not fixed:
        g = fn(X, *step.w, raw=True, **kw)
        w = ref(X, *step.w, raw=True)
        ulp = torch.abs(torch.nextafter(w, w + 1) - w)
        assert bool(((g - w).abs() <= ulp).all())


@pytest.mark.parametrize("B", [2048, 130, 64])
@pytest.mark.parametrize("n_accum", [4, 1], ids=["interp", "direct"])
def test_gather_stream_fixed_wraps_at_drift(cuda, n_accum, B):
    """gather_fir_fixed_stream_kernel<4> and <1> forced at the drift launch
    (44100 -> 44101 q7; direct: each output's largest accumulator row, 32
    outputs a group), where the wrap input on every third lane drives an
    int32 sum past 2^31: 0 mismatches against the plain version."""
    bspec, step = _gather_step(True)
    taps = step.w[0]
    if n_accum == 1:
        rows = taps.abs().sum(-1).argmax(1)
        taps = taps[torch.arange(taps.shape[0], device="cuda"),
                    rows].contiguous()
    hist, x = launch_inputs(step, bspec.in_per_launch, B, seed=B,
                            wrap=n_accum == 4)
    S = step.w[1]
    if n_accum == 1:
        x = x.copy()
        o = int(np.flatnonzero(S.cpu().numpy() >= step.hist_rows)[0])
        t = taps[o].cpu().numpy().astype(np.int64)
        assert wrap_column(t, x, np.arange(0, B, 3),
                           int(S[o]) - step.hist_rows) > 2 ** 31
    hist, x = torch.from_numpy(hist).cuda(), torch.from_numpy(x).cuda()
    w = (taps, S) + tuple(step.w[2:] if n_accum == 4 else ())
    kw = _forced(step, "stream", taps)
    assert kw["plan"].outputs == (16 if n_accum == 4 else 32)
    got = tfm.resample_gather_fixed(x[:bspec.in_per_launch].t(), *w,
                                    hist=hist.t(), **kw)
    want = tfm.resample_gather_fixed_reference(torch.cat([hist, x]).t(), *w)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_gather_stream_smem_and_guards(cuda):
    """The library's streamed shared memory equals the host's formula; a
    stream launch refuses f32 samples (TypeError) and a band of the other
    form (ValueError) before any launch."""
    lib = _build.load()
    for n_accum in (None, 4, 1):
        assert lib.gather_fir_stream_smem(n_accum or 0) \
            == tfm._stream_smem(n_accum)
    bspec, step = _steep_step(False)
    kw = dict(step.kernel_kw)
    hist, x = (torch.from_numpy(a).cuda() for a in launch_inputs(
        step, bspec.in_per_launch, 8, seed=1, wrap=False))
    with pytest.raises(TypeError, match="int16"):
        tfm.resample_gather(x[:bspec.in_per_launch].t().float(), *step.w,
                            hist=hist.t().float(), **kw)
    band = kw["band"]._replace(w=kw["band"].w.double())
    with pytest.raises(ValueError, match="band"):
        tfm.resample_gather(x[:bspec.in_per_launch].t(), *step.w,
                            hist=hist.t(), plan=kw["plan"], band=band)


def _resident_per_sm(threads: int, regs: int, smem: int) -> int:
    """The CTAs of a kernel one multiprocessor holds at once, worked out
    from the card's limits (``torch.cuda.get_device_properties``) as CUDA's
    occupancy calculator does: threads (in whole warps), registers (256 a
    warp's unit, a quarter of the file a scheduler), shared memory (the
    CTA's plus the 1 KB the system keeps, in 128-byte units), 32 CTAs."""
    prop = torch.cuda.get_device_properties(0)
    warps = -(-threads // 32)
    by_threads = getattr(prop, "max_threads_per_multi_processor", 2048) \
        // 32 // warps
    reg_file = getattr(prop, "regs_per_multiprocessor", 65536)
    per_warp = -(-regs * 32 // 256) * 256
    by_regs = reg_file // 4 // per_warp * 4 // warps
    per_cta = -(-(smem + 1024) // 128) * 128
    by_smem = getattr(prop, "shared_memory_per_multiprocessor",
                      233472) // per_cta
    return min(32, by_threads, by_regs, by_smem)


@pytest.mark.parametrize("fixed", [False, True], ids=["float", "fixed"])
@pytest.mark.parametrize("launch", ["drift-band", "steep-stream"])
def test_gather_counts_equal_the_launch_grid_and_occupancy(cuda, tmp_path,
                                                           launch, fixed):
    """The port's gather counters (``utils/launches.gather_counts``) of one
    step call at 2048 lanes: 1 launch; CTAs equal to the grid the
    profiler's trace records for the kernel; resident CTAs equal to the
    multiprocessors times the CTAs one holds at the kernel's registers and
    shared memory as the trace records them (min with the grid); tiles
    ceil(n_out / outputs) x 32.  At the drift band, float: 2,760 CTAs, one
    an SM, over 22,080 tiles."""
    from speex_resampler_tpu_torch.utils.launches import (gather_counts,
                                                          reset_launches,
                                                          step_kernel)
    bspec, step = (_gather_step if launch == "drift-band"
                   else _steep_step)(fixed)
    plan = step.kernel_kw["plan"]
    assert plan.form == launch.split("-")[1]
    B = 2048
    hist, x = (torch.from_numpy(a).cuda() for a in launch_inputs(
        step, bspec.in_per_launch, B, seed=3, wrap=False))
    step.fn(hist, x, step.w)          # warm-up: the library is loaded
    torch.cuda.synchronize()
    reset_launches()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step.fn(hist, x, step.w)
        torch.cuda.synchronize()
    trace = tmp_path / "trace.json"
    prof.export_chrome_trace(str(trace))
    name = step_kernel(step)[1].split("<")[0]
    kernels = [e for e in json.loads(trace.read_text())["traceEvents"]
               if e.get("cat") == "kernel" and name in e.get("name", "")]
    assert len(kernels) == 1, [e.get("name") for e in kernels]
    args = kernels[0]["args"]
    grid = math.prod(args["grid"])
    per_sm = _resident_per_sm(math.prod(args["block"]),
                              args["registers per thread"],
                              args["shared memory"])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n_out = bspec.out_per_launch
    tiles = -(-n_out // plan.outputs) * (B // 64)
    assert gather_counts() == (1, grid, min(grid, sms * per_sm), tiles)
    if (launch, fixed) == ("drift-band", False) and sms == 132:
        assert gather_counts() == (1, 2760, 132, 22080)
    reset_launches()
    assert gather_counts() == (0, 0, 0, 0)


@pytest.mark.parametrize("form", ["rows", "band"])
@pytest.mark.parametrize("x_dtype", [torch.int16, torch.float32])
def test_gather_kernel_single_stream_layout(cuda, x_dtype, form):
    """The single-stream route's layout: a contiguous [channels, T] x of
    int16 or f32 samples (a lane stride T: element loads), 3 channels, raw
    f32 sums and WORD2INT, the plan made from the host's starts for that
    sample width (the band form) and the rows form (as the route takes
    it)."""
    spec = tfd.design_filter(44100, 44101, 7)
    N, n_out = spec.filt_len, 5000
    rng = np.random.default_rng(12)
    t = np.arange(n_out, dtype=np.int64) * spec.num
    starts = np.minimum(t // spec.den, 6000 - N).astype(np.int32)
    taps = spec.phase_rows(t % spec.den)
    x = rng.integers(-32768, 32768, (3, 6000)).astype(
        np.int16 if x_dtype == torch.int16 else np.float32)
    if x_dtype == torch.float32:
        x += rng.random(x.shape).astype(np.float32)
    plan = tfm.gather_plan(starts, N, x_itemsize=x.dtype.itemsize)
    assert plan.form == "band"
    band = tfm.gather_band(taps, starts, plan, "cuda")
    if form == "rows":
        plan = tfm.gather_plan_rows(starts, N, x_itemsize=x.dtype.itemsize)
        band = None
    X, T, S = (torch.from_numpy(a).cuda() for a in (x, taps, starts))
    for raw in (False, True):
        got = tfm.resample_gather(X, T, S, raw=raw, plan=plan, band=band)
        want = tfm.resample_gather_reference(X, T, S, raw=raw)
        if raw:
            ulp = torch.abs(torch.nextafter(want, want + 1) - want)
            assert bool(((got - want).abs() <= ulp).all())
        else:
            _compare(got.cpu().numpy(), want.cpu().numpy(), "highest")


def test_single_stream_gather_route_keeps_non_finite_samples_local(cuda):
    """The single-stream gather route (44100 -> 44101 q7, the float-sample
    API, its rows form) leaves an output finite unless its own window
    holds a non-finite sample: with an Inf and a NaN among the samples,
    the card's finite mask equals device="cpu"'s (the plain version) and
    its finite outputs are within one f32 rounding of it."""
    rng = np.random.default_rng(21)
    x = rng.uniform(-32768, 32768, (20000, 2)).astype(np.float32)
    x[7000, 0], x[12000, 1] = np.inf, np.nan
    before = tfm.launches["highest"]
    got, want = (SpeexResampler(2, 44100, 44101, 7, engine="device",
                                device=d).process_chunk_float(x)
                 for d in ("cuda", "cpu"))
    assert tfm.launches["highest"] > before
    assert got.shape == want.shape
    finite = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), finite)
    assert not finite.all()
    assert bool((np.abs(got[finite] - want[finite])
                 <= np.spacing(np.abs(want[finite]))).all())


DENSE_FIXED = [((44100, 48000, 3), 882), ((48000, 16000, 3), 960),
               ((16000, 48000, 3), 320)]


@pytest.mark.parametrize("B", [2048, 130, 129, 64])
@pytest.mark.parametrize("cfg,cap", DENSE_FIXED,
                         ids=["R160-interp", "R96-direct", "R129-interp"])
def test_dense_fixed_kernel_matches_plain(cuda, cfg, cap, B):
    """dense_fir_fixed_kernel<4> (voip, and R 129: zero columns past R)
    and <1> (48k -> 16k, direct) against the plain version: 0 mismatches,
    with the wrap input on every third lane, at f0 = 0."""
    i, o, q = cfg
    g = math.gcd(i, o)
    spec = tfd.design_filter(i // g, o // g, q, fixed_point=True)
    bspec = tb._launch_geometry(spec, 4096, max_in_frames=cap)
    step = tb.make_batched_step(spec, bspec, device="cuda")
    assert (step.kernel, step.scheme) == ("dense", "fixed")
    hist, x = (torch.from_numpy(a).cuda() for a in launch_inputs(
        step, bspec.in_per_launch, B, seed=B))
    before = tdf.launches["fixed"]
    got = tdf.resample_dense_fixed(hist, x, step.w, **step.kernel_kw)
    want = tdf.resample_dense_fixed_reference(hist, x, step.w,
                                              **step.kernel_kw)
    torch.cuda.synchronize()
    assert tdf.launches["fixed"] == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("kind", ["gather", "gather-fixed", "dense-fixed"])
def test_new_kernel_steps_graph_equal_eager(cuda, kind):
    """The drift gather steps and the fixed voip dense step captured in a
    CUDA graph (after a warm-up on a side stream): a replay equals the
    eager step, and after new inputs are copied in, the eager step on
    them; the kernel count (a gather's under the key of its step's form)
    moves once, at capture."""
    fixed = kind != "gather"
    if kind == "dense-fixed":
        spec = tfd.design_filter(147, 160, 3, fixed_point=True)
        bspec = tb._launch_geometry(spec, 4096, max_in_frames=882)
        step = tb.make_batched_step(spec, bspec, device="cuda")
        module, key = tdf, step.scheme
    else:
        bspec, step = _gather_step(fixed)
        module = tfm
        key = tfm.launch_key(step.scheme, step.kernel_kw["plan"].form)
    inputs = [[torch.from_numpy(a).cuda() for a in launch_inputs(
        step, bspec.in_per_launch, 256, seed=s, wrap=fixed)] for s in (1, 2)]
    eager = [step.fn(h, xx, step.w) for h, xx in inputs]
    hist, x = (t.clone() for t in inputs[0])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step.fn(hist, x, step.w)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    before = module.launches[key]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step.fn(hist, x, step.w)
    assert module.launches[key] == before + 1
    for (h, xx), want in zip(inputs, eager):
        hist.copy_(h)
        x.copy_(xx)
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(o, w) for o, w in zip(out, want))
    assert module.launches[key] == before + 1


def test_clear_step_cache_frees_device_memory(cuda):
    """A step's device weights stay allocated while the step cache holds
    it, and are freed by clear_step_cache once no engine holds the step."""
    tb.clear_step_cache()
    gc.collect()
    base = torch.cuda.memory_allocated()
    spec = tfd.design_filter(160, 147, 10)
    step = tb.make_batched_step(spec, tb._launch_geometry(spec, 20480),
                                device="cuda")
    nbytes = tb._step_weight_bytes(step)
    del step
    gc.collect()
    held = torch.cuda.memory_allocated()
    assert held - base >= nbytes > 10 * 2 ** 20
    tb.clear_step_cache()
    gc.collect()
    assert torch.cuda.memory_allocated() <= held - nbytes


# -- the fuzz campaign and the MultiFleet soak (tools/fuzz_torch.py,
# tools/soak_torch.py) on the card -----------------------------------------

def test_fuzz_campaign_draws_pass_on_the_card(cuda):
    """Ten seeded draws of the campaign (the first ten classes of its
    stratified round): none fails, and each batch draw launched its
    kernel (a class's name less its geometry mark)."""
    from tools import fuzz_torch as fz
    out = fz.campaign(19, 10, float("inf"), "cuda")
    assert out["draws"] == 10 and out["failures"] == [], out["failures"]
    for klass in fz.CLASSES[:10]:
        assert out["launches"].get(fz.class_kernel(klass), 0) > 0, \
            (klass, out["launches"])


def test_soak_on_the_card_holds_memory_flat(cuda):
    """15 s of MultiFleet churn at 64 stereo streams a bucket: no bucket
    degraded, every bucket's kernel launched, RSS, device-allocated and
    pinned bytes within the soak's peak and final growth limits."""
    from tools import soak_torch as sk
    gc.collect()
    res = sk.soak(15, "cuda")
    assert res["pass"], res["failed"]
    assert set(res["series"]) == {"rss", "device_allocated", "pinned"}
    assert res["launches_by_kernel"] and min(
        res["launches_by_kernel"].values()) > 0
