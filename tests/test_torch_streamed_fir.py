"""The port's streamed FIR launch against the JAX package's v4 Pallas kernel.

``resample_streamed_reference`` (the CUDA kernel's plain PyTorch version,
and what ``resample_streamed`` runs for CPU tensors) is held against
``resample_conv_tm_pallas_v4`` in interpret mode, reached through the JAX
package's ``make_batched_step``, with the same history, slab and step
weights (the JAX step's, carried over with
``weights_from_jax(kernel="streamed")``): 48k->44.1k q10 (P = 147,
K_pad = 512) at f0 = 0 and at the phase a flush leaves, B = 4 and
B = 130 (the JAX wrapper pads lanes to 128; the port masks them), schemes
highest, int8 with D = 3 (explicit "int8") and D = 4 (what "auto"
resolves).

Tolerance: "int8" is bit-identical (exact integer dots, the same f32
epilogue order); "highest" is within the LSB contract
(conftest.assert_lsb_close), its f32 sums running in another order.  The
CUDA kernel itself is held against the plain version by
tests/test_torch_gpu.py and chip_smoke.py on the card.
"""

import math

import numpy as np
import pytest
import torch

from speex_resampler_tpu.ops import filter_design as jfd
from speex_resampler_tpu.ops import pallas_fir as jpf
from speex_resampler_tpu.parallel import batch as jb
from speex_resampler_tpu_torch.ops import filter_design as tfd
from speex_resampler_tpu_torch.ops import phase as tph
from speex_resampler_tpu_torch.ops import streamed_fir as tsf
from speex_resampler_tpu_torch.ops import tiled_fir as ttf
from speex_resampler_tpu_torch.parallel import batch as tb

from conftest import assert_lsb_close

torch.set_num_threads(1)

SLICE = (48000, 44100, 10)
TARGET = 20480                     # one weight period, S = 20480
# streamed configs: every 48k->44.1k quality, and 44.1k->16k q7 (P = 20)
STREAMED = [(48000, 44100, 5), (48000, 44100, 7), SLICE, (44100, 16000, 7)]
# "auto" is int8 with D = 4 (D = 3 certifies 0.309 > 0.20); explicit
# "int8" accepts D = 3 (0.309 < 0.35)
SCHEMES = {"highest": ("highest", None), "int8-D3": ("int8", 3),
           "int8-D4": ("auto", 4)}


def _spec(pkg, cfg, fixed=False):
    i, o, q = cfg
    g = math.gcd(i, o)
    return pkg.design_filter(i // g, o // g, q, fixed_point=fixed)


def _flush_f0(spec, staged: int) -> int:
    """Fractional phase a flush of ``staged`` frames leaves (from f0 0)."""
    m = tph.producible_outputs(staged, 0, 0, spec.num, spec.den)
    return (m * spec.num) % spec.den


def test_flush_phases_of_the_slice():
    """The flush that chip_smoke.py and the engine tests rely on: 4040
    staged frames move f0 to a non-zero phase, 3040 leave it at 0."""
    spec = _spec(tfd, SLICE)
    assert _flush_f0(spec, 4040) == 40
    assert _flush_f0(spec, 3040) == 0


@pytest.fixture
def auto_resolves(monkeypatch):
    """The JAX package resolves "auto" as on the TPU (int8 with the
    digit-escalating certificate), not as "highest" under interpret."""
    monkeypatch.setattr(jb, "AUTO_RESOLVE_UNDER_INTERPRET", True)


def _steps(f0: int, scheme: str):
    js, ts = _spec(jfd, SLICE), _spec(tfd, SLICE)
    jspec = jb._launch_geometry(js, TARGET, use_pallas=True, f0=f0)
    tspec = tb._launch_geometry(ts, TARGET, f0=f0)
    assert tspec.kernel == jspec.kernel == "streamed"
    assert (tspec.n_blocks, tspec.P) == (jspec.n_blocks, jspec.P) == (147, 147)
    jstep = jb.make_batched_step(js, jspec, use_pallas=True,
                                 pallas_interpret=True, scheme=scheme)
    tstep = tb.make_batched_step(ts, tspec, device="cpu", scheme=scheme)
    assert jstep.scheme == tstep.scheme and tstep.kernel == "streamed"
    return jstep, tstep, tspec


def _inputs(step, n_in, B, seed):
    rng = np.random.default_rng(seed)
    hist = rng.integers(-32768, 32768, (step.hist_rows, B), dtype=np.int16)
    x = np.zeros((step.chunk_rows, B), dtype=np.int16)
    x[:n_in] = rng.integers(-32768, 32768, (n_in, B), dtype=np.int16)
    return hist, x


@pytest.mark.parametrize("B", [4, 130])
@pytest.mark.parametrize("f0", ["0", "flush4040"])
@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_reference_matches_jax_v4(auto_resolves, scheme, f0, B):
    request, digits = SCHEMES[scheme]
    f0 = _flush_f0(_spec(tfd, SLICE), 4040) if f0 == "flush4040" else 0
    jstep, tstep, tspec = _steps(f0, request)
    if digits:
        assert tstep.scheme == "int8" and tstep.w[0].shape[0] == digits
    jw = (np.asarray(jstep.w) if jstep.scheme == "highest"
          else tuple(np.asarray(a) for a in jstep.w))
    w = tb.weights_from_jax(jw, jstep.scheme, device="cpu",
                            kernel="streamed")
    hist, x = _inputs(tstep, tspec.in_per_launch, B, seed=B + f0)
    _, jy = jstep.fn(hist, x, jstep.w)
    ty = tsf.resample_streamed_reference(
        torch.from_numpy(hist), torch.from_numpy(x), w, **tstep.kernel_kw)
    assert ty.shape == (tspec.out_per_launch, B)
    got, want = ty.numpy(), np.asarray(jy)
    if tstep.scheme == "int8":
        assert int((got != want).sum()) == 0
    else:
        assert_lsb_close(got, want)


# every streamed config, and the tiled geometry's: the flagship float and
# fixed, 24k->48k q5 fixed (direct, n_accum 1), 96k->8k q10 (split5, P 1)
CLOSED_FORM = ([(cfg, False, "streamed") for cfg in STREAMED]
               + [((44100, 48000, 7), False, "tiled"),
                  ((44100, 48000, 7), True, "tiled"),
                  ((24000, 48000, 5), True, "tiled"),
                  ((96000, 8000, 10), False, "tiled")])


@pytest.mark.parametrize(
    "cfg,fixed,kernel", CLOSED_FORM,
    ids=lambda c: "%d-%d-q%d" % c if isinstance(c, tuple)
    else ("fixed" if c is True else "" if c is False else c))
def test_closed_form_origin_equals_tiled_offsets(cfg, fixed, kernel):
    """v4's closed-form origin equals K1's (k // P) * S + offsets[k % P]
    over two periods at several phases (0, those a flush leaves), in both
    phase-tiled geometries and both universes: the one launcher's origins
    serve the tiled steps too.  The blocks whose window starts inside the
    history are exactly v4's _v4_hist_plans."""
    spec = _spec(tfd, cfg, fixed)
    assert tb._launch_geometry(spec, TARGET).kernel == kernel
    H = tb._hist_rows_tiled(spec.filt_len)
    shift = H - (spec.filt_len - 1)
    # the phases flushes leave (always 0 at 24k->48k and 96k->8k, whose
    # den 2 and 1 give 7 % den and 40 % den every phase there is)
    flushed = {_flush_f0(spec, n) for n in (4040, 3368, 1001)}
    for f0 in sorted({f % spec.den for f in (0, 7, 40)} | flushed):
        ptw = tb._tiled_weights(spec, f0)
        k = np.arange(2 * ptw.P)
        want = (k // ptw.P) * ptw.S + ptw.offsets[k % ptw.P]
        got = tsf.origins(2 * ptw.P, ptw.R, shift=shift, num=spec.num,
                          den=spec.den, f0=f0).numpy()
        assert np.array_equal(got, want)
        K_pad = -(-ptw.K // 128) * 128
        plans = jpf._v4_hist_plans(ptw.R, K_pad, H, spec.num, spec.den,
                                   shift, f0)
        assert [p[0] for p in plans] == list(np.flatnonzero(got < H))
        assert [p[1] for p in plans] == list(got[got < H])


def test_wrapper_guards_and_cpu_tensors_never_launch():
    """On CPU tensors the wrapper runs the plain version and counts no
    launch, under "highest" and "split5" (within the LSB contract of each
    other); a chunk short of the zero rows, or the bare quantum, reads
    rows past its end as zero (the output of the zero-padded chunk); f32
    weights under "split5", an unknown scheme and a device without a
    kernel are refused."""
    _, tstep, tspec = _steps(0, "highest")
    hist, x = _inputs(tstep, tspec.in_per_launch, 3, seed=0)
    hist, x = torch.from_numpy(hist), torch.from_numpy(x)
    kw = tstep.kernel_kw
    before = dict(tsf.launches)
    y = tsf.resample_streamed(hist, x, tstep.w, **kw)
    assert tsf.launches == before
    assert torch.equal(y, tsf.resample_streamed_reference(hist, x, tstep.w,
                                                          **kw))
    for rows in (tspec.in_per_launch + 64, tspec.in_per_launch):
        short = x[:rows]
        assert rows < tstep.chunk_rows and not x[rows:].any()
        assert torch.equal(tsf.resample_streamed(hist, short, tstep.w, **kw),
                           y)
    w5 = tsf.device_weights_streamed(
        ttf.split5_weights(tstep.w[0].numpy()), "split5", "cpu")
    kw5 = {**kw, "scheme": "split5"}
    y5 = tsf.resample_streamed(hist, x, w5, **kw5)
    assert tsf.launches == before
    assert torch.equal(y5, tsf.resample_streamed_reference(hist, x, w5,
                                                           **kw5))
    assert_lsb_close(y5.numpy().ravel(), y.numpy().ravel())
    with pytest.raises(TypeError):
        tsf.resample_streamed(hist, x, tstep.w, **kw5)
    with pytest.raises(ValueError, match="scheme"):
        tsf.resample_streamed(hist, x, tstep.w, **{**kw, "scheme": "split6"})
    meta = torch.empty(hist.shape, dtype=torch.int16, device="meta")
    with pytest.raises(ValueError):
        tsf.resample_streamed(meta, x, tstep.w, **kw)


def test_step_cache_holds_the_slice_at_two_phases():
    """A flush moves f0 and rebuilds the step; the memo keeps both 38.5 MB
    steps of the slice (f32 [147, 512, 128]) without evicting either."""
    spec = _spec(tfd, SLICE)
    steps = [tb.make_batched_step(spec, tb._launch_geometry(spec, TARGET,
                                                            f0=f0),
                                  device="cpu", scheme="highest")
             for f0 in (0, 40)]
    assert tb._step_weight_bytes(steps[0]) >= 147 * 512 * 128 * 4
    for f0, step in zip((0, 40), steps):
        again = tb.make_batched_step(
            spec, tb._launch_geometry(spec, TARGET, f0=f0), device="cpu",
            scheme="highest")
        assert again is step
