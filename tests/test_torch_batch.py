"""The port's BatchedResampler against the JAX package's engine.

``BatchedResampler(device="cpu")`` (the CUDA kernel's plain version on the
main path) and the JAX engine in interpret mode get identical random
streams: ragged process() calls, a flush (which moves the fractional
phase and rebuilds the step), more process() calls after it, and a final
flush.  int8 outputs must be bit-identical; highest ones within the LSB
contract (conftest.assert_lsb_close).  The configs cover both geometries:
tiled (the 44.1k->48k flagship, 24k->48k) and streamed (48k->44.1k q10,
P = 147, where "auto" resolves int8 with D = 4; 44.1k->16k q7, P = 20).
Also: weights carried over from a JAX step, checkpoints crossing between
the packages, and the paths the port refuses.
"""

import dataclasses

import numpy as np
import pytest
import torch

from speex_resampler_tpu.parallel import batch as jb
from speex_resampler_tpu.parallel.batch import (BatchedResampler as JaxEngine,
                                                make_batched_step as jax_step,
                                                _launch_geometry as jax_geo)
from speex_resampler_tpu.ops import filter_design as jfd
from speex_resampler_tpu_torch import (BatchedResampler, ResamplerError,
                                       ResamplerErrorCode)
from speex_resampler_tpu_torch.ops import filter_design as tfd
from speex_resampler_tpu_torch.parallel import batch as tb

from conftest import assert_lsb_close

torch.set_num_threads(1)

S, C = 2, 2
# (in, out, quality, target_chunk_frames = one launch unit)
FLAGSHIP = (44100, 48000, 7, 2352)
UPSAMPLE = (24000, 48000, 5, 2560)     # P = 1, R = 256
CALLS = (3000, 1100, 2500)             # ragged, then flush, then AFTER
AFTER = (2600, 700)
# streamed: one launch per weight period (S = 20480 / 7056 frames)
SLICE = (48000, 44100, 10, 20480)
SPEECH = (44100, 16000, 7, 7056)
# two launches before the first flush, a staged remainder that moves f0
# (4040 frames -> f0 40 at 48k->44.1k), then one more launch; the final
# flush (1560 / 757 frames) brings f0 back to 0, so both packages reuse
# their memoized f0 = 0 step instead of decomposing a third weight set
SCHEDULES = {SLICE: ((25000, 7000, 13000), (22040,)),
             SPEECH: ((9000, 3000, 4000), (7813,))}


def _frames(n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-32768, 32768, (S, n, C), dtype=np.int16)


def _engines(cfg, scheme):
    i, o, q, target = cfg
    jax_eng = JaxEngine(S, C, i, o, q, target_chunk_frames=target,
                        use_pallas=True, pallas_interpret=True,
                        scheme=scheme)
    port = BatchedResampler(S, C, i, o, q, target_chunk_frames=target,
                            device="cpu", scheme=scheme)
    return jax_eng, port


def _compare(got, want, scheme):
    assert got.shape == want.shape, (got.shape, want.shape)
    if scheme == "int8":
        assert int((got != want).sum()) == 0
    else:
        assert_lsb_close(got.ravel(), want.ravel())


def _drive(eng, seed, calls=CALLS, after=AFTER):
    outs = [eng.process(_frames(n, seed + k)) for k, n in enumerate(calls)]
    outs.append(eng.flush())
    outs += [eng.process(_frames(n, seed + 10 + k))
             for k, n in enumerate(after)]
    outs.append(eng.flush())
    return outs


@pytest.fixture
def auto_resolves(monkeypatch):
    """The JAX engine resolves "auto" as on the TPU (int8 with the
    digit-escalating certificate), not as "highest" under interpret."""
    monkeypatch.setattr(jb, "AUTO_RESOLVE_UNDER_INTERPRET", True)


@pytest.mark.parametrize("cfg,scheme", [(FLAGSHIP, "highest"),
                                        (FLAGSHIP, "int8"),
                                        (UPSAMPLE, "int8"),
                                        (SLICE, "auto"),
                                        (SLICE, "highest"),
                                        (SPEECH, "auto")],
                         ids=["flagship-highest", "flagship-int8",
                              "24k-48k-q5-int8", "48k-44k1-q10-auto",
                              "48k-44k1-q10-highest", "44k1-16k-q7-auto"])
def test_engine_matches_jax_through_flush(auto_resolves, cfg, scheme):
    jax_eng, port = _engines(cfg, scheme)
    calls, after = SCHEDULES.get(cfg, (CALLS, AFTER))
    want = _drive(jax_eng, 5, calls, after)
    got = _drive(port, 5, calls, after)
    assert port._f0 == jax_eng._f0
    assert port.launches > len(calls)
    assert port.bspec.kernel == port._step.kernel == jax_eng.bspec.kernel
    resolved = port._step.scheme
    assert resolved == jax_eng._step.scheme
    if cfg in SCHEDULES:
        assert port._step.kernel == "streamed"
        assert (resolved, port._step.w[0].shape[0]) == (
            ("int8", 4) if scheme == "auto" else ("highest", 147))
        first = sum(o.shape[1] for o in got[:len(calls)])
        assert first == 2 * port.out_frames_per_launch
    for g, w in zip(got, want):
        _compare(g, w, resolved)


@pytest.mark.parametrize("scheme", ["highest", "int8"])
def test_weights_from_jax_equal_port_weights(scheme):
    i, o, q, target = FLAGSHIP
    jspec = jfd.design_filter(147, 160, q)
    jstep = jax_step(jspec, jax_geo(jspec, target, use_pallas=True),
                     use_pallas=True, pallas_interpret=True, scheme=scheme)
    tspec = tfd.design_filter(147, 160, q)
    tstep = tb.make_batched_step(tspec, tb._launch_geometry(tspec, target),
                                 device="cpu", scheme=scheme)
    jw = (np.asarray(jstep.w) if scheme == "highest"
          else tuple(np.asarray(a) for a in jstep.w))
    got = tb.weights_from_jax(jw, scheme, device="cpu")
    assert len(got) == len(tstep.w)
    for a, b in zip(got, tstep.w):
        if not isinstance(b, torch.Tensor):   # the int8 band span
            assert type(a) is type(b) and a == b
            continue
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("scheme", ["highest", "int8", "auto"])
def test_weights_from_jax_equal_port_weights_streamed(auto_resolves, scheme):
    """The streamed geometry: JAX streams [P, R, K_pad] / [P, D, R, K_pad]
    planes; weights_from_jax(kernel="streamed") gives the port's own
    [P, K_pad, R] / K-major, permuted [D, P, R, K_pad] step weights (D = 3
    for explicit int8, 4 for auto at q10) and, for int8, the same band
    widths."""
    i, o, q, target = SLICE
    jspec = jfd.design_filter(160, 147, q)
    jstep = jax_step(jspec, jax_geo(jspec, target, use_pallas=True),
                     use_pallas=True, pallas_interpret=True, scheme=scheme)
    tspec = tfd.design_filter(160, 147, q)
    tstep = tb.make_batched_step(tspec, tb._launch_geometry(tspec, target),
                                 device="cpu", scheme=scheme)
    assert jstep.scheme == tstep.scheme and tstep.kernel == "streamed"
    jw = (np.asarray(jstep.w) if tstep.scheme == "highest"
          else tuple(np.asarray(a) for a in jstep.w))
    got = tb.weights_from_jax(jw, tstep.scheme, device="cpu",
                              kernel="streamed")
    assert len(got) == len(tstep.w)
    for a, b in zip(got, tstep.w):
        if not isinstance(b, torch.Tensor):   # the int8 band widths
            assert type(a) is type(b) and a.slices == b.slices
            continue
        assert a.dtype == b.dtype and torch.equal(a, b)
    if tstep.scheme == "int8":
        assert got[0].shape[0] == (4 if scheme == "auto" else 3)


@pytest.mark.parametrize("scheme", ["highest", "int8"])
@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_checkpoint_crosses_packages(direction, scheme):
    """Checkpoint one engine mid-stream (after a flush: non-zero f0, a
    pending skip, staged frames), restore it in the other package's
    engine, continue both, and compare with the first engine continuing."""
    jax_eng, port = _engines(FLAGSHIP, scheme)
    src, dst = (jax_eng, port) if direction == "jax-to-port" \
        else (port, jax_eng)
    src.process(_frames(3000, 1))
    src.flush()
    src.process(_frames(1300, 2))
    state = src.state_dict()
    assert state["f0"] != 0 and len(state["staged"])
    dst.load_state_dict(state)
    for n, seed in ((2500, 3), (900, 4)):
        f = _frames(n, seed)
        _compare(dst.process(f), src.process(f), scheme)
    _compare(dst.flush(), src.flush(), scheme)


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_checkpoint_crosses_packages_streamed(direction):
    """The same on the streamed geometry (48k->44.1k q10, explicit int8,
    D = 3): the checkpoint is taken after a flush moved f0 and a call
    left staged frames, and restored in the other package's engine."""
    jax_eng, port = _engines(SLICE, "int8")
    src, dst = (jax_eng, port) if direction == "jax-to-port" \
        else (port, jax_eng)
    src.process(_frames(25000, 1))
    src.flush()
    src.process(_frames(9000, 2))
    state = src.state_dict()
    assert state["f0"] != 0 and len(state["staged"])
    dst.load_state_dict(state)
    assert port._step.kernel == "streamed" and port._step.w[0].shape[0] == 3
    for n, seed in ((22000, 3), (9000, 4)):
        f = _frames(n, seed)
        _compare(dst.process(f), src.process(f), "int8")
    _compare(dst.flush(), src.flush(), "int8")


def test_unported_paths_raise():
    """An unknown scheme is INVALID_ARG.  The paths that raised before
    the dense and gather geometries and the split5 scheme were ported
    serve as the JAX engine does: the same geometry and scheme, and one
    launch's outputs (fixed: bit for bit).  ``mesh=``, which raised too,
    is held by tests/test_torch_mesh.py."""
    args = (S, C, 44100, 48000, 7)
    with pytest.raises(ResamplerError) as e:
        BatchedResampler(*args, device="cpu", scheme="INT8")
    assert e.value.code == ResamplerErrorCode.INVALID_ARG
    # a fixed config on the gather geometry, explicit split5 (tiled), and
    # a 20 ms cap below one tiled unit (dense)
    for rates, kw, kernel in (((44100, 44101), dict(fixed_point=True),
                               "gather"),
                              ((44100, 48000), dict(scheme="split5"),
                               "tiled"),
                              ((44100, 48000), dict(max_latency_ms=20),
                               "dense")):
        jax_eng = JaxEngine(S, C, *rates, 7, use_pallas=True,
                            pallas_interpret=True, **kw)
        port = BatchedResampler(S, C, *rates, 7, device="cpu", **kw)
        assert dataclasses.asdict(port.bspec) == dataclasses.asdict(
            jax_eng.bspec)
        assert port.bspec.kernel == kernel
        assert port._step.scheme == jax_eng._step.scheme
        f = _frames(port.in_frames_per_launch + 100, 9)
        got, want = port.process(f), jax_eng.process(f)
        assert got.shape == want.shape and got.shape[1] > 0
        if port.fixed_point:
            assert np.array_equal(got, want)
        else:
            assert_lsb_close(got.ravel(), want.ravel())


def test_auto_resolves_int8_and_cuda_without_a_card_raises():
    eng = BatchedResampler(S, C, 44100, 48000, 7, device="cpu")
    assert eng._step.scheme == "int8" and eng._step.w[0].shape[0] == 3
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchedResampler(S, C, 44100, 48000, 7)
