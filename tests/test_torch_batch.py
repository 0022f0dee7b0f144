"""The port's BatchedResampler against the JAX package's engine.

``BatchedResampler(device="cpu")`` (the CUDA kernel's plain version on the
main path) and the JAX engine in interpret mode get identical random
streams: ragged process() calls, a flush (which moves the fractional
phase and rebuilds the step), more process() calls after it, and a final
flush.  int8 outputs must be bit-identical; highest ones within the LSB
contract (conftest.assert_lsb_close).  Also: weights carried over from a
JAX step, checkpoints crossing between the packages, and the paths the
port refuses.
"""

import numpy as np
import pytest
import torch

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


def _drive(eng, seed):
    outs = [eng.process(_frames(n, seed + k)) for k, n in enumerate(CALLS)]
    outs.append(eng.flush())
    outs += [eng.process(_frames(n, seed + 10 + k))
             for k, n in enumerate(AFTER)]
    outs.append(eng.flush())
    return outs


@pytest.mark.parametrize("cfg,scheme", [(FLAGSHIP, "highest"),
                                        (FLAGSHIP, "int8"),
                                        (UPSAMPLE, "int8")],
                         ids=["flagship-highest", "flagship-int8",
                              "24k-48k-q5-int8"])
def test_engine_matches_jax_through_flush(cfg, scheme):
    jax_eng, port = _engines(cfg, scheme)
    want, got = _drive(jax_eng, seed=5), _drive(port, seed=5)
    assert port._f0 == jax_eng._f0
    assert port.launches > len(CALLS)
    for g, w in zip(got, want):
        _compare(g, w, scheme)


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
        assert a.dtype == b.dtype and torch.equal(a, b)


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


def test_unported_paths_raise():
    args = (S, C, 44100, 48000, 7)
    with pytest.raises(NotImplementedError, match="M6"):
        BatchedResampler(*args, device="cpu", fixed_point=True)
    with pytest.raises(NotImplementedError, match="M12"):
        BatchedResampler(*args, device="cpu", mesh=object())
    with pytest.raises(NotImplementedError, match="K1c"):
        BatchedResampler(*args, device="cpu", scheme="split5")
    with pytest.raises(NotImplementedError, match="M8"):
        BatchedResampler(*args, device="cpu", max_latency_ms=20)
    with pytest.raises(ResamplerError) as e:
        BatchedResampler(*args, device="cpu", scheme="INT8")
    assert e.value.code == ResamplerErrorCode.INVALID_ARG


def test_auto_resolves_int8_and_cuda_without_a_card_raises():
    eng = BatchedResampler(S, C, 44100, 48000, 7, device="cpu")
    assert eng._step.scheme == "int8" and eng._step.w[0].shape[0] == 3
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchedResampler(S, C, 44100, 48000, 7)
