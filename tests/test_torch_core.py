"""The port's ResamplerCore against the JAX package's.

Both cores get the same seeded inputs through the same sequence of calls
(capacity-bound and unbound, mid-stream ``set_rate`` / ``set_quality``,
magic-sample migration, the float-sample API, strides, the native-layer
entry).  Tolerance: the host route and the fixed universe bit-identical
(outputs, ``last_accounting`` and the whole ``state_dict``); the device
route (``device="cpu"``: one f32 matmul a call) and the gather route
within the LSB contract (conftest.assert_lsb_close), with equal counts and
accounting.  Also: routing, checkpoints crossing between the packages,
zero-output degradation, the TF32 guard, and construction without a card.
"""

import dataclasses
import logging

import numpy as np
import pytest
import torch

from speex_resampler_tpu.core.resampler import ResamplerCore as JaxCore
from speex_resampler_tpu.utils.errors import ResamplerError as JaxError
from speex_resampler_tpu_torch import (ResamplerCore, ResamplerError,
                                       ResamplerErrorCode)
from speex_resampler_tpu_torch.core import resampler as tcore
from speex_resampler_tpu_torch.ops import fir_matmul as fm

from conftest import assert_lsb_close

torch.set_num_threads(1)

BIG = 10 ** 9
ERRORS = (ResamplerError, JaxError)


def _pcm(n, c, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-32768, 32768, (n, c), dtype=np.int16)


def _pair(c, in_rate, out_rate, q, **kw):
    """(JAX core, port core) of one config; the port's device route runs
    on the CPU."""
    return (JaxCore(c, in_rate, out_rate, in_rate, out_rate, q, **kw),
            ResamplerCore(c, in_rate, out_rate, in_rate, out_rate, q,
                          device="cpu", **kw))


def _state_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        if k in ("history", "pending"):
            assert len(a[k]) == len(b[k])
            for x, y in zip(a[k], b[k]):
                assert x.dtype == y.dtype and np.array_equal(x, y), k
        elif isinstance(a[k], np.ndarray):
            assert np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def _acct(core):
    a = core.last_accounting
    return None if a is None else dataclasses.astuple(a)


def _same(got, want, exact):
    assert got.shape == want.shape and got.dtype == want.dtype
    if exact:
        assert np.array_equal(got, want)
    elif got.dtype == np.int16:
        assert_lsb_close(got.ravel(), want.ravel())
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-2)


def _script(jc, pc, ops, exact):
    """Run ``ops`` (name, args) on both cores; compare every output, the
    accounting and the state after each call."""
    for name, args in ops:
        got = getattr(pc, name)(*args)
        want = getattr(jc, name)(*args)
        if want is not None:
            _same(got, want, exact)
        assert _acct(pc) == _acct(jc), name
        # the state is integer bookkeeping plus input history: equal on
        # every route, whatever the outputs' ties
        _state_equal(pc.state_dict(), jc.state_dict())


# the reference integration matrix's configs (conftest.AUDIO_TESTS)
CONFIGS = [(1, 24000, 48000, 5), (2, 24000, 24000, 5), (2, 24000, 48000, 10),
           (2, 44100, 48000, 7), (2, 44100, 48000, 10), (2, 44100, 48000, 1),
           (2, 44100, 24000, 5)]


def _chunked_ops(c, seed, method="process_interleaved"):
    """Ragged calls: unbound, capacity-bound (a bite is dropped), empty,
    capacity 0."""
    x = _pcm(9000, c, seed)
    ops = [(method, (x[:1000], BIG)), (method, (x[1000:1003], BIG)),
           (method, (x[1003:4000], 500)), (method, (x[4000:4000], BIG)),
           (method, (x[4000:4100], 0)), (method, (x[4100:9000], BIG))]
    if method.endswith("float"):
        ops = [(m, (a.astype(np.float32) * np.float32(0.73), cap))
               for m, (a, cap) in ops]
    return ops


@pytest.mark.parametrize("cfg", CONFIGS)
@pytest.mark.parametrize("fixed", [False, True])
def test_host_route_and_fixed_bit_exact(cfg, fixed):
    """engine "auto" at <= 8 channels: the native host loops (float) or
    the Q15 loops (fixed), bit-identical to the JAX package, state and
    accounting included."""
    jc, pc = _pair(*cfg, fixed_point=fixed)
    assert pc._host_route == jc._host_route == (not fixed)
    _script(jc, pc, _chunked_ops(cfg[0], sum(cfg)), exact=True)


@pytest.mark.parametrize("fixed", [False, True])
def test_float_sample_api_bit_exact(fixed):
    """process_interleaved_float (raw f32 sums in the float universe; the
    fixed WORD2INT on entry in the fixed one) and exact=True."""
    kw = {"fixed_point": True} if fixed else {"exact": True}
    jc, pc = _pair(2, 44100, 48000, 7, **kw)
    _script(jc, pc, _chunked_ops(2, 5, "process_interleaved_float"),
            exact=True)


@pytest.mark.parametrize("cfg", [(16, 44100, 48000, 7), (9, 48000, 44100, 10),
                                 (12, 8000, 48000, 3)])
def test_device_route_within_lsb(cfg):
    """engine "auto" above 8 channels: the device route (one f32 matmul a
    call, here on the CPU) within 1 LSB under the tie bound, counts and
    accounting equal; the raw float path within float tolerance."""
    jc, pc = _pair(*cfg)
    assert not pc._host_route and not jc._host_route
    assert pc.device.type == "cpu"
    _script(jc, pc, _chunked_ops(cfg[0], 3), exact=False)
    jc, pc = _pair(*cfg)
    _script(jc, pc, _chunked_ops(cfg[0], 4, "process_interleaved_float"),
            exact=False)


def test_gather_route_within_lsb():
    """44.1k -> 44.101k: the padded weights exceed
    MAX_PADDED_WEIGHT_BYTES, so the device route gathers tap rows."""
    jc, pc = _pair(2, 44100, 44101, 7, engine="device")
    L = pc.filt_len + fm.choose_group(44100, 44101, pc.filt_len) * 44100
    assert L * 44101 * 4 > fm.MAX_PADDED_WEIGHT_BYTES
    calls = []
    real = fm.resample_gather

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    fm.resample_gather = spy
    try:
        _script(jc, pc, _chunked_ops(2, 8), exact=False)
    finally:
        fm.resample_gather = real
    assert calls


@pytest.mark.parametrize("kw", [{"engine": "host"}, {"engine": "device"},
                                {"fixed_point": True}])
def test_midstream_rate_and_quality_migration(kw):
    """set_quality up (filter grows: magic unpacked), down (magic stashed
    and drained over capacity-bound calls), set_rate (samp_frac_num
    rescaled), set_rate_frac, skip_zeros and reset_mem mid-stream."""
    jc, pc = _pair(2, 24000, 48000, 3, **kw)
    x = _pcm(6000, 2, 11)
    p = "process_interleaved"
    ops = [(p, (x[:777], BIG)), ("set_quality", (8,)), (p, (x[777:1500], 60)),
           (p, (x[1500:2000], BIG)), ("set_quality", (2,)),
           (p, (x[2000:2005], 3)), (p, (x[2005:2300], 40)),
           (p, (x[2300:3000], BIG)), ("set_rate", (24000, 44100)),
           (p, (x[3000:3700], BIG)), ("set_rate_frac", (3, 7, 21000, 49000)),
           (p, (x[3700:4500], 300)), ("skip_zeros", ()),
           (p, (x[4500:5000], BIG)), ("reset_mem", ()),
           (p, (x[5000:6000], BIG))]
    _script(jc, pc, ops, exact=kw.get("engine") != "device")
    assert (pc.input_latency(), pc.output_latency(), pc.get_ratio(),
            pc.get_rate(), pc.filt_len) == (
        jc.input_latency(), jc.output_latency(), jc.get_ratio(),
        jc.get_rate(), jc.filt_len)


@pytest.mark.parametrize("fixed", [False, True])
def test_strides_and_channels(fixed):
    """process_channel[_float] with input and output strides, and channels
    out of lockstep afterwards (process_interleaved then walks them one by
    one)."""
    jc, pc = _pair(2, 44100, 48000, 5, fixed_point=fixed)
    for core in (jc, pc):
        core.set_input_stride(2)
        core.set_output_stride(3)
        assert (core.get_input_stride(), core.get_output_stride()) == (2, 3)
    x = _pcm(3000, 1, 2)[:, 0]
    ops = [("process_channel", (0, x[:1201], BIG)),
           ("process_channel_float", (1, x[:900].astype(np.float32), 300)),
           ("process_channel", (1, x[1201:2000], BIG)),
           ("process_interleaved", (_pcm(500, 2, 3), BIG))]
    _script(jc, pc, ops, exact=True)
    with pytest.raises(ERRORS):
        pc.set_input_stride(0)


@pytest.mark.parametrize("fixed", [False, True])
def test_process_native_interleaved(fixed):
    """The native-layer entry (one magic drain + one native call) that
    MultiFleet's transitions use: across a shrinking switch with magic
    samples stashed, with and without fresh input."""
    jc, pc = _pair(2, 24000, 48000, 8, fixed_point=fixed)
    x = _pcm(3000, 2, 6)
    n = "process_native_interleaved"
    ops = [("process_interleaved", (x[:1000], BIG)), ("set_quality", (2,)),
           (n, (x[1000:1000], 7)), (n, (x[1000:1500], 50)),
           (n, (x[1500:3000], BIG))]
    _script(jc, pc, ops, exact=True)
    with pytest.raises(ERRORS):
        pc.process_native_interleaved(x[:, :1], BIG)


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
@pytest.mark.parametrize("kw", [{}, {"fixed_point": True},
                                {"engine": "device"}])
def test_checkpoint_crosses_packages(direction, kw):
    """A checkpoint taken mid-stream (magic stashed after a shrink, a
    capacity-bound call behind it) by one package's core restores into the
    other's, which continues as the donor does."""
    x = _pcm(5000, 2, 21)
    jc, pc = _pair(2, 24000, 48000, 8, **kw)
    for core in (jc, pc):
        core.process_interleaved(x[:1000], BIG)
        core.set_quality(3)
        core.process_interleaved(x[1000:1003], 2)
    donor, taker = (jc, pc) if direction == "jax-to-port" else (pc, jc)
    fresh = (ResamplerCore(2, 1, 1, 1, 1, 4, device="cpu", **kw)
             if direction == "jax-to-port"
             else JaxCore(2, 1, 1, 1, 1, 4, **kw))
    fresh.load_state_dict(donor.state_dict())
    _state_equal(fresh.state_dict(), donor.state_dict())
    got = fresh.process_interleaved(x[1003:5000], BIG)
    want = donor.process_interleaved(x[1003:5000], BIG)
    _same(got, want, exact=kw.get("engine") != "device")
    assert _acct(fresh) == _acct(donor)
    with pytest.raises(ERRORS):
        fresh.load_state_dict({**donor.state_dict(), "nb_channels": 3})


def test_routing_matches_jax():
    for c in (1, tcore.HOST_AUTO_MAX_CHANNELS, tcore.HOST_AUTO_MAX_CHANNELS
              + 1, 64):
        for engine in ("auto", "host", "device"):
            jc, pc = _pair(c, 44100, 48000, 5, engine=engine)
            assert pc._host_route == jc._host_route, (c, engine)
    with pytest.raises(ResamplerError):
        ResamplerCore(1, 1, 1, 44100, 48000, 5, exact=True, engine="device",
                      device="cpu")
    with pytest.raises(ResamplerError):
        ResamplerCore(1, 1, 1, 44100, 48000, 5, engine="mxu", device="cpu")
    with pytest.raises(ResamplerError) as e:
        ResamplerCore(1, 1, 1, 44100, 48000, 11, device="cpu")
    assert e.value.code == ResamplerErrorCode.INVALID_ARG


def test_cuda_device_route_without_a_card_raises(monkeypatch):
    """device="cuda" (the default) is checked where the device route runs:
    a device-route core raises at construction without a CUDA device; the
    host route and the fixed universe run on the host and do not need
    one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ResamplerCore(16, 44100, 48000, 44100, 48000, 7)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ResamplerCore(2, 44100, 48000, 44100, 48000, 7, engine="device")
    ResamplerCore(2, 44100, 48000, 44100, 48000, 7)
    ResamplerCore(16, 44100, 48000, 44100, 48000, 7, fixed_point=True)
    ResamplerCore(16, 44100, 48000, 44100, 48000, 7, engine="host")


def test_degradation_is_logged_and_keeps_accounting(monkeypatch, caplog):
    """A launch fault (RuntimeError, as CUDA raises) swaps in zero output
    with the exact sample accounting (resample.c:561-591), stores the
    cause and logs a warning; later calls stay zeros."""
    x = _pcm(4000, 16, 1)
    jc, pc = _pair(16, 44100, 48000, 7)
    _same(pc.process_interleaved(x[:1000], BIG),
          jc.process_interleaved(x[:1000], BIG), exact=False)

    def fault(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(fm, "resample_conv", fault)
    with caplog.at_level(logging.WARNING):
        got = pc.process_interleaved(x[1000:2500], BIG)
    want = jc.process_interleaved(x[1000:2500], BIG)
    assert pc.degraded and "illegal memory" in str(pc.degraded_cause)
    assert "degraded" in caplog.text
    assert got.shape == want.shape and not got.any()
    monkeypatch.undo()
    got = pc.process_interleaved(x[2500:], BIG)
    assert got.shape == jc.process_interleaved(x[2500:], BIG).shape
    assert not got.any()
    _state_equal(pc.state_dict(), jc.state_dict())


def test_resample_conv_runs_full_fp32(monkeypatch):
    """The device route's matmul runs with TF32 off whatever the caller
    set (the JAX package's Precision.HIGHEST), and the caller's setting is
    restored after it."""
    seen = []
    real = torch.matmul

    def spy(*a, **k):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return real(*a, **k)

    monkeypatch.setattr(torch, "matmul", spy)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        x = torch.from_numpy(_pcm(6 * 147, 3, 2).T.astype(np.float32))
        w = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (294, 160)).astype(np.float32))
        y = fm.resample_conv(x, w, stride=147)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert seen == [False] and y.dtype == torch.int16
    assert y.shape == (3, 4 * 160)


@pytest.mark.parametrize("kw", [{}, {"fixed_point": True}])
def test_import_history_and_destroy(kw):
    """import_history (a fleet lane's filter memory handed to a core, as
    MultiFleet's tails do) then processing; a wrong shape is refused;
    destroy releases the state."""
    jc, pc = _pair(2, 44100, 48000, 7, **kw)
    hist = _pcm(pc.filt_len - 1, 2, 12)
    x = _pcm(3000, 2, 13)
    _script(jc, pc, [("import_history", (hist,)),
                     ("process_interleaved", (x, BIG))], exact=True)
    with pytest.raises(ERRORS):
        pc.import_history(hist[1:])
    pc.destroy()
    assert pc._history is None and not pc.initialised
