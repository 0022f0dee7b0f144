"""Zero-fill degradation of the port's engines against the JAX package's.

Faults are injected into the step of ``BatchedResampler`` and
``FleetResampler`` (``device="cpu"``) and of the JAX package's engines
(interpret mode, the same launch geometry): raised while a launch is
queued, or from the result at readback (the asynchronous surface).  The
port's engines must serve exactly the sample counts of the JAX engines,
zeros after the fault and the healthy prefix before it, and make the fault
visible: ``degraded``, ``degraded_cause``, ``degraded_launches`` and a
``RuntimeWarning``.  Degraded checkpoints load in both packages.  A kernel
build failure raises out of a CUDA engine's constructor and never
degrades.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from speex_resampler_tpu.parallel.batch import BatchedResampler as JaxEngine
from speex_resampler_tpu.runtime.fleet import FleetResampler as JaxFleet
from speex_resampler_tpu_torch import (BatchedResampler, FleetResampler,
                                       ResamplerError)
from speex_resampler_tpu_torch.ops import _build
from speex_resampler_tpu_torch.parallel import batch as tb
from speex_resampler_tpu_torch.runtime import fleet as tfleet

from conftest import assert_lsb_close

torch.set_num_threads(1)

RATES = (44100, 48000, 7)
TARGET = 2352                  # one tiled unit: 2352 frames -> 2560


def _pcm(S, n, C, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-32768, 32768, (S, n, C), dtype=np.int16)


class _FailsOnReadback:
    """A dispatched result whose readback raises, in either package."""

    def block_until_ready(self):
        raise RuntimeError("injected async device fault")

    def detach(self):
        raise RuntimeError("injected async device fault")


def _poison(eng, mode, after: int = 0):
    """From the (after+1)-th call on, the engine's step raises ("dispatch")
    or returns results whose readback raises ("readback")."""
    real = eng._step.fn
    calls = {"n": 0}

    def step(hist, x, w):
        calls["n"] += 1
        if calls["n"] <= after:
            return real(hist, x, w)
        if mode == "dispatch":
            raise RuntimeError("injected device fault")
        return _FailsOnReadback(), _FailsOnReadback()

    eng._step = dataclasses.replace(eng._step, fn=step)
    return calls


def _batched(S, C, rates=RATES, target=TARGET):
    jax_eng = JaxEngine(S, C, *rates, target_chunk_frames=target,
                        use_pallas=True, pallas_interpret=True,
                        scheme="highest")
    port = BatchedResampler(S, C, *rates, target_chunk_frames=target,
                            device="cpu", scheme="highest")
    return jax_eng, port


def _assert_visible(eng, n_zero_launches=None):
    assert eng.degraded
    assert isinstance(eng.degraded_cause, RuntimeError)
    assert "injected" in str(eng.degraded_cause)
    assert eng.degraded_launches >= 1
    if n_zero_launches is not None:
        assert eng.degraded_launches == n_zero_launches


@pytest.mark.parametrize("mode", ["dispatch", "readback"])
def test_batched_degrades_with_jax_counts(mode):
    S, C = 2, 2
    frames = _pcm(S, 9000, C, 3)
    jax_eng, port = _batched(S, C)
    a = [jax_eng.process(frames[:, :4000])]
    b = [port.process(frames[:, :4000])]
    assert_lsb_close(b[0].ravel(), a[0].ravel())
    assert not port.degraded and port.degraded_cause is None
    _poison(jax_eng, mode)
    _poison(port, mode)
    with pytest.warns(RuntimeWarning, match="degraded"):
        b.append(port.process(frames[:, 4000:]))
    a.append(jax_eng.process(frames[:, 4000:]))
    _assert_visible(port, 2)
    assert jax_eng.degraded
    for f in (frames[:, :3000], frames[:, 3000:3100]):
        a.append(jax_eng.process(f))
        b.append(port.process(f))
    a.append(jax_eng.flush())
    b.append(port.flush())
    for x, y in zip(a[1:], b[1:]):
        assert x.shape == y.shape and not y.any()
    q_out = port.out_frames_per_launch
    assert port.degraded_launches == sum(y.shape[1] // q_out
                                         for y in b[1:-1]) + 1  # + flush
    assert isinstance(port._hist, np.ndarray)


def test_batched_fault_mid_pipeline():
    """A fault on the third launch of one process() call (the depth-1
    pipeline has launch 2 in flight): the two healthy launches are read
    back intact, everything after is zero, the JAX engine's counts."""
    S, C = 1, 2
    frames = _pcm(S, 6 * 2352 + 100, C, 9)
    jax_eng, port = _batched(S, C)
    _poison(jax_eng, "dispatch", after=2)
    calls = _poison(port, "dispatch", after=2)
    with pytest.warns(RuntimeWarning):
        b = np.concatenate([port.process(frames), port.flush()], axis=1)
    a = np.concatenate([jax_eng.process(frames), jax_eng.flush()], axis=1)
    assert a.shape == b.shape
    n_good = 2 * port.out_frames_per_launch
    assert_lsb_close(b[:, :n_good].ravel(), a[:, :n_good].ravel())
    assert b[:, :n_good].any() and not b[:, n_good:].any()
    assert calls["n"] == 3          # the failed step is never called again
    _assert_visible(port, 6 - 2 + 1)


def test_batched_degraded_sticky_control_paths_and_checkpoints():
    """reset_mem, skip_zeros and checkpoints keep the degraded mode; a
    degraded checkpoint of either package loads in the other and keeps
    serving zeros with the JAX engine's counts."""
    S, C = 1, 2
    frames = _pcm(S, 6000, C, 13)
    jax_eng, port = _batched(S, C)
    for eng in (jax_eng, port):
        eng.process(frames)
        _poison(eng, "dispatch")
    with pytest.warns(RuntimeWarning):
        port.process(frames)
    jax_eng.process(frames)
    for eng in (jax_eng, port):
        eng.reset_mem()
        assert eng.degraded
        eng.skip_zeros()
    y, z = port.process(frames), jax_eng.process(frames)
    assert y.shape == z.shape and not y.any()
    for src, dst_cls in ((port, JaxEngine), (jax_eng, BatchedResampler)):
        state = src.state_dict()
        assert state["degraded"]
        kw = (dict(use_pallas=True, pallas_interpret=True)
              if dst_cls is JaxEngine else dict(device="cpu"))
        dst = dst_cls(S, C, *RATES, target_chunk_frames=TARGET,
                      scheme="highest", **kw)
        if dst_cls is BatchedResampler:
            with pytest.warns(RuntimeWarning, match="checkpoint"):
                dst.load_state_dict(state)
            assert dst.degraded_cause is None
        else:
            dst.load_state_dict(state)
        assert dst.degraded
        out = [np.concatenate([e.process(frames[:, :2500]), e.flush()],
                              axis=1) for e in (dst, src)]
        assert out[0].shape == out[1].shape and not out[0].any()


def test_batched_flush_after_dead_history_degrades():
    """A device failure surfacing only where a control path reads the
    history (flush) degrades instead of raising."""
    eng = BatchedResampler(1, 1, *RATES, target_chunk_frames=TARGET,
                           device="cpu")
    eng.process(_pcm(1, 2000, 1, 47))
    eng._hist = _FailsOnReadback()
    with pytest.warns(RuntimeWarning):
        y = eng.flush()
    assert eng.degraded and not y.any() and y.shape[1] > 0


def _fleets(S, C, monkeypatch):
    """JAX and port fleets of one geometry, both "highest"."""
    monkeypatch.setattr(tfleet, "make_batched_step", functools.partial(
        tb.make_batched_step, scheme="highest"))
    jax_f = JaxFleet(S, C, *RATES, target_chunk_frames=TARGET,
                     use_pallas=True, pallas_interpret=True)
    port = FleetResampler(S, C, *RATES, target_chunk_frames=TARGET,
                          device="cpu")
    assert jax_f._step.scheme == port._step.scheme == "highest"
    return jax_f, port


@pytest.mark.parametrize("mode", ["dispatch", "readback"])
def test_fleet_degrades_with_jax_counts(monkeypatch, mode):
    """Kill the step mid-serving on a ragged fleet: poll() and flush()
    drain the JAX fleet's exact per-stream counts (zeros after the fault),
    and a degraded snapshot taken mid-serving loads in either package and
    keeps serving."""
    S, C = 3, 2
    frames = _pcm(S, 5000, C, 21)
    jax_f, port = _fleets(S, C, monkeypatch)
    for f in (jax_f, port):
        for s in range(S):
            f.push(s, frames[s, :3000])
    n_good = port.poll()
    jax_f.poll()
    _poison(jax_f, mode)
    _poison(port, mode)
    for f in (jax_f, port):
        for s in range(S):
            f.push(s, frames[s, 3000:])
    with pytest.warns(RuntimeWarning, match="degraded"):
        port.poll()
    jax_f.poll()
    _assert_visible(port)
    mid = {"port": port.state_dict(), "jax": jax_f.state_dict()}
    assert mid["port"]["degraded"] and not mid["port"]["flushed"]
    for f in (jax_f, port):
        f.flush()
    n_out = n_good * port.bspec.out_per_launch
    for s in range(S):
        got, want = port.pull(s), jax_f.pull(s)
        assert got.shape == want.shape
        assert_lsb_close(got[:n_out].ravel(), want[:n_out].ravel())
        assert not got[n_out:].any()
    assert port.stats.launches == port.degraded_launches + n_good
    for src, make in (("port", lambda: JaxFleet(
            S, C, *RATES, target_chunk_frames=TARGET, use_pallas=True,
            pallas_interpret=True)), ("jax", lambda: FleetResampler(
            S, C, *RATES, target_chunk_frames=TARGET, device="cpu"))):
        dst = make()
        if src == "jax":
            with pytest.warns(RuntimeWarning, match="checkpoint"):
                dst.load_state_dict(mid[src])
        else:
            dst.load_state_dict(mid[src])
        assert dst.degraded
        for s in range(S):
            dst.push(s, frames[s, :2000])
        dst.poll()
        dst.flush()
        for s in range(S):
            assert not dst.pull(s)[n_out:].any()
    final = port.state_dict()
    dst = FleetResampler(S, C, *RATES, target_chunk_frames=TARGET,
                         device="cpu")
    with pytest.warns(RuntimeWarning, match="checkpoint"):
        dst.load_state_dict(final)
    with pytest.raises(ResamplerError):
        dst.push(0, frames[0])       # flush is terminal, survives restore


def test_fleet_healthy_checkpoint_into_degraded_fleet(monkeypatch):
    """A pre-fault checkpoint loaded into a degraded fleet keeps it
    degraded (sticky) with a host history the slot operations work on."""
    S, C = 2, 1
    frames = _pcm(S, 3000, C, 44)
    jax_f, port = _fleets(S, C, monkeypatch)
    for f in (jax_f, port):
        for s in range(S):
            f.push(s, frames[s])
        f.poll()
    healthy = port.state_dict()
    _poison(port, "dispatch")
    for s in range(S):
        port.push(s, frames[s])
    with pytest.warns(RuntimeWarning):
        port.poll()
    port.load_state_dict(healthy)
    assert port.degraded and isinstance(port._hist, np.ndarray)
    port.clear_slot(0)
    port.seed_lane_history(0, np.zeros((port.spec.filt_len - 1, C),
                                       np.int16))
    assert not port.lane_history(0).any()
    for s in range(S):
        port.push(s, frames[s])
    port.poll()
    port.flush()
    assert not port.pull(0).any()


@pytest.mark.parametrize("engine", ["batched", "fleet"])
def test_kernel_build_failure_raises_from_the_constructor(monkeypatch,
                                                          engine):
    """The CUDA engines build the kernel library before any launch, so a
    build failure raises out of the constructor (never a degraded
    engine)."""
    def failed_build():
        raise RuntimeError("nvcc failed: injected build error")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(_build, "load", failed_build)
    cls = BatchedResampler if engine == "batched" else FleetResampler
    with pytest.raises(RuntimeError, match="nvcc failed"):
        cls(2, 2, *RATES, target_chunk_frames=TARGET, device="cuda")
