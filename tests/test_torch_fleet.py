"""The port's FleetResampler against the JAX package's.

``FleetResampler(device="cpu")`` (the kernels' plain versions behind the
native stager and the lane-major step) and the JAX package's
``FleetResampler(use_pallas=True, pallas_interpret=True)`` get the same
ragged per-stream pushes (frames, and bytes cut at odd offsets so the
alignment carry is used), bounded and unbounded polls, and a terminal
flush that drains more than one quantum of one stream.  Tolerance: the
flagship's int8 and fixed outputs bit-identical; "highest" within the LSB
contract (conftest.assert_lsb_close).  Also: pipeline depths 1-3 (one
output), watermarks, slot operations, a device consumer, checkpoints
crossing between the packages, and the per-phase stats.
"""

import functools

import numpy as np
import pytest
import torch

from speex_resampler_tpu.parallel import batch as jb
from speex_resampler_tpu.runtime.fleet import FleetResampler as JaxFleet
from speex_resampler_tpu.utils.errors import ResamplerError as JaxError
from speex_resampler_tpu_torch import (FleetResampler, ResamplerError,
                                       ResamplerErrorCode)
from speex_resampler_tpu_torch.parallel import batch as tb
from speex_resampler_tpu_torch.runtime import fleet as tfleet
from speex_resampler_tpu_torch.utils.host import to_host_into
from speex_resampler_tpu_torch.utils.profiling import trace

from conftest import assert_lsb_close

torch.set_num_threads(1)

S, C = 3, 2
RATES = (44100, 48000, 7)
TARGET = 2352                 # one tiled unit: 2352 frames -> 2560
ERRORS = (ResamplerError, JaxError)


def _scheme_patch(mp, scheme):
    """int8: the JAX engine resolves "auto" as on the TPU (not as
    "highest" under interpret); highest: the port's fleet is built with
    scheme="highest" (the fleet has no scheme argument in either
    package)."""
    if scheme == "int8":
        mp.setattr(jb, "AUTO_RESOLVE_UNDER_INTERPRET", True)
    elif scheme == "highest":
        mp.setattr(tfleet, "make_batched_step", functools.partial(
            tb.make_batched_step, scheme="highest"))


def _fleets(scheme, depth=2, **kw):
    fixed = scheme == "fixed"
    jax_f = JaxFleet(S, C, *RATES, target_chunk_frames=TARGET,
                     use_pallas=True, pallas_interpret=True,
                     fixed_point=fixed, pipeline_depth=depth, **kw)
    port = FleetResampler(S, C, *RATES, target_chunk_frames=TARGET,
                          device="cpu", fixed_point=fixed,
                          pipeline_depth=depth, **kw)
    assert jax_f._step.scheme == port._step.scheme == scheme
    assert port.stager_kind == "native"
    return jax_f, port


def _compare(got, want, scheme):
    assert got.shape == want.shape, (got.shape, want.shape)
    if scheme == "highest":
        assert_lsb_close(got.ravel(), want.ravel())
    else:
        assert np.array_equal(got, want)


def _pcm(n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-32768, 32768, (S, n, C), dtype=np.int16)


def _push_ragged(fleet, frames, seed):
    """Each stream in ragged pieces; odd streams as bytes cut at odd
    offsets (the alignment carry holds a partial frame between pushes)."""
    rng = np.random.default_rng(seed)
    for s in range(S):
        f = frames[s]
        cuts = sorted(rng.integers(1, f.shape[0], 3).tolist())
        for a, b in zip([0] + cuts, cuts + [f.shape[0]]):
            if s % 2:
                raw = f[a:b].astype("<i2").tobytes()
                k = len(raw) // 2 | 1
                fleet.push_bytes(s, raw[:k])
                fleet.push_bytes(s, raw[k:])
            else:
                fleet.push(s, f[a:b])


def _serve(fleet):
    """Stream s gets (s + 1) quanta + a remainder; poll one launch, then
    the rest (none: stream 0 is empty); a second round; the terminal flush
    drains stream 2's 2 quanta + 213 frames in three launches.  Returns (poll counts, staged, outputs)."""
    q = fleet.bspec.in_per_launch
    counts = []
    first = _pcm(3 * q + 300, 1)
    _push_ragged(fleet, [first[s][:(s + 1) * q + 57 * s] for s in range(S)],
                 2)
    counts.append(fleet.poll(max_launches=1))
    counts.append(fleet.poll())
    _push_ragged(fleet, _pcm(q + 99, 3), 4)
    counts.append(fleet.poll())
    staged = fleet.staged().copy()
    fleet.flush()
    with pytest.raises(ERRORS):
        fleet.push(0, np.zeros((4, C), np.int16))
    assert not fleet.writable(0)
    return counts, staged, [fleet.pull(s) for s in range(S)]


@pytest.fixture(scope="module")
def jax_served():
    """The JAX fleet's run of _serve, once per scheme."""
    runs = {}

    def get(scheme):
        if scheme not in runs:
            with pytest.MonkeyPatch.context() as mp:
                _scheme_patch(mp, scheme)
                runs[scheme] = _serve(_fleets(scheme)[0])
        return runs[scheme]
    return get


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("scheme", ["int8", "fixed", "highest"])
def test_fleet_matches_jax(monkeypatch, jax_served, scheme, depth):
    _scheme_patch(monkeypatch, scheme)
    want = jax_served(scheme)
    port = _fleets(scheme, depth)[1]
    got = _serve(port)
    assert got[0] == want[0] == [1, 0, 1]
    assert np.array_equal(got[1], want[1])
    assert got[1].max() > 2 * port.bspec.in_per_launch  # flush: 3 quanta
    for g, w in zip(got[2], want[2]):
        _compare(g, w, scheme)
    assert port.stats.launches == 2 + 3 and not port.degraded


def test_watermarks_and_writable(monkeypatch):
    """Staging and banked watermarks: the same refusals, pauses and
    outputs in both packages."""
    _scheme_patch(monkeypatch, "int8")
    q = 2352
    fleets = _fleets("int8", max_staged_frames=2 * q,
                     max_banked_frames=2560)
    frames = _pcm(3 * q, 7)
    trace = []
    for f in fleets:
        t = []
        t.append([f.writable(s, 2 * q) for s in range(S)])
        f.push(0, frames[0][:q + 10])
        t.append((f.writable(0, q - 10), f.writable(0, q - 9)))
        with pytest.raises(ERRORS) as e:
            f.push(0, frames[0][:q])
        assert int(e.value.code) == int(ResamplerErrorCode.ALLOC_FAILED)
        with pytest.raises(ERRORS):
            f.push_bytes(0, frames[0][:q].tobytes())
        for s in (1, 2):
            f.push(s, frames[s][:2 * q])
        t.append(f.poll())           # one launch, then banked >= 2560
        f.push(0, frames[0][q + 10:2 * q + 20])
        t.append(f.poll())           # paused: nothing pulled
        t.append([f.pending(s) for s in range(S)])
        pulled = [f.pull(s) for s in range(S)]
        t.append(f.poll())           # resumes
        pulled += [f.pull(s) for s in range(S)]
        t.append(f.staged().tolist())
        trace.append((t, pulled))
    (tj, pj), (tp, pp) = trace
    assert tj == tp and tp[2:4] == [1, 0] and tp[5] == 1
    for a, b in zip(pj, pp):
        _compare(b, a, "int8")
    with pytest.raises(ResamplerError):
        FleetResampler(S, C, *RATES, target_chunk_frames=TARGET,
                       device="cpu", max_staged_frames=q - 1)


def test_slot_operations(monkeypatch):
    """Deactivate a slot (its staging goes), clear it, seed its history
    from another lane, reactivate: the same lanes, histories, peeks,
    carries and outputs in both packages."""
    _scheme_patch(monkeypatch, "int8")
    fleets = _fleets("int8")
    q = fleets[1].bspec.in_per_launch
    frames = _pcm(4 * q, 9)
    results = []
    for f in fleets:
        r = []
        for s in range(S):
            f.push(s, frames[s][:q + 5])
        f.push_bytes(1, frames[1][q + 5:q + 8].tobytes()[:5])
        r += [f.peek_staged(1), f.lane_carry(1)]
        f.poll()
        seed = f.lane_history(0)
        f.set_slot_active(1, False)
        r += [f.peek_staged(1), f.lane_carry(1), f.staged()]
        for s in (0, 2):
            f.push(s, frames[s][q + 5:2 * q + 5])
        r.append(f.poll())
        f.clear_slot(1)
        r.append(f.lane_history(1))
        f.seed_lane_history(1, seed)
        r.append(f.lane_history(1))
        f.set_slot_active(1, True)
        for s in range(S):
            f.push(s, frames[s][2 * q + 5:3 * q + 5])
        r.append(f.poll())
        r += [f.pull(s) for s in range(S)]
        results.append(r)
    for a, b in zip(*results):
        if isinstance(a, (bytes, int)):
            assert a == b
        else:
            _compare(np.asarray(b), np.asarray(a), "int8")
    with pytest.raises(ResamplerError):
        fleets[1].seed_lane_history(0, np.zeros((3, C), np.int16))


def test_device_consumer_checksum():
    """A consumer on the device output: its per-launch result (a checksum)
    equals the checksum of the banked output of a fleet without one;
    pull() yields nothing and flush() is consumed too."""
    fl = FleetResampler(S, C, *RATES, target_chunk_frames=TARGET,
                        device="cpu",
                        device_consumer=lambda y: y.to(torch.int64).sum())
    ref = FleetResampler(S, C, *RATES, target_chunk_frames=TARGET,
                         device="cpu")
    q = fl.bspec.in_per_launch
    frames = _pcm(q + q // 2, 5)
    for f in (fl, ref):
        for s in range(S):
            f.push(s, frames[s][:q])
    assert fl.poll() == 1 and ref.poll() == 1
    want = sum(int(ref.pull(s).astype(np.int64).sum()) for s in range(S))
    assert int(fl.consumed[0]) == want
    assert fl.pull(0).shape == (0, C) and fl.pending(0) == 0
    for s in range(S):
        fl.push(s, frames[s][q:])
    fl.flush()
    assert len(fl.consumed) == 2 and fl.pull(1).shape == (0, C)


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_checkpoint_crosses_packages(monkeypatch, direction):
    """Snapshot one package's fleet mid-stream (staged frames, a byte
    carry, banked output, an inactive slot), restore it in the other's,
    continue both and compare with the first continuing."""
    _scheme_patch(monkeypatch, "int8")
    jax_f, port = _fleets("int8")
    src, dst = (jax_f, port) if direction == "jax-to-port" \
        else (port, jax_f)
    q = port.bspec.in_per_launch
    frames = _pcm(3 * q, 13)
    for s in range(S):
        src.push(s, frames[s][:q + 100 * s])
    src.push_bytes(2, frames[2][q:q + 2].tobytes()[:3])
    src.poll()
    src.set_slot_active(0, False)
    state = src.state_dict()
    assert not state["degraded"] and state["carry"][2]
    assert state["banked"][1] and len(state["staged"][2])
    dst.load_state_dict(state)
    for f in (src, dst):
        for s in (1, 2):
            f.push(s, frames[s][2 * q:3 * q])
        f.poll()
        f.flush()
    for s in range(S):
        _compare(dst.pull(s), src.pull(s), "int8")


def test_phase_stats_attribution():
    """Every poll attributes host wall-clock to the four serving phases,
    and the per-launch view divides by the launch count."""
    fleet = FleetResampler(S, C, *RATES, target_chunk_frames=TARGET,
                           device="cpu")
    q = fleet.bspec.in_per_launch
    frames = _pcm(2 * q, 21)
    for s in range(S):
        fleet.push(s, frames[s])
    assert fleet.poll() == 2
    st = fleet.stats
    for phase in ("gather", "dispatch", "readback", "unpack"):
        assert st.phase_seconds.get(phase, 0.0) > 0.0
        assert st.phase_ms_per_launch()[phase] == pytest.approx(
            st.phase_seconds[phase] * 1e3 / st.launches, abs=5e-5)
        assert st.phase_ms_min()[phase] <= st.phase_ms_per_launch()[phase]
    d = st.as_dict()
    assert d["launches"] == 2
    assert d["out_samples"] == 2 * fleet.bspec.out_per_launch * S * C
    assert d["in_samples"] == 2 * q * S * C and d["out_samples_per_sec"] > 0


def test_trace_writes_a_chrome_trace(tmp_path):
    """utils/profiling.trace: a torch.profiler scope that exports a Chrome
    trace of what ran inside it (here a CPU fleet's launch)."""
    fleet = FleetResampler(S, C, *RATES, target_chunk_frames=TARGET,
                           device="cpu")
    for s in range(S):
        fleet.push(s, _pcm(fleet.bspec.in_per_launch, 23)[s])
    with trace(str(tmp_path / "prof")):
        assert fleet.poll() == 1
    text = (tmp_path / "prof" / "trace.json").read_text()
    assert '"traceEvents"' in text


def test_readback_buffer_must_match():
    """to_host_into refuses a buffer of another shape or dtype before any
    copy is queued."""
    y = torch.zeros((4, 8), dtype=torch.int16)
    for buf in (torch.zeros((4, 7), dtype=torch.int16),
                torch.zeros((4, 8), dtype=torch.int32)):
        with pytest.raises(ValueError, match="readback buffer"):
            to_host_into(y, buf, None)


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        FleetResampler(S, C, *RATES)
