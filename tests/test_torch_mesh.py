"""``mesh=``: the port's lanes split over several devices.

The counterpart of the JAX package's mesh tests (tests/test_batch.py
``test_batched_mesh_sharded_*``, tests/test_fixed.py
``test_fixed_*mesh*``), which shard the lane axis over 8 virtual CPU
devices.  Here a mesh is a list of devices and one may repeat, so
``["cpu"] * 8`` is a real 8-way split: 8 histories, 8 slab pairs and 8
launches a launch, each on its own shard of the lanes.

Tolerance: a meshed engine against the unmeshed port engine through
process / flush / process, bit-identical on every geometry and universe
(tiled int8, streamed int8, fixed, dense), as the kernels' plain versions
reduce each lane on its own; the float gather within the LSB bound
(conftest.assert_lsb_close), as the JAX test holds it (its float64 dots
may group differently at another batch width).  Also: meshed checkpoints
loading into the JAX engine and an unmeshed port engine, the argument
errors, and zero-fill degradation of a meshed engine.
"""

import dataclasses

import numpy as np
import pytest
import torch

from speex_resampler_tpu.parallel.batch import BatchedResampler as JaxEngine
from speex_resampler_tpu_torch import (BatchedResampler, ResamplerError,
                                       ResamplerErrorCode)
from speex_resampler_tpu_torch.functional import make_stream_fn
from speex_resampler_tpu_torch.ops import filter_design as tfd
from speex_resampler_tpu_torch.parallel import batch as tb
from speex_resampler_tpu_torch.parallel.mesh import (join_lanes,
                                                     shard_columns,
                                                     split_lanes)

from conftest import assert_lsb_close

torch.set_num_threads(1)

MESH = ["cpu"] * 8

# (name, rates and quality, engine keywords, S, C, schedule: process()
# calls before the flush and after it, geometry)
CASES = {
    "tiled-int8": ((44100, 48000, 7), dict(target_chunk_frames=2352,
                                           scheme="int8"),
                   8, 2, ((3000, 1100, 2500), (2600,)), "tiled"),
    # the streamed geometry at P = 20 (48k -> 44.1k's P = 147 is the same
    # kernel at ~7x the weights); the flush moves f0, the last one back
    "streamed-int8": ((44100, 16000, 7), dict(target_chunk_frames=7056),
                      8, 1, ((9000, 3000, 4000), (7813,)), "streamed"),
    "tiled-fixed": ((44100, 48000, 7), dict(target_chunk_frames=2352,
                                            fixed_point=True),
                    8, 2, ((3000, 1100, 2500), (2600,)), "tiled"),
    "dense-float": ((44100, 48000, 3), dict(max_latency_ms=20), 8, 2,
                    ((2000, 1500, 700), (1764,)), "dense"),
    "dense-fixed": ((44100, 48000, 3), dict(max_latency_ms=20,
                                            fixed_point=True), 8, 2,
                    ((2000, 1500, 700), (1764,)), "dense"),
    "gather-float": ((44100, 44101, 1), dict(target_chunk_frames=44100),
                     8, 1, ((46000,), (1000,)), "gather"),
    "gather-fixed": ((44100, 44101, 1), dict(target_chunk_frames=44100,
                                             fixed_point=True),
                     8, 1, ((46000,), (1000,)), "gather"),
}


def _frames(S, n, C, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-32768, 32768, (S, n, C), dtype=np.int16)


def _drive(eng, S, C, schedule, seed):
    before, after = schedule
    outs = [eng.process(_frames(S, n, C, seed + k))
            for k, n in enumerate(before)]
    outs.append(eng.flush())
    outs += [eng.process(_frames(S, n, C, seed + 10 + k))
             for k, n in enumerate(after)]
    outs.append(eng.flush())
    return outs


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_matches_unmeshed(case):
    """8 shards on the CPU against the unmeshed port engine, through
    process / flush / process / flush, each call's output compared;
    ``launches`` grows by 8 a launch."""
    rates, kw, S, C, schedule, kernel = CASES[case]
    plain = BatchedResampler(S, C, *rates, device="cpu", **kw)
    meshed = BatchedResampler(S, C, *rates, mesh=MESH, **kw)
    assert plain.bspec.kernel == meshed.bspec.kernel == kernel
    scheme = case.split("-")[1].replace("float", "highest")
    assert plain._step.scheme == meshed._step.scheme == scheme
    assert meshed._step.mesh == tuple(torch.device(d) for d in MESH)
    assert meshed.device is None and len(meshed.mesh) == 8
    a = _drive(plain, S, C, schedule, seed=7)
    b = _drive(meshed, S, C, schedule, seed=7)
    assert [x.shape for x in a] == [x.shape for x in b]
    for x, y in zip(a, b):
        if case == "gather-float":
            assert_lsb_close(y.ravel(), x.ravel(), max_mismatch_rate=1e-3)
        else:
            np.testing.assert_array_equal(y, x)
    assert plain.launches > 0 and meshed.launches == 8 * plain.launches
    hist = meshed.state_dict()["hist"]
    assert hist.shape == (meshed._step.hist_rows, S * C)


def test_mesh_step_matches_unmeshed_step():
    """``make_batched_step(mesh=...)``: the shards' lists in and out, one
    weight upload a distinct device (shards on one device share it), the
    lane-major layout split on its lane axis; equal to the unmeshed
    step."""
    spec = tfd.design_filter(147, 160, 7)
    bspec = tb._launch_geometry(spec, 2352)
    B = 16
    rng = np.random.default_rng(3)
    x = rng.integers(-32768, 32768, (bspec.in_per_launch, B), dtype=np.int16)
    for lane_major in (False, True):
        one = tb.make_batched_step(spec, bspec, device="cpu",
                                   lane_major=lane_major)
        four = tb.make_batched_step(spec, bspec, mesh=["cpu"] * 4,
                                    lane_major=lane_major)
        assert four.w[0] is four.w[3] is one.w
        assert (four.scheme, four.kernel, four.chunk_rows) == (
            one.scheme, one.kernel, one.chunk_rows)
        xp = np.zeros((one.chunk_rows, B), dtype=np.int16)
        xp[:bspec.in_per_launch] = x
        xt = torch.from_numpy(xp.T.copy() if lane_major else xp)
        hist = torch.from_numpy(rng.integers(-32768, 32768, (one.hist_rows, B),
                                             dtype=np.int16))
        h1, y1 = one.fn(hist, xt, one.w)
        dim = 0 if lane_major else 1
        h4, y4 = four.fn(split_lanes(hist, four.mesh),
                         split_lanes(xt, four.mesh, dim=dim), four.w)
        assert len(h4) == len(y4) == 4
        assert torch.equal(join_lanes(h4), h1)
        assert torch.equal(join_lanes(y4, dim=dim), y1)
        with pytest.raises(ValueError):
            four.fn(split_lanes(hist, four.mesh)[:3],
                    split_lanes(xt, four.mesh, dim=dim), four.w)


@pytest.mark.parametrize("into", ["jax", "port-unmeshed"])
def test_meshed_checkpoint_loads_elsewhere(into):
    """A meshed engine's checkpoint (taken with staged frames left and f0
    moved by a flush) holds the joined history of the JAX format: it loads
    into the JAX engine and into an unmeshed port engine, and a meshed
    engine restores an unmeshed one's; all continue as the source does."""
    S, C = 4, 2
    src = BatchedResampler(S, C, 44100, 48000, 7, target_chunk_frames=2352,
                           mesh=["cpu"] * 4, scheme="int8")
    src.process(_frames(S, 3000, C, 1))
    src.flush()
    src.process(_frames(S, 1000, C, 2))
    state = src.state_dict()
    assert state["f0"] != 0 and len(state["staged"])
    if into == "jax":
        dst = JaxEngine(S, C, 44100, 48000, 7, target_chunk_frames=2352,
                        use_pallas=True, pallas_interpret=True,
                        scheme="int8")
    else:
        dst = BatchedResampler(S, C, 44100, 48000, 7,
                               target_chunk_frames=2352, device="cpu",
                               scheme="int8")
    dst.load_state_dict(state)
    back = BatchedResampler(S, C, 44100, 48000, 7, target_chunk_frames=2352,
                            mesh=["cpu"] * 2, scheme="int8")
    back.load_state_dict(dst.state_dict())
    f = _frames(S, 2500, C, 3)
    want = src.process(f)
    np.testing.assert_array_equal(dst.process(f), want)
    np.testing.assert_array_equal(back.process(f), want)
    want = src.flush()
    np.testing.assert_array_equal(dst.flush(), want)
    np.testing.assert_array_equal(back.flush(), want)


def test_mesh_argument_errors():
    """B not divisible by the shard count, a mesh beside an explicit
    device, and an empty or non-device mesh raise INVALID_ARG, in the
    engine, the step, the functional step and the split helper."""
    spec = tfd.design_filter(147, 160, 7)
    bspec = tb._launch_geometry(spec, 2352)
    calls = [
        lambda: BatchedResampler(3, 1, 44100, 48000, 7, mesh=["cpu"] * 2),
        lambda: BatchedResampler(2, 2, 44100, 48000, 7, device="cpu",
                                 mesh=["cpu"] * 2),
        lambda: BatchedResampler(2, 2, 44100, 48000, 7, mesh=[]),
        lambda: BatchedResampler(2, 2, 44100, 48000, 7, mesh="cpu"),
        lambda: tb.make_batched_step(spec, bspec, device="cpu",
                                     mesh=["cpu"]),
        lambda: make_stream_fn(44100, 48000, 7, device="cpu", mesh=["cpu"]),
        lambda: make_stream_fn(44100, 48000, 7,
                               mesh=["cpu"] * 3).init(4),
        lambda: split_lanes(torch.zeros((2, 5), dtype=torch.int16),
                            ["cpu"] * 2),
    ]
    for call in calls:
        with pytest.raises(ResamplerError) as e:
            call()
        assert e.value.code == ResamplerErrorCode.INVALID_ARG
    assert shard_columns(8, 4) == [(0, 2), (2, 4), (4, 6), (6, 8)]


def test_mesh_without_a_card_raises(monkeypatch):
    """A mesh of CUDA devices raises without a card; it does not run on
    the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchedResampler(2, 2, 44100, 48000, 7, mesh=["cuda:0"] * 2)


class _FailsOnReadback:
    def detach(self):
        raise RuntimeError("injected async device fault")


@pytest.mark.parametrize("mode", ["dispatch", "readback"])
def test_meshed_engine_degrades_with_exact_counts(mode):
    """A fault on one shard (raised while the launch is queued, or from
    shard 1's result at readback) degrades the whole engine: the healthy
    prefix as before, then zeros with the unmeshed engine's exact sample
    counts, and the fault visible."""
    S, C = 4, 2
    plain = BatchedResampler(S, C, 44100, 48000, 7, target_chunk_frames=2352,
                             device="cpu")
    eng = BatchedResampler(S, C, 44100, 48000, 7, target_chunk_frames=2352,
                           mesh=["cpu"] * 4)
    real = eng._step.fn
    calls = {"n": 0}

    def step(hists, xs, w):
        calls["n"] += 1
        if calls["n"] == 1:
            return real(hists, xs, w)
        if mode == "dispatch":
            raise RuntimeError("injected device fault")
        h, y = real(hists, xs, w)
        y[1] = _FailsOnReadback()
        return h, y

    eng._step = dataclasses.replace(eng._step, fn=step)
    frames = [_frames(S, n, C, 20 + k) for k, n in enumerate((5000, 3000))]
    want = [plain.process(f) for f in frames] + [plain.flush()]
    with pytest.warns(RuntimeWarning, match="degraded"):
        got = [eng.process(f) for f in frames] + [eng.flush()]
    assert eng.degraded and "injected" in str(eng.degraded_cause)
    assert [g.shape for g in got] == [w.shape for w in want]
    n1 = plain.out_frames_per_launch
    np.testing.assert_array_equal(got[0][:, :n1], want[0][:, :n1])
    assert not got[0][:, n1:].any() and not got[1].any()
    assert not got[2].any() and eng.degraded_launches > 0
    assert isinstance(eng.state_dict()["hist"], np.ndarray)
