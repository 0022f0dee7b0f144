"""The port's MultiFleet against the JAX package's, on the CPU.

A twin harness makes every call on both — the port's ``MultiFleet(device=
"cpu")`` (the kernels' plain versions) and the JAX package's
``MultiFleet(use_pallas=True, pallas_interpret=True)`` with "auto"
resolving as on the TPU (int8) — and requires the same return value or
the same error code.  Tolerance: bit-identical in both universes (the
fleets' int8 and fixed outputs are, and the transition and tail cores run
the same host loops).  Covered: buckets of the tiled and streamed
geometries, attach/detach, ``end_stream`` tails (also during a live
transition), ``set_stream_rate`` (chained mid-transition, push-free
chained, same-key, rejected), watermarks with refusals, the idle-bucket
LRU (an evicted bucket's fleet is closed), and checkpoints crossing
between the packages both ways mid-run.  JAX ``tests/test_multifleet.py``
names the scenarios; where it holds a stream against the absent oracle,
the JAX package is the golden here.
"""

import pickle

import numpy as np
import pytest
import torch

from speex_resampler_tpu.parallel import batch as jb
from speex_resampler_tpu.runtime.multifleet import MultiFleet as JaxMulti
from speex_resampler_tpu.utils.errors import ResamplerError as JaxError
from speex_resampler_tpu_torch import ResamplerError
from speex_resampler_tpu_torch.runtime import MultiFleet

torch.set_num_threads(1)

ERRORS = (ResamplerError, JaxError)
FLAG = (44100, 48000, 7)
DIRECT = (24000, 48000, 5)


@pytest.fixture(autouse=True)
def _auto_as_on_the_chip(monkeypatch):
    """The JAX engine resolves "auto" to int8, as on the TPU (under
    interpret mode it would resolve "highest")."""
    monkeypatch.setattr(jb, "AUTO_RESOLVE_UNDER_INTERPRET", True)


def _eq(a, b, where="state"):
    """Deep equality of two packages' results or state dicts."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), where
        for k in a:
            _eq(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _eq(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a, b), where
    else:
        assert a == b, where


class Twin:
    """A JAX and a port MultiFleet driven by the same calls."""

    def __init__(self, fixed=False, **kw):
        self.kw = {"channels": 1, "capacity_per_bucket": 2,
                   "target_chunk_frames": 256, "fixed_point": fixed, **kw}
        self.j = JaxMulti(use_pallas=True, pallas_interpret=True, **self.kw)
        self.p = MultiFleet(device="cpu", **self.kw)

    def __getattr__(self, name):
        def call(*args):
            res = []
            for mf in (self.j, self.p):
                try:
                    res.append(("ok", getattr(mf, name)(*args)))
                except ERRORS as e:
                    res.append(("error", int(e.code)))
            _eq(res[0], res[1], name)
            if res[1][0] == "error":
                raise ResamplerError(res[1][1])
            return res[1][1]
        return call

    def check(self):
        """Same buckets, idle order, slots and stream state."""
        _eq(self.j.state_dict(), self.p.state_dict())
        assert list(self.j._buckets) == list(self.p._buckets)
        for k, b in self.p._buckets.items():
            jf, pf = self.j._buckets[k].fleet, b.fleet
            assert (jf.bspec.kernel, jf._step.scheme) == (
                pf.bspec.kernel, pf._step.scheme), k
        assert not self.p.degraded

    def swap(self):
        """Restore each package's state into a new MultiFleet of the
        other (through pickle) and continue with those."""
        js, ps = (pickle.loads(pickle.dumps(m.state_dict()))
                  for m in (self.j, self.p))
        self.j = JaxMulti(use_pallas=True, pallas_interpret=True, **self.kw)
        self.j.load_state_dict(ps)
        self.p = MultiFleet(device="cpu", **self.kw)
        self.p.load_state_dict(js)
        self.check()


def _pcm(n, seed, c=1):
    rng = np.random.default_rng(seed)
    return (rng.integers(-32768, 32768, (n, c)) // 2).astype(np.int16)


@pytest.mark.parametrize("fixed", [False, True])
def test_heterogeneous_buckets(fixed):
    """Four configs (tiled interpolated, tiled direct, streamed,
    downsampling), stereo, ragged pushes and bytes, polls, flush: the
    flagship, 24k->48k q5 and 44.1k->24k q5 buckets are tiled, 48k->44.1k
    streamed."""
    t = Twin(fixed, channels=2, capacity_per_bucket=3,
             target_chunk_frames=1024)
    cfgs = [FLAG, DIRECT, (48000, 44100, 5), (44100, 24000, 5)]
    for i, cfg in enumerate(cfgs):
        t.add_stream(i, *cfg)
        t.add_stream(f"x{i}", *cfg)
    kernels = {k: b.fleet.bspec.kernel for k, b in t.p._buckets.items()}
    assert kernels == {FLAG: "tiled", DIRECT: "tiled",
                       (48000, 44100, 5): "streamed",
                       (44100, 24000, 5): "tiled"}
    for st in range(0, 6000, 1500):
        for i in range(4):
            x = _pcm(1500, st + i, 2)
            t.push(i, x)
            t.push_bytes(f"x{i}", x.tobytes()[:2999])
        t.poll()
        for i in range(4):
            t.pull(i)
    t.check()
    t.flush()
    for i in range(4):
        t.pull(i)
        t.pull(f"x{i}")
    t.check()


@pytest.mark.parametrize("fixed", [False, True])
def test_attach_detach_and_end_stream_tails(fixed):
    """Capacity-bound attach, end_stream's exact sub-quantum tail, the
    freed slot reused, remove_stream dropping staged input, end_stream
    during a live transition."""
    t = Twin(fixed)
    t.add_stream("s1", *DIRECT)
    t.push("s1", _pcm(3000, 1))
    t.poll()
    t.add_stream("s2", *DIRECT)
    with pytest.raises(ResamplerError):
        t.add_stream("s3", *DIRECT)
    t.end_stream("s1")
    t.pull("s1")
    with pytest.raises(ResamplerError):
        t.pull("s1")                  # collected with its tail
    t.add_stream("s3", *DIRECT)
    t.push("s3", _pcm(1234, 2))
    t.push("s2", _pcm(700, 3))
    t.remove_stream("s2")
    t.end_stream("s3")
    t.pull("s3")
    t.add_stream("live", *FLAG)
    t.push("live", _pcm(1999, 4))
    t.set_stream_rate("live", 48000, 44100, 5)
    t.push("live", _pcm(3, 5))
    assert t.p._streams["live"].transition is not None
    t.end_stream("live")
    t.pull("live")
    t.check()


@pytest.mark.parametrize("fixed", [False, True])
def test_set_stream_rate_chained_and_push_free(fixed):
    """A switch, a tiny push the live transition retains, a chained switch
    mid-transition; then a shrinking switch that stashes magic samples
    followed by a push-free chained switch (the stash migrates, resample.c
    :727-765); a switch before any data (the unstarted path); a same-key
    switch; a switch C rejects (OVERFLOW), which leaves the stream
    serving."""
    t = Twin(fixed)
    t.add_stream("a", *DIRECT)
    t.push("a", _pcm(100, 1))
    t.set_stream_rate("a", *FLAG)
    t.push("a", _pcm(3, 2))
    t.set_stream_rate("a", 48000, 48000, 5)
    t.push("a", _pcm(2000, 3))
    t.add_stream("b", *FLAG)
    t.push("b", _pcm(500, 4))
    t.poll()
    t.set_stream_rate("b", 48000, 24000, 4)
    tr = t.p._streams["b"].transition
    assert tr is not None and not tr.fed and tr.core.magic_samples[0] > 0
    t.set_stream_rate("b", 24000, 48000, 5)
    t.push("b", _pcm(2000, 5))
    t.check()
    t.add_stream("c", *FLAG)
    t.set_stream_rate("c", *DIRECT)
    t.push("c", _pcm(1761, 6))
    t.set_stream_rate("c", *DIRECT)
    with pytest.raises(ResamplerError):
        t.set_stream_rate("c", 4294967291, 8000)
    t.push("c", _pcm(900, 7))
    t.poll()
    t.check()
    t.flush()
    for sid in "abc":
        t.pull(sid)
    t.check()


def _churn(t, seed, steps, configs):
    """Random attach / push / push_bytes / poll / switch / end / remove /
    pull / writable / cross-package checkpoint swaps, mirrored call by
    call; returns (refused calls, launches polled)."""
    rng = np.random.default_rng(seed)
    live, ended, refused, launched, next_id = [], [], 0, 0, 0
    ops = ["add", "push", "bytes", "poll", "switch", "end", "remove",
           "pull", "swap"]
    for _ in range(steps):
        op = rng.choice(ops, p=[.1, .25, .1, .2, .06, .08, .02, .16, .03])
        sid = live[int(rng.integers(len(live)))] if live else None
        try:
            if op == "add" and len(live) < 5:
                cfg = configs[int(rng.integers(len(configs)))]
                t.add_stream(f"s{next_id}", *cfg)
                live.append(f"s{next_id}")
                next_id += 1
            elif op == "push" and sid:
                n = int(rng.integers(10, 2500))
                t.writable(sid, n)
                t.push(sid, _pcm(n, int(rng.integers(1 << 30))))
            elif op == "bytes" and sid:
                t.push_bytes(sid, rng.integers(
                    0, 256, int(rng.integers(1, 3000)),
                    dtype=np.uint8).tobytes())
            elif op == "poll":
                launched += t.poll()
            elif op == "switch" and sid:
                t.set_stream_rate(sid, *configs[int(rng.integers(
                    len(configs)))])
            elif op in ("end", "remove") and sid:
                getattr(t, f"{op}_stream")(sid)
                live.remove(sid)
                ended.append(sid)
            elif op == "pull":
                pool = live + [s for s in ended if s in t.p._streams]
                if pool:
                    t.pull(pool[int(rng.integers(len(pool)))])
            elif op == "swap":
                t.swap()
        except ResamplerError:
            refused += 1
    t.check()
    t.flush()
    for sid in live + ended:
        if sid in t.p._streams:
            t.pull(sid)
    t.check()
    return refused, launched


@pytest.mark.parametrize("seed", [42, 2024])
@pytest.mark.parametrize("fixed", [False, True])
def test_churn_matches_jax(fixed, seed):
    """Randomized churn with one idle bucket kept (so configs are evicted
    and rebuilt) and tight watermarks on the second seed (pushes refused
    at the staging, banked and carryover bounds, writable() agreeing)."""
    wm = (dict(max_staged_frames=6000, max_banked_frames=3000)
          if seed == 2024 else {})
    t = Twin(fixed, capacity_per_bucket=3, max_idle_buckets=1, **wm)
    refused, launched = _churn(t, seed, 160,
                               [DIRECT, FLAG, (48000, 24000, 4)])
    assert launched > 0
    if wm:
        assert refused > 0


def test_idle_lru_evicts_closes_and_rebuilds():
    """A bucket whose last stream leaves joins the idle LRU; past
    max_idle_buckets the oldest is released and its fleet closed at once
    (slabs, readback buffers, history and stager dropped); a returning
    config rebuilds; a restore replays the donor's LRU order."""
    t = Twin(max_idle_buckets=1)
    keys = [(44100, 48000, 4), (44100, 24000, 4), (44100, 32000, 4)]
    fleets = []
    for i, k in enumerate(keys):
        t.add_stream(f"s{i}", *k)
        fleets.append(t.p._buckets[k].fleet)
        t.push(f"s{i}", _pcm(300, i))
        t.end_stream(f"s{i}")
        t.pull(f"s{i}")
        assert len(t.p._buckets) <= 1
    for f in fleets[:2]:
        assert f._slabs == [] and f._hist is None and f._stager is None
    assert fleets[2]._slabs
    t.add_stream("again", *keys[0])
    t.push("again", _pcm(900, 7))
    t.end_stream("again")
    t.pull("again")
    assert list(t.p._idle) == list(t.j._idle) == [keys[0]]
    t.swap()


def test_checkpoint_carries_transitions_and_carries_bytes():
    """A snapshot with a live transition (its core and retained frames),
    a byte carry, carryover and an ended stream's tail restores in the
    other package, which continues identically."""
    for first in ("jax", "port"):
        t = Twin()
        t.add_stream("a", *FLAG)
        t.add_stream("b", *DIRECT)
        t.push("a", _pcm(1999, 1))
        t.push_bytes("b", _pcm(600, 2).tobytes()[:1001])
        t.poll()
        t.set_stream_rate("a", 48000, 44100, 5)
        t.push("a", _pcm(3, 3))
        t.add_stream("c", *DIRECT)
        t.push("c", _pcm(777, 4))
        t.end_stream("c")
        state = (t.j if first == "jax" else t.p).state_dict()
        assert state["streams"]["a"]["transition"] is not None
        assert any(state["buckets"][DIRECT]["fleet"]["carry"])
        t.swap()
        t.push("a", _pcm(4000, 5))
        t.push_bytes("b", _pcm(900, 6).tobytes())
        t.flush()
        for sid in "abc":
            t.pull(sid)
        t.check()
    with pytest.raises(ResamplerError):
        MultiFleet(channels=2, device="cpu").load_state_dict(state)


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MultiFleet(channels=2)
