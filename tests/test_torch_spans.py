"""The port's spans (``utils.profiling.span``), the fleet's counters built
on them, the benchmark's readers of the spans, and the port's kernel table
as the benchmark reads it.

On the CPU: under ``torch.profiler`` the stream step's spans nest as
``speex.step`` around its kernel wrapper and its next history (and
``speex.step.pad``, the copy of a quantum the kernel cannot read in
place);
with no profiler a span never enters ``record_function``; a step-cache hit
builds no weights again; the fleet's phases are ``speex.fleet.*`` spans.
"""

import dataclasses
import math
import os
import re
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import manifest, tracing
from speex_resampler_tpu_torch import FleetResampler, make_stream_fn
from speex_resampler_tpu_torch.ops import _build
from speex_resampler_tpu_torch.ops import filter_design as fd
from speex_resampler_tpu_torch.ops import streamed_fir as sf
from speex_resampler_tpu_torch.ops import tiled_fir as tf
from speex_resampler_tpu_torch.parallel.batch import (_launch_geometry,
                                                      clear_step_cache,
                                                      make_batched_step)
from speex_resampler_tpu_torch.utils import launches, profiling
from speex_resampler_tpu_torch.utils.profiling import (LaunchStats,
                                                       reset_spans, span,
                                                       span_totals)

torch.set_num_threads(1)

RATES = (44100, 48000, 7)
TARGET = 600
#: a step on an int16, contiguous, aligned quantum makes no copy, so opens
#: no ``speex.step.pad``
STEP_CHILDREN = ["speex.kernel.streamed", "speex.step.hist"]


def _pcm(rs, B, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-30000, 30000, (rs.in_frames, B),
                                         dtype=np.int16))


def _speex_events(prof) -> list:
    """(name, start, end) of the port's spans in the profiler's events,
    in the order they began."""
    ev = [(e.name, e.time_range.start, e.time_range.end)
          for e in prof.events() if e.name.startswith("speex.")]
    return sorted(ev, key=lambda e: (e[1], -e[2]))


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_step_spans_nest_under_the_profiler():
    rs = make_stream_fn(*RATES, target_in_frames=TARGET, device="cpu")
    hist = rs.init(4)
    x = _pcm(rs, 4, 1)
    rs.step(hist, x)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        rs.step(hist, x)
    ev = _speex_events(prof)
    steps = [e for e in ev if e[0] == "speex.step"]
    assert len(steps) == 1
    children = [e for e in ev if e[0] != "speex.step"]
    assert [e[0] for e in children] == STEP_CHILDREN
    assert all(_inside(c, steps[0]) for c in children)
    assert all(a[2] <= b[1] for a, b in zip(children, children[1:]))


def test_mesh_step_is_one_step_span_around_each_shard():
    rs = make_stream_fn(*RATES, target_in_frames=TARGET, mesh=["cpu"] * 2)
    hist = rs.init(4)
    x = _pcm(rs, 4, 2)
    xs = [x[:, :2], x[:, 2:]]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        rs.step(hist, xs)
    ev = _speex_events(prof)
    steps = [e for e in ev if e[0] == "speex.step"]
    assert len(steps) == 1
    # the shards are column views of x, strided: each is copied once
    names = [e[0] for e in ev if e[0] != "speex.step"]
    assert sorted(names) == sorted(["speex.step.pad", *STEP_CHILDREN] * 2)
    assert all(_inside(e, steps[0]) for e in ev)


def test_no_profiler_never_enters_record_function(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")

    for module in (profiling, torch.profiler, torch.autograd.profiler):
        monkeypatch.setattr(module, "record_function", refuse)
    monkeypatch.setattr(profiling, "_profiler_range", refuse)
    rs = make_stream_fn(*RATES, target_in_frames=TARGET, device="cpu")
    reset_spans()
    hist = rs.init(4)
    for i in range(3):
        hist, _ = rs.step(hist, _pcm(rs, 4, i))
    totals = span_totals()
    for name in ["speex.step", *STEP_CHILDREN]:
        assert totals[name][0] == 3 and totals[name][1] > 0.0
    assert "speex.step.pad" not in totals


def test_a_step_cache_hit_builds_no_weights_again():
    clear_step_cache()
    reset_spans()
    make_stream_fn(*RATES, target_in_frames=TARGET, device="cpu")
    first = span_totals()
    for name in ("speex.setup.design", "speex.setup.planes",
                 "speex.setup.upload"):
        assert first[name][0] == 1, name
    reset_spans()
    make_stream_fn(*RATES, target_in_frames=TARGET, device="cpu")
    again = span_totals()
    assert again["speex.setup.design"][0] == 1
    assert "speex.setup.planes" not in again
    assert "speex.setup.upload" not in again


def test_span_as_a_decorator_and_reset():
    reset_spans()

    @span("speex.test.decorated")
    def twice(v):
        return 2 * v

    assert twice(4) == 8 and twice(1) == 2 and twice.__name__ == "twice"
    with pytest.raises(ValueError):
        with span("speex.test.raised"):
            raise ValueError("spans do not swallow errors")
    totals = span_totals()
    assert totals["speex.test.decorated"][0] == 2
    assert totals["speex.test.raised"][0] == 1
    reset_spans()
    assert span_totals() == {}


def test_span_totals_lose_no_update_across_threads():
    """More threads than cores, each closing many spans of one name with
    the interpreter switching threads as often as it can: the count is
    every span."""
    threads, each = 2 * (os.cpu_count() or 1) + 2, 2000

    def work():
        for _ in range(each):
            with span("speex.test.threads"):
                pass

    reset_spans()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    assert span_totals()["speex.test.threads"][0] == threads * each


def _fleet_with_two_launches():
    S, C = 3, 2
    fleet = FleetResampler(S, C, *RATES, target_chunk_frames=2352,
                           device="cpu")
    q = fleet.bspec.in_per_launch
    rng = np.random.default_rng(21)
    for s in range(S):
        fleet.push(s, rng.integers(-30000, 30000, (2 * q, C),
                                   dtype=np.int16))
    return fleet


def test_fleet_phases_are_spans():
    fleet = _fleet_with_two_launches()
    reset_spans()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert fleet.poll() == 2
    names = [e[0] for e in _speex_events(prof)]
    phases = ("gather", "dispatch", "readback", "unpack")
    for phase in phases:
        assert names.count(f"speex.fleet.{phase}") == 2, phase
    totals = span_totals()
    for phase in phases:
        n, seconds = totals[f"speex.fleet.{phase}"]
        assert n == 2
        assert seconds == pytest.approx(fleet.stats.phase_seconds[phase])


def test_out_samples_per_sec_is_over_the_phases_seconds():
    fleet = _fleet_with_two_launches()
    assert fleet.poll() == 2
    st = fleet.stats
    assert not hasattr(st, "device_seconds")
    assert "device_seconds" not in st.as_dict()
    seconds = sum(st.phase_seconds.values())
    assert st.out_samples == 2 * fleet.bspec.out_per_launch * fleet.B
    assert st.out_samples_per_sec == pytest.approx(st.out_samples / seconds)
    assert LaunchStats().out_samples_per_sec == 0.0


def test_launch_counts_without_timing():
    st = LaunchStats()
    with st.launch(10, 20):
        pass
    with pytest.raises(RuntimeError):
        with st.launch(1, 2):
            raise RuntimeError("a failed launch is counted")
    assert (st.launches, st.in_samples, st.out_samples) == (2, 11, 22)
    assert st.phase_seconds == {} and st.out_samples_per_sec == 0.0


def _view(device, host, calls=2):
    return tracing.TraceView(calls=calls, device=device, host=host,
                             work=None, peaks=None)


KERNEL = "void (anonymous namespace)::tiled_fir_int8_kernel<3, true>(x)"


def test_step_host_reader_takes_the_runtime_out():
    """Two calls of 100 us each: the first with a 30 us launch that waits
    10 us more for a full command buffer, the second with a 20 us
    launch; the rest is the port's own host work."""
    read = manifest.reader("step.host_ms")
    dev = [(KERNEL, 0.0, 200e-6), (KERNEL, 200e-6, 400e-6)]
    host = [("perfbench.call", 0.0, 110e-6),
            ("speex.step", 0.0, 100e-6),
            ("speex.kernel.streamed", 10e-6, 70e-6),
            ("cudaLaunchKernel", 30e-6, 60e-6),
            ("Command Buffer Full", 55e-6, 70e-6),
            ("perfbench.call", 110e-6, 220e-6),
            ("speex.step", 110e-6, 210e-6),
            ("cuLaunchKernel", 150e-6, 170e-6),
            ("cudaDeviceSynchronize", 215e-6, 400e-6)]
    own = (100 - 40) + (100 - 20)
    assert read(_view(dev, host)) == pytest.approx(own / 2 * 1e-3)


def test_step_host_reader_none_without_device_or_spans():
    read = manifest.reader("step.host_ms")
    host = [("speex.step", 0.0, 100e-6)]
    assert read(_view([], host)) is None
    assert read(_view([(KERNEL, 0.0, 1e-4)], [("perfbench.call", 0, 1)]))\
        is None
    assert read(_view([(KERNEL, 0.0, 1e-4)], host, calls=0)) is None


@pytest.mark.parametrize("metric,span_name", [
    ("setup.planes_s", "speex.setup.planes"),
    ("setup.upload_s", "speex.setup.upload")])
def test_setup_readers_read_the_span_totals(monkeypatch, metric, span_name):
    read = manifest.reader(metric)
    dev = [(KERNEL, 0.0, 1e-4)]
    monkeypatch.setattr(profiling, "span_totals", lambda: {
        "speex.setup.planes": (2, 0.75), "speex.setup.upload": (1, 0.25)})
    want = {"speex.setup.planes": 0.75, "speex.setup.upload": 0.25}
    assert read(_view(dev, [])) == pytest.approx(want[span_name])
    assert read(_view([], [])) is None
    monkeypatch.setattr(profiling, "span_totals", lambda: {})
    assert read(_view(dev, [])) is None


def _global_functions(path: Path) -> list:
    src = path.read_text()
    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\("
                      r"(?:[^()]|\([^()]*\))*\)\s*)?(\w+)\s*\(", src)


@pytest.mark.parametrize("source", _build._SOURCE_NAMES)
def test_every_served_kernel_is_a_port_kernel(source):
    names = _global_functions(_build._CSRC / source)
    assert names
    for name in names:
        profiled = f"void (anonymous namespace)::{name}<3>(fir::Launch)"
        assert tracing.is_port_kernel(profiled), name


def test_the_long_int8_kernel_is_the_stream_form(monkeypatch):
    """A tiled int8 step whose band is past the resident kernel's slices
    launches the streamed int8 kernel, its "stream" form: its weights
    with their band widths in place of their slice count
    (``int8_launch_weights``, with the library's
    slice limit stubbed here) are named ``streamed_fir_int8_kernel`` and
    counted under the one launcher's "int8"; a band within the limit
    keeps its slices and the resident kernel.  A CPU step, which launches
    no kernel, keeps its slices and is named by the resident one."""
    assert launches.kernel_name("tiled", "int8", form="stream") \
        == "streamed_fir_int8_kernel"
    assert launches.kernel_name("tiled", "int8") == "tiled_fir_int8_kernel"
    spec = fd.design_filter(147, 160, 7)
    step = make_batched_step(spec, _launch_geometry(spec, TARGET),
                             device="cpu")
    assert step.w[2] == 7
    assert launches.step_kernel(step) == (("streamed", "int8_resident"),
                                          "tiled_fir_int8_kernel")
    for limit, resident in ((7, True), (6, False)):
        monkeypatch.setattr(_build, "load", lambda limit=limit: type(
            "Lib", (), {"tiled_fir_int8_max_slices":
                        staticmethod(lambda D: limit)}))
        w = sf.int8_launch_weights(step.w)
        assert (w is step.w) == resident
        if not resident:
            assert len(w) == 4 and w[3] is step.w[3]
            assert w[2].slices == tf.band_widths(step.w[3].numpy()).slices
            long = dataclasses.replace(step, w=w)
            assert launches.step_kernel(long) == (
                ("streamed", "int8"), "streamed_fir_int8_kernel")


# one step of every geometry and scheme the port builds: (rates, quality,
# fixed, scheme, target frames, latency cap ms)
BUILT = [((44100, 48000), 7, False, "highest", 600, None),
         ((44100, 48000), 7, False, "int8", 600, None),
         ((44100, 48000), 7, False, "split5", 600, None),
         ((44100, 48000), 7, True, "auto", 600, None),
         ((24000, 48000), 5, True, "auto", 600, None),
         ((44100, 16000), 7, False, "highest", 600, None),
         ((44100, 16000), 7, False, "int8", 600, None),
         ((44100, 16000), 7, False, "split5", 600, None),
         ((48000, 44100), 5, True, "auto", 600, None),
         ((44100, 48000), 3, False, "auto", 882, 20),
         ((44100, 48000), 3, True, "auto", 882, 20),
         ((48000, 16000), 3, True, "auto", 882, 20),
         ((44100, 44101), 1, False, "auto", 44100, None),
         ((44100, 44101), 1, True, "auto", 44100, None),
         ((96000, 401), 0, False, "auto", 44100, None),
         ((96000, 401), 0, True, "auto", 44100, None)]


def test_every_kernel_a_built_step_names_is_in_the_sources():
    """Every name ``kernel_name`` gives a step the port builds (through
    ``step_kernel``: both phase-tiled geometries in every scheme, the
    dense and gather ones in both universes) is a ``__global__`` function
    of ``_build._SOURCE_NAMES``; the other direction is
    test_every_served_kernel_is_a_port_kernel's."""
    defined = {name for source in _build._SOURCE_NAMES
               for name in _global_functions(_build._CSRC / source)}
    seen = set()
    for (i, o), q, fixed, scheme, target, cap in BUILT:
        g = math.gcd(i, o)
        spec = fd.design_filter(i // g, o // g, q, fixed_point=fixed)
        cap = None if cap is None else int(cap * i / 1000)
        step = make_batched_step(spec, _launch_geometry(
            spec, target, max_in_frames=cap), device="cpu", scheme=scheme)
        name = launches.step_kernel(step)[1]
        assert name.split("<")[0] in defined, (i, o, q, fixed, name)
        seen.add((step.kernel, step.scheme))
        clear_step_cache()
    assert {k for k, _ in seen} == {"tiled", "streamed", "dense", "gather"}
    assert len(seen) == 12
