"""Spans on the profiler's clock, serving counters, and a trace exporter.

:class:`span` is the port's one span primitive.  Every span adds 1 and its
host seconds to a process-wide table (:func:`span_totals`,
:func:`reset_spans`).  While a ``torch.profiler`` records, a span is also a
profiler range, so it lies on the clock of the device trace and each idle
gap of the device can be put down to the span the host was in.  The range
is the C++ one that ``record_function`` opens after a dispatch through a
Python op (``_RecordFunctionFast``, where this torch has it): the same
event for less than half the host time.  Whether a profiler records is one
check of a flag: with none, a span opens no range (a flag check, two clock
reads and a lock).  There is no other switch.

The port's spans (``PERF.md`` section 3 says what reads each):

- ``speex.step``: one call of ``functional.make_stream_fn``'s step, around
  ``speex.step.pad`` (opened only where a copy of x was made: an x that
  is not int16, contiguous and 16-byte aligned; its count is the quanta
  copied), the kernel wrapper and ``speex.step.hist`` (the next history);
- ``speex.kernel.streamed`` (both phase-tiled geometries) / ``.dense`` /
  ``.gather``: a kernel wrapper, its checks to its launch (its plain
  version on the CPU);
- ``speex.setup.design`` / ``.planes`` / ``.upload`` / ``.library``: the
  filter design, a step's host weights, their upload (where the process's
  CUDA context is made, if nothing made it before), and the kernel
  library's build or load;
- ``speex.setup.q15``: the host work of a fixed (Q15) tiled, streamed or
  dense step alone, once inside ``.planes`` (its int16 accumulator column
  sets and Q15 cubic coefficients) and once inside ``.upload`` (the
  balanced int8 split of its taps, before any copy to the device);
- ``speex.fleet.gather`` / ``.dispatch`` / ``.readback`` / ``.unpack``:
  the phases of ``FleetResampler.poll`` (:meth:`LaunchStats.phase`).

:func:`count` adds to a process-wide table of counters beside the spans'
(:func:`counter_totals`, :func:`reset_counters`; ``utils/launches.
reset_launches`` resets it too), counted on the host where the work is
launched, with no device work and no sync.  The port's counters:

- ``speex.kernel.fixed.launches`` / ``.ctas`` / ``.tiles``: the phase-
  tiled fixed kernel's launches (``ops/streamed_fir.resample_streamed``,
  both geometries), the CTAs they launched and the output tiles (block,
  row tile, 64-lane tile) those CTAs walked; at n_accum 4 the CTAs are
  persistent, so tiles over CTAs is the tiles a CTA walked.

:class:`LaunchStats` keeps a fleet's counters: launches and samples, and
the host wall-clock of each pipeline phase.  On CUDA the phases are
host-clock spans of an asynchronous pipeline: ``dispatch`` times only the
enqueue of the upload, the step and the readback copy; the device's time
shows up where the host first waits for it, in ``readback``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
from time import perf_counter

import torch
from torch.autograd.profiler import record_function

__all__ = ["span", "span_totals", "reset_spans", "count", "counter_totals",
           "reset_counters", "LaunchStats", "trace"]

_profiler_enabled = torch._C._autograd._profiler_enabled
#: the profiler's range for a span: ``record_function``'s C++ range,
#: without its op dispatch, where this torch has it
_profiler_range = getattr(torch._C._profiler, "_RecordFunctionFast",
                          record_function)
_totals: dict = {}          # name -> [count, seconds]
_counters: dict = {}        # name -> count
_totals_lock = threading.Lock()


class span:
    """``with span(name):`` times its body into :func:`span_totals` and,
    while a ``torch.profiler`` records, marks it as a profiler range
    (a ``record_function``'s).  ``@span(name)`` on a function does the
    same for each call.  ``seconds`` holds the last body's host
    seconds."""

    __slots__ = ("name", "seconds", "_t0", "_range")

    def __init__(self, name: str):
        self.name = name
        self.seconds = 0.0

    def __enter__(self):
        if _profiler_enabled():
            self._range = _profiler_range(self.name)
            self._range.__enter__()
        else:
            self._range = None
        self._t0 = perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = dt = perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
        with _totals_lock:
            total = _totals.get(self.name)
            if total is None:
                _totals[self.name] = [1, dt]
            else:
                total[0] += 1
                total[1] += dt
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return spanned


def span_totals() -> dict:
    """Every span's count and summed host seconds since the process began
    or the last :func:`reset_spans`: name -> (count, seconds)."""
    with _totals_lock:
        return {k: (n, s) for k, (n, s) in _totals.items()}


def reset_spans() -> None:
    """Sets every span's count and seconds to 0 (drops them)."""
    with _totals_lock:
        _totals.clear()


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the counter ``name``."""
    with _totals_lock:
        _counters[name] = _counters.get(name, 0) + n


def counter_totals() -> dict:
    """Every counter's total since the process began or the last
    :func:`reset_counters`: name -> count."""
    with _totals_lock:
        return dict(_counters)


def reset_counters() -> None:
    """Sets every counter to 0 (drops them)."""
    with _totals_lock:
        _counters.clear()


@dataclasses.dataclass
class LaunchStats:
    """Rolling serving metrics; cheap enough to keep always-on."""
    launches: int = 0
    in_samples: int = 0
    out_samples: int = 0
    # cumulative wall-clock per named pipeline phase (FleetResampler.poll
    # phases: gather / dispatch / readback / unpack)
    phase_seconds: dict = dataclasses.field(default_factory=dict)
    # best (min) single span per phase: a mean absorbs descheduling
    # stalls of a shared host; the min is the host path's capability
    phase_min_seconds: dict = dataclasses.field(default_factory=dict)

    def record(self, n_in: int, n_out: int):
        self.launches += 1
        self.in_samples += n_in
        self.out_samples += n_out

    @contextlib.contextmanager
    def launch(self, n_in: int, n_out: int):
        """Counts one launch of ``n_in`` / ``n_out`` samples at exit."""
        try:
            yield
        finally:
            self.record(n_in, n_out)

    @contextlib.contextmanager
    def phase(self, name: str):
        """Attribute a span of host wall-clock to one pipeline phase: the
        span ``speex.fleet.<name>``, whose seconds also go to this
        engine's tables."""
        s = span(f"speex.fleet.{name}")
        try:
            with s:
                yield
        finally:
            self.phase_seconds[name] = (self.phase_seconds.get(name, 0.0)
                                        + s.seconds)
            prev = self.phase_min_seconds.get(name)
            if prev is None or s.seconds < prev:
                self.phase_min_seconds[name] = s.seconds

    @property
    def out_samples_per_sec(self) -> float:
        """Out samples over the summed seconds of the phases: the rate of
        ``poll``'s own host time, readback's wait for the device
        included."""
        seconds = sum(self.phase_seconds.values())
        return self.out_samples / seconds if seconds else 0.0

    def phase_ms_per_launch(self) -> dict:
        """Per-launch milliseconds by phase (empty until a launch ran)."""
        if not self.launches:
            return {}
        return {k: round(v * 1e3 / self.launches, 4)
                for k, v in self.phase_seconds.items()}

    def phase_ms_min(self) -> dict:
        """Best observed single-launch milliseconds per phase."""
        return {k: round(v * 1e3, 4)
                for k, v in self.phase_min_seconds.items()}

    def as_dict(self) -> dict:
        return {
            "launches": self.launches,
            "in_samples": self.in_samples,
            "out_samples": self.out_samples,
            "out_samples_per_sec": round(self.out_samples_per_sec),
            "phase_ms_per_launch": self.phase_ms_per_launch(),
            "phase_ms_min": self.phase_ms_min(),
        }


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` scope over the CPU and, where there is one, the
    CUDA device; exports a Chrome trace (``trace.json``, view it in
    Perfetto or ``chrome://tracing``) into ``log_dir`` at exit.  The
    port's spans are recorded in it."""
    import os

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
