"""Lightweight throughput/latency instrumentation.

A counters object the engines update per launch, with named per-phase
host wall-clock, so the serving pipeline's cost structure (gather ->
dispatch -> readback -> unpack) is visible in production and in
``chip_smoke.py``; and an optional ``torch.profiler`` trace scope for deep
dives.

On CUDA the phases are host-clock spans of an asynchronous pipeline:
``phase("dispatch")`` times only the enqueue of the upload, the step and
the readback copy.  The device's time shows up where the host first waits
for it, in ``phase("readback")``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

__all__ = ["LaunchStats", "trace"]


@dataclasses.dataclass
class LaunchStats:
    """Rolling serving metrics; cheap enough to keep always-on."""
    launches: int = 0
    in_samples: int = 0
    out_samples: int = 0
    device_seconds: float = 0.0
    # cumulative wall-clock per named pipeline phase (FleetResampler.poll
    # phases: gather / dispatch / readback / unpack)
    phase_seconds: dict = dataclasses.field(default_factory=dict)
    # best (min) single span per phase: a mean absorbs descheduling
    # stalls of a shared host; the min is the host path's capability
    phase_min_seconds: dict = dataclasses.field(default_factory=dict)

    def record(self, n_in: int, n_out: int, seconds: float):
        self.launches += 1
        self.in_samples += n_in
        self.out_samples += n_out
        self.device_seconds += seconds

    @contextlib.contextmanager
    def launch(self, n_in: int, n_out: int):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(n_in, n_out, time.perf_counter() - t0)

    @contextlib.contextmanager
    def phase(self, name: str):
        """Attribute a span of host wall-clock to one pipeline phase."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.phase_seconds[name] = (self.phase_seconds.get(name, 0.0)
                                        + dt)
            prev = self.phase_min_seconds.get(name)
            if prev is None or dt < prev:
                self.phase_min_seconds[name] = dt

    @property
    def out_samples_per_sec(self) -> float:
        return self.out_samples / self.device_seconds \
            if self.device_seconds else 0.0

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
            "device_seconds": round(self.device_seconds, 6),
            "out_samples_per_sec": round(self.out_samples_per_sec),
            "phase_ms_per_launch": self.phase_ms_per_launch(),
            "phase_ms_min": self.phase_ms_min(),
        }


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` scope over the CPU and, where there is one, the
    CUDA device; exports a Chrome trace (``trace.json``, view it in
    Perfetto or ``chrome://tracing``) into ``log_dir`` at exit."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
