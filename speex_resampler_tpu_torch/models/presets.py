"""Named configurations ("model zoo") for common deployments (a copy of
the JAX package's ``models/presets.py``).

The reference exposes raw knobs (quality 0-10, arbitrary rates); production
users pick from a small set of named operating points.  Each preset bundles
quality + the launch sizing that hits its latency budget, with the filter
cost documented (quality_map, resample.c:226-238; latency getters
:1190-1198).
"""

from __future__ import annotations

import dataclasses
import math

from ..ops import filter_design as fd
from ..utils.errors import (QUALITY_DEFAULT, QUALITY_DESKTOP, QUALITY_MAX,
                            QUALITY_VOIP)

__all__ = ["Preset", "PRESETS", "get_preset", "describe"]


@dataclasses.dataclass(frozen=True)
class Preset:
    """An operating point: quality + per-launch audio budget.

    ``hard_latency`` makes target_chunk_ms a HARD cap on the engine's
    launch quantum (BatchedResampler/FleetResampler max_latency_ms): the
    geometry falls back to latency-optimal kernels instead of rounding the
    quantum up for kernel efficiency.  The voip preset uses it to guarantee
    its 20 ms availability budget at fleet scale."""
    name: str
    quality: int
    target_chunk_ms: float   # audio staged per launch (latency/thru tradeoff)
    description: str
    hard_latency: bool = False

    def target_chunk_frames(self, in_rate: int) -> int:
        return max(1, int(self.target_chunk_ms * in_rate / 1000))

    def engine_kwargs(self, in_rate: int) -> dict:
        kw = {"quality": self.quality,
              "target_chunk_frames": self.target_chunk_frames(in_rate)}
        if self.hard_latency:
            kw["max_latency_ms"] = self.target_chunk_ms
        return kw


PRESETS: dict[str, Preset] = {p.name: p for p in [
    Preset("voip", QUALITY_VOIP, 20.0,
           "interactive voice: Q3 (~80 dB stopband), hard 20 ms launches",
           hard_latency=True),
    Preset("desktop", QUALITY_DESKTOP, 50.0,
           "general playback: Q5 (~100 dB stopband), 50 ms launches"),
    Preset("default", 7, 100.0,
           "the reference JS wrapper's default: Q7, 100 ms launches"),
    Preset("mastering", QUALITY_MAX, 500.0,
           "offline/batch: Q10 (256-tap), widest launches for throughput"),
    Preset("serving", 7, 200.0,
           "high-throughput fleet serving: Q7, 200 ms launches"),
]}


def get_preset(name: str) -> Preset:
    try:
        return PRESETS[name]
    except KeyError:
        raise KeyError(f"unknown preset {name!r}; "
                       f"available: {sorted(PRESETS)}") from None


def describe(name: str, in_rate: int, out_rate: int) -> dict:
    """Resolved operating parameters for a preset at a concrete rate pair."""
    p = get_preset(name)
    g = math.gcd(in_rate, out_rate)
    spec = fd.design_filter(in_rate // g, out_rate // g, p.quality)
    return {
        "preset": p.name,
        "quality": p.quality,
        "ratio": f"{spec.num}/{spec.den}",
        "filter_taps": spec.filt_len,
        "path": "direct" if spec.use_direct else "interpolated",
        "input_latency_ms": spec.input_latency / in_rate * 1000,
        "output_latency_ms": spec.output_latency / out_rate * 1000,
        "launch_ms": p.target_chunk_ms,
        "hard_latency": p.hard_latency,
        "target_chunk_frames": p.target_chunk_frames(in_rate),
    }
