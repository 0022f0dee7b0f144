"""Where a FleetResampler launch's host time goes, on one GPU machine.

    python3 tools/fleet_host_probe.py

At the flagship launch (1024 stereo streams, 9408 frames in and 10240 out
a lane: 38.5 MB in, 41.9 MB out) it prints:

- the machine's CPU count;
- for the native stager's thread pool at its default size and at 1, 2, 4,
  8 and 16 threads: the median ms of one lane-major gather
  (``fill_launch_lm`` into a pinned slab) and of one unpack
  (``unpack_all_lm`` of a pinned [B, 10240] buffer) into a new array, as
  the fleet banks it, and into one array reused (its pages already
  touched);
- the ms to fill a new 41.9 MB array (first touch of its pages) and to
  rewrite one already touched;
- steady ``poll()`` of 8 launches at pipeline depths 1, 2, 1, 2, 3 in
  turn (fresh fleets, after a warm-up poll of two), with the per-phase
  host ms a launch of ``stats``.

Needs a CUDA device; prints the card's name and power limit.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from speex_resampler_tpu_torch import FleetResampler  # noqa: E402
from speex_resampler_tpu_torch.runtime.native import NativeStager  # noqa
from speex_resampler_tpu_torch.utils.profiling import LaunchStats  # noqa

S, C, Q, N_OUT = 1024, 2, 9408, 10240


def median_ms(fn, reps: int = 7) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("fleet_host_probe: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}; cpus {os.cpu_count()}, "
          f"{len(os.sched_getaffinity(0))} usable")
    rng = np.random.default_rng(0)
    block = rng.integers(-32768, 32768, (S, Q, C), dtype=np.int16)
    y = torch.empty((S * C, N_OUT), dtype=torch.int16, pin_memory=True)
    y.numpy()[:] = rng.integers(-32768, 32768, (S * C, N_OUT),
                                dtype=np.int16)
    rows = 14112                           # the flagship step's chunk_rows
    slab = torch.zeros((S * C, rows), dtype=torch.int16,
                       pin_memory=True).numpy()
    for threads in (None, 1, 2, 4, 8, 16):
        st = NativeStager(S, C, Q)
        if threads:
            st.set_threads(threads)
        reused = np.empty((S, N_OUT, C), dtype=np.int16)

        def gather():
            for s in range(S):
                st.push(s, block[s])
            t0 = time.perf_counter()
            st.fill_launch_lm(slab)
            return time.perf_counter() - t0

        g = float(np.median([gather() for _ in range(5)])) * 1e3
        new = median_ms(lambda: st.unpack_all_lm(y.numpy()))
        old = median_ms(lambda: st.unpack_all_lm(y.numpy(), out=reused))
        print(f"threads {threads or 'default'}: gather {g:.2f} ms, unpack "
              f"into a new array {new:.2f} ms, into a reused one "
              f"{old:.2f} ms")
    touched = np.empty((S, N_OUT, C), dtype=np.int16)
    touched.fill(0)
    first = median_ms(lambda: np.empty((S, N_OUT, C), np.int16).fill(1))
    again = median_ms(lambda: touched.fill(1))
    print(f"fill of a new 41.9 MB array {first:.2f} ms, of a touched one "
          f"{again:.2f} ms")
    for depth in (1, 2, 1, 2, 3):
        fleet = FleetResampler(S, C, 44100, 48000, 7,
                               target_chunk_frames=Q, pipeline_depth=depth)

        def feed(k):
            for _ in range(k):
                for s in range(S):
                    fleet.push(s, block[s])

        feed(2)
        fleet.poll()
        fleet.stats = LaunchStats()
        feed(8)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ran = fleet.poll()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        if ran != 8 or fleet.degraded:
            raise AssertionError(f"{ran} launches, degraded "
                                 f"{fleet.degraded}")
        print(f"poll() depth {depth} on {smi}: {wall / 8:.2f} ms a launch; "
              f"host ms a launch {fleet.stats.phase_ms_per_launch()}")
        del fleet


if __name__ == "__main__":
    main()
