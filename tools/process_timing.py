"""``BatchedResampler.process()`` wall times at two served configs, for one
checkout of the port, on one GPU machine.

    python3 tools/process_timing.py [--root DIR] [--label NAME]

Imports ``speex_resampler_tpu_torch`` from ``--root`` (default: this
checkout), so an earlier commit unpacked with ``git archive <commit> |
tar -x -C build/parent`` is timed with ``--root build/parent``; run
parent, change, change, parent in one call to compare two commits on one
card.  For the flagship (44.1 kHz -> 48 kHz q7, 9408-frame quanta) and
the streamed slice (48 kHz -> 44.1 kHz q10, 20480-frame quanta), 1024
stereo streams, ``scheme="auto"`` (int8): the median of 10 calls of one
quantum and of 5 calls of four quanta, after one call each, by the host
clock (``process`` returns host arrays, so the device work is inside).
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve()
                                          .parent.parent))
    ap.add_argument("--label", default="this checkout")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    from speex_resampler_tpu_torch import BatchedResampler
    if not torch.cuda.is_available():
        sys.exit("process_timing: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    rng = np.random.default_rng(3)
    for rates, q, target in (((44100, 48000, 7), 9408, 9408),
                             ((48000, 44100, 10), 20480, 20480)):
        eng = BatchedResampler(1024, 2, *rates, target_chunk_frames=target)
        if eng.in_frames_per_launch != q:
            raise AssertionError(f"quantum {eng.in_frames_per_launch}")
        frames = rng.integers(-32768, 32768, (1024, 4 * q, 2),
                              dtype=np.int16)
        out = []
        for quanta, reps in ((1, 10), (4, 5)):
            x = frames[:, :quanta * q]
            eng.process(x)
            walls = []
            for _ in range(reps):
                t0 = time.perf_counter()
                eng.process(x)
                walls.append(time.perf_counter() - t0)
            out.append(float(np.median(walls)) * 1e3)
        print(f"{args.label}: {rates[0]}->{rates[1]} q{rates[2]} "
              f"{eng._step.scheme} on {smi}: process() of one quantum "
              f"{out[0]:.2f} ms, of four {out[1]:.2f} ms")


if __name__ == "__main__":
    main()
