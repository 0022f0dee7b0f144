"""Many lockstep streams in one device launch: BatchedResampler on the port.

The reference scales by one resampler state per stream (Readme.md:20-21);
here S streams x C channels become S*C lanes of a single kernel launch
per quantum.  This demo runs 8 streams, checkpoints the engine
mid-stream, replays the second half on a restored copy and on an engine
whose lanes are split over a two-shard mesh (``mesh=[device] * 2``), and
checks the outputs agree bit-for-bit.

    python examples/torch_port/batched_streams.py [--device cuda|cpu]
"""

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

# runnable from a raw checkout: fall back to the repo root if the package
# is not installed
try:
    import speex_resampler_tpu_torch  # noqa: F401
except ImportError:  # pragma: no cover
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from speex_resampler_tpu_torch import BatchedResampler

IN_RATE, OUT_RATE, CHANNELS, QUALITY = 44100, 48000, 2, 7


def parse_device() -> str:
    """``--device`` ("cuda" by default); without a card, "cuda" exits
    with an error rather than running on the CPU."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help='"cuda" or "cpu"')
    device = ap.parse_args().device
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        sys.exit(f"{Path(__file__).name}: no CUDA device (--device cpu "
                 f"runs the plain versions on the CPU)")
    return device


S, CHANNELS, IN_RATE, OUT_RATE, QUALITY = 8, 2, 44100, 48000, 7


def main() -> None:
    device = parse_device()
    rng = np.random.default_rng(1)
    eng = BatchedResampler(S, CHANNELS, IN_RATE, OUT_RATE, QUALITY,
                           target_chunk_frames=1024, device=device)
    print(f"launch quantum: {eng.in_frames_per_launch} in-frames -> "
          f"{eng.out_frames_per_launch} out-frames "
          f"({eng.launch_latency_ms:.1f} ms of audio)")

    first = rng.integers(-30000, 30000, (S, 4000, CHANNELS), dtype=np.int16)
    second = rng.integers(-30000, 30000, (S, 3000, CHANNELS), dtype=np.int16)

    out1 = eng.process(first)
    snap = eng.state_dict()              # checkpoint mid-stream

    out2 = eng.process(second)
    tail = eng.flush()

    # restore the checkpoint into a FRESH engine and into one whose lanes
    # are split over two shards, and replay the second half on both
    for kw in (dict(device=device), dict(mesh=[device] * 2)):
        eng2 = BatchedResampler(S, CHANNELS, IN_RATE, OUT_RATE, QUALITY,
                                target_chunk_frames=1024, **kw)
        eng2.load_state_dict(snap)
        out2b = eng2.process(second)
        tail_b = eng2.flush()
        assert np.array_equal(out2, out2b) and np.array_equal(tail, tail_b), \
            f"checkpoint replay ({kw}) must be bit-identical"

    n_in = first.shape[1] + second.shape[1]
    n_out = out1.shape[1] + out2.shape[1] + tail.shape[1]
    in_s, out_s = n_in / IN_RATE, n_out / OUT_RATE
    print(f"{S} streams: in {in_s:.4f}s -> out {out_s:.4f}s each "
          f"(scheme {eng._step.scheme}, {eng.launches} launches)")
    assert abs(in_s - out_s) < 0.01, "duration invariant violated"
    print("ok")


if __name__ == "__main__":
    main()
