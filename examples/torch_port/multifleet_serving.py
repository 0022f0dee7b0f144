"""Heterogeneous fleet serving with exact mid-stream rate switches, on the
port.

MultiFleet buckets streams by (in_rate, out_rate, quality), each bucket
one lockstep FleetResampler, with dynamic attach/detach and EXACT
per-stream drains (a stream leaving mid-quantum hands its lane state to a
single-stream core, so no output is lost or fabricated).  A mid-stream
set_stream_rate migrates the filter state through magic samples exactly
like the C core's update_filter (resample.c:727-782).

    python examples/torch_port/multifleet_serving.py [--device cuda|cpu]
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

from speex_resampler_tpu_torch.runtime import MultiFleet

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


CHANNELS = 2


def main() -> None:
    device = parse_device()
    rng = np.random.default_rng(11)
    mf = MultiFleet(CHANNELS, capacity_per_bucket=8,
                    target_chunk_frames=512, device=device)

    # three streams, two different configs -> two buckets
    mf.add_stream("music", 44100, 48000, quality=7)
    mf.add_stream("voice", 16000, 48000, quality=5)
    mf.add_stream("aux", 44100, 48000, quality=7)

    out = {sid: 0 for sid in ("music", "voice", "aux")}
    pushed = {sid: 0 for sid in out}

    def push_some(sid, n):
        frames = rng.integers(-20000, 20000, (n, CHANNELS), dtype=np.int16)
        mf.push(sid, frames)
        pushed[sid] += n

    for _ in range(6):
        push_some("music", int(rng.integers(500, 3000)))
        push_some("voice", int(rng.integers(200, 1200)))
        push_some("aux", int(rng.integers(500, 3000)))
        mf.poll()
        for sid in out:
            out[sid] += mf.pull(sid).shape[0]

    # live reconfiguration: "voice" upgrades 16k->48k to 24k->48k.  The
    # filter state migrates exactly; the stream keeps flowing.
    mf.set_stream_rate("voice", 24000, 48000)
    for _ in range(4):
        push_some("voice", int(rng.integers(200, 1200)))
        mf.poll()
        out["voice"] += mf.pull("voice").shape[0]

    # detach one stream early; the others are unaffected
    mf.end_stream("aux")
    out["aux"] += mf.pull("aux").shape[0]

    for sid in ("music", "voice"):
        mf.end_stream(sid)
        out[sid] += mf.pull(sid).shape[0]

    print(f"bucket stats: {list(mf.stats())}")
    for sid in out:
        print(f"  {sid}: pushed {pushed[sid]} frames -> {out[sid]} out")
    # every stream's full output was delivered despite bucketing, the rate
    # switch, and early detach (the exact counts are pinned in
    # tests/test_torch_multifleet.py against the JAX package's MultiFleet)
    assert all(out[sid] > 0 for sid in out)
    assert not mf.degraded
    print("ok")


if __name__ == "__main__":
    main()
