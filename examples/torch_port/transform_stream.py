"""Ragged byte streams through SpeexResamplerTransform, on the PyTorch port.

The reference's Node Transform stream re-aligns arbitrarily split byte
chunks to whole frames with a carry buffer (src/index.ts:139-161).  This
demo pushes deliberately misaligned chunks (including 1-byte ones) through
the sync API, then the same stream through the asyncio API, and checks the
two agree byte-for-byte.

    python examples/torch_port/transform_stream.py [--device cuda|cpu]
"""

import argparse
import asyncio
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

from speex_resampler_tpu_torch import SpeexResamplerTransform

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


IN_RATE, OUT_RATE, CHANNELS, QUALITY = 24000, 48000, 1, 5


def ragged_chunks(data: bytes, seed: int = 0):
    rng = np.random.default_rng(seed)
    i = 0
    while i < len(data):
        n = int(rng.integers(1, 4097))
        yield data[i:i + n]
        i += n


def main() -> None:
    device = parse_device()
    t = np.arange(IN_RATE // 4) / IN_RATE
    pcm = np.round(0.4 * 32767 * np.sin(2 * np.pi * 330 * t)).astype(
        np.int16).tobytes()

    # sync push style: transform() returns whatever is producible now
    tf = SpeexResamplerTransform(CHANNELS, IN_RATE, OUT_RATE, QUALITY,
                                 device=device)
    out_sync = b"".join(tf.transform(c) for c in ragged_chunks(pcm))
    out_sync += tf.flush()

    # asyncio style, same ragged schedule
    async def run_async() -> bytes:
        tf = SpeexResamplerTransform(CHANNELS, IN_RATE, OUT_RATE, QUALITY,
                                     device=device)
        parts = [await tf.atransform(c) for c in ragged_chunks(pcm)]
        parts.append(tf.flush())
        return b"".join(parts)

    out_async = asyncio.run(run_async())
    assert out_sync == out_async, "sync and asyncio paths must agree"

    in_s = len(pcm) / (CHANNELS * 2) / IN_RATE
    out_s = len(out_sync) / (CHANNELS * 2) / OUT_RATE
    print(f"in {in_s:.4f}s -> out {out_s:.4f}s across "
          f"{sum(1 for _ in ragged_chunks(pcm))} ragged chunks")
    assert abs(in_s - out_s) < 0.01, "duration invariant violated"
    print("ok")


if __name__ == "__main__":
    main()
