"""One stream through the reference-compatible API, on the PyTorch port.

Mirrors the reference's basic usage (Readme.md "Usage", src/index.ts:50):
interleaved s16 PCM bytes in -> resampled s16 PCM bytes out, with the
filter state carried across calls.  The default route (the native host
loops, bit-identical to the reference float build) and the device route
(one f32 matmul a call on ``--device``) are both run and agree within 1
LSB.

    python examples/torch_port/single_stream.py [--device cuda|cpu]
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

from speex_resampler_tpu_torch import SpeexResampler

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


def make_tone(rate: int, seconds: float, channels: int) -> np.ndarray:
    t = np.arange(int(rate * seconds)) / rate
    wave = 0.5 * np.sin(2 * np.pi * 440.0 * t)
    pcm = np.round(wave * 32767).astype(np.int16)
    return np.repeat(pcm[:, None], channels, axis=1)


def stream(resampler: SpeexResampler, frames: np.ndarray) -> bytes:
    # optional: swallow the filter's leading delay, like
    # speex_resampler_skip_zeros (resample.c:1200-1206)
    resampler.skip_zeros()
    out = bytearray()
    # stream in 20 ms chunks; any chunk size that is a whole number of
    # frames (channels*2 bytes) is legal
    step = int(IN_RATE * 0.020)
    for i in range(0, frames.shape[0], step):
        out += resampler.process_chunk(frames[i:i + step].tobytes())
    return bytes(out)


def main() -> None:
    device = parse_device()
    frames = make_tone(IN_RATE, 0.25, CHANNELS)
    resampler = SpeexResampler(CHANNELS, IN_RATE, OUT_RATE, QUALITY,
                               device=device)
    out = stream(resampler, frames)
    dev = stream(SpeexResampler(CHANNELS, IN_RATE, OUT_RATE, QUALITY,
                                engine="device", device=device), frames)
    a, b = (np.frombuffer(o, dtype=np.int16).astype(np.int32)
            for o in (out, dev))
    assert len(a) == len(b) and np.abs(a - b).max() <= 1, \
        "host and device routes must agree within 1 LSB"

    in_s = frames.shape[0] / IN_RATE
    out_s = len(out) / (CHANNELS * 2) / OUT_RATE
    print(f"in  {frames.shape[0]} frames @ {IN_RATE} Hz = {in_s:.4f}s")
    print(f"out {len(out) // (CHANNELS * 2)} frames @ {OUT_RATE} Hz = "
          f"{out_s:.4f}s (device route on {device}: max |diff| "
          f"{np.abs(a - b).max()} LSB)")
    print(f"input latency  {resampler.get_input_latency()} samples, "
          f"output latency {resampler.get_output_latency()} samples")
    assert abs(in_s - out_s) < 0.01, "duration invariant violated"
    print("ok")


if __name__ == "__main__":
    main()
