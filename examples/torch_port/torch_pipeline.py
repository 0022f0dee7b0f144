"""Embedding the resampler inside your own torch pipeline.

The stateful engines own staging and accounting; the functional API
(speex_resampler_tpu_torch.functional) gives the underlying PURE step so
resampling can be one stage of a larger device pipeline: here a toy
feature extractor, resample 44.1 kHz -> 48 kHz, then window energies.  On
a card the whole stage is captured in ONE CUDA graph and replayed a
quantum at a time (the counterpart of the JAX package's one jax.jit); on
the CPU it runs eagerly.  Replays equal the eager stage bit for bit.

    python examples/torch_port/torch_pipeline.py [--device cuda|cpu]
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

from speex_resampler_tpu_torch.functional import (make_stream_fn,
                                                   resample_array)

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


B = 8  # lanes (streams x channels)


def main() -> None:
    device = parse_device()
    rs = make_stream_fn(44100, 48000, quality=7, target_in_frames=1024,
                        device=device)
    print(f"quantum: {rs.in_frames} in -> {rs.out_frames} out frames, "
          f"scheme={rs.scheme}")

    def pipeline(hist, pcm):
        hist, y = rs.step(hist, pcm)              # resample
        f = y.float() / 32768.0
        win = f[: (f.shape[0] // 256) * 256].reshape(-1, 256, B)
        energy = win.square().mean(1)             # per-window energy
        return hist, y, energy

    rng = np.random.default_rng(2)
    quanta = [torch.from_numpy(rng.integers(-25000, 25000,
                                            (rs.in_frames, B),
                                            dtype=np.int16)).to(device)
              for _ in range(4)]
    hist = rs.init(B)
    eager = []
    for pcm in quanta:
        hist, y, energy = pipeline(hist, pcm)
        eager.append((y, energy))
    n_out = sum(y.shape[0] for y, _ in eager)

    if device != "cpu":
        # one CUDA graph: static hist and pcm buffers, the history carried
        # in place; warm up on a side stream first
        hist, pcm = rs.init(B), quanta[0].clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            pipeline(hist, pcm)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            h2, y, energy = pipeline(hist, pcm)
            hist.copy_(h2)
        for q, (y_e, e_e) in zip(quanta, eager):
            pcm.copy_(q)
            graph.replay()
            assert torch.equal(y, y_e) and torch.equal(energy, e_e), \
                "graph replay must equal the eager stage"
        print("4 graph replays: bit-identical with the eager stage")
    print(f"4 quanta: {4 * rs.in_frames} in -> {n_out} out frames, "
          f"energy grid {tuple(eager[-1][1].shape)}")
    assert abs(n_out / 48000 - 4 * rs.in_frames / 44100) < 0.01

    # one-shot convenience for finite signals (host API)
    tone = np.round(0.5 * 32767 * np.sin(
        2 * np.pi * 440 * np.arange(22050) / 44100)).astype(np.int16)
    out = resample_array(tone, 44100, 48000, quality=7, device=device)
    assert abs(len(out) / 48000 - len(tone) / 44100) < 0.01
    print(f"one-shot: {len(tone)} -> {len(out)} samples")
    print("ok")


if __name__ == "__main__":
    main()
