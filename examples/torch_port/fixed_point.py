"""The FIXED_POINT (Q15) universe, on the port.

The reference is a dual numeric build (arch.h:39-67): the shipped WASM is
the float build, but `-DFIXED_POINT` selects int16 samples with Q15
integer hot loops.  Both universes exist here; the fixed one is BIT-EXACT
against the JAX package (wrapping int32 sums are order-independent, so
the int8 tensor-core formulation is exact by construction).

This demo resamples the same signal through both universes and shows they
are close but intentionally NOT identical (different numeric contracts),
then serves the fixed universe through BatchedResampler on ``--device``
(the fixed kernel) and checks it against the single-stream fixed core
bit for bit.

    python examples/torch_port/fixed_point.py [--device cuda|cpu]
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

from speex_resampler_tpu_torch import BatchedResampler, SpeexResampler

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


def run(fixed_point: bool, pcm: bytes, device: str) -> np.ndarray:
    r = SpeexResampler(CHANNELS, IN_RATE, OUT_RATE, QUALITY,
                       fixed_point=fixed_point, device=device)
    out = r.process_chunk(pcm)
    return np.frombuffer(out, dtype=np.int16)


def main() -> None:
    device = parse_device()
    t = np.arange(IN_RATE // 5) / IN_RATE
    tone = np.round(0.5 * 32767 * np.sin(2 * np.pi * 1000 * t)).astype(
        np.int16)

    y_float = run(False, tone.tobytes(), device)
    y_fixed = run(True, tone.tobytes(), device)

    n = min(len(y_float), len(y_fixed))
    diff = np.abs(y_float[:n].astype(np.int32) - y_fixed[:n])
    print(f"float build: {len(y_float)} samples; "
          f"fixed build: {len(y_fixed)} samples")
    print(f"max |float - fixed| = {diff.max()} LSB "
          f"(different builds, same filter design)")
    # the two universes implement the same filter; outputs track closely
    assert diff.max() < 64, "universes diverged beyond filter tolerance"

    # the batched engine's fixed kernel, four copies of the stream
    eng = BatchedResampler(4, CHANNELS, IN_RATE, OUT_RATE, QUALITY,
                           target_chunk_frames=1024, fixed_point=True,
                           device=device)
    frames = np.repeat(tone[None, :, None], 4, axis=0)
    y = np.concatenate([eng.process(frames), eng.flush()], axis=1)
    m = y.shape[1]
    assert 0 < m <= len(y_fixed) and all(
        np.array_equal(y[s, :, 0], y_fixed[:m]) for s in range(4)), \
        "batched fixed engine must equal the single-stream fixed core"
    print(f"batched fixed engine ({eng._step.scheme}, {eng.launches} "
          f"launches on {device}): {m} samples a stream, bit-identical")
    print("ok")


if __name__ == "__main__":
    main()
