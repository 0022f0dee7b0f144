"""``BatchedResampler.process()`` wall times at served configs, for one
checkout of the port, on one GPU machine.

    python3 tools/process_timing.py [--root DIR] [--label NAME]
                                    [--configs flagship,slice,...]
                                    [--step] [--single]

Imports ``speex_resampler_tpu_torch`` from ``--root`` (default: this
checkout), so an earlier commit unpacked with ``git archive <commit> |
tar -x -C build/parent`` is timed with ``--root build/parent``; run
parent, change, change, parent in one call to compare two commits on one
card.  1024 stereo streams, ``scheme="auto"``, at each of ``--configs``
(default ``flagship,slice``): the flagship (44.1 kHz -> 48 kHz q7,
9408-frame quanta: int8), the streamed slice (48 kHz -> 44.1 kHz q10,
20480-frame quanta: int8), clock drift (44.1 kHz -> 44.101 kHz q7,
44100-frame quanta: the gather geometry) float and fixed (``drift``,
``drift-fixed``), and the voip preset's 20 ms cap (44.1 kHz -> 48 kHz q3,
882-frame quanta: the dense geometry) float and fixed (``voip``,
``voip-fixed``).  The median of 10 calls of one quantum and of 5 calls of
four quanta, after one call each, by the host clock (``process`` returns
host arrays, so the device work is inside).

With ``--single``, the single-stream device route at clock drift
instead (``SpeexResampler(c, 44100, 44101, 7, engine="device")``: the
gather route of ``ResamplerCore``, plan and taps made on the host each
call): 10 s of seeded PCM at 2, 8 and 64 channels, in 1024-frame
``process_chunk`` calls and in one shot, the median of 5 runs after one,
by the host clock, ms a run.

With ``--step``, also the engine's step alone (``eng._step.fn`` on random
launch buffers of 2048 lanes: everything one launch puts on the card, the
kernel and the next history, and whatever else the step does around
them), by CUDA events: 20 calls back to back, and a CUDA graph of 20
calls replayed, ms a call.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# name -> (in rate, out rate, quality, engine keywords, quantum)
CONFIGS = {
    "flagship": (44100, 48000, 7, dict(target_chunk_frames=9408), 9408),
    "slice": (48000, 44100, 10, dict(target_chunk_frames=20480), 20480),
    "drift": (44100, 44101, 7, dict(target_chunk_frames=44100), 44100),
    "drift-fixed": (44100, 44101, 7, dict(target_chunk_frames=44100,
                                          fixed_point=True), 44100),
    "voip": (44100, 48000, 3, dict(max_latency_ms=20), 882),
    "voip-fixed": (44100, 48000, 3, dict(max_latency_ms=20,
                                         fixed_point=True), 882),
}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve()
                                          .parent.parent))
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--configs", default="flagship,slice")
    ap.add_argument("--step", action="store_true")
    ap.add_argument("--single", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    from speex_resampler_tpu_torch import BatchedResampler
    if not torch.cuda.is_available():
        sys.exit("process_timing: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    if args.single:
        single_ms(args.label, smi)
        return
    rng = np.random.default_rng(3)
    for name in args.configs.split(","):
        i, o, q, kw, quantum = CONFIGS[name]
        eng = BatchedResampler(1024, 2, i, o, q, **kw)
        if eng.in_frames_per_launch != quantum:
            raise AssertionError(f"quantum {eng.in_frames_per_launch}")
        frames = rng.integers(-32768, 32768, (1024, 4 * quantum, 2),
                              dtype=np.int16)
        out = []
        for quanta, reps in ((1, 10), (4, 5)):
            x = frames[:, :quanta * quantum]
            eng.process(x)
            walls = []
            for _ in range(reps):
                t0 = time.perf_counter()
                eng.process(x)
                walls.append(time.perf_counter() - t0)
            out.append(float(np.median(walls)) * 1e3)
        print(f"{args.label}: {name} {i}->{o} q{q} {eng._step.kernel} "
              f"{eng._step.scheme} on {smi}: process() of one quantum "
              f"{out[0]:.2f} ms, of four {out[1]:.2f} ms")
        if args.step:
            eager, graph = step_ms(torch, eng._step, eng.bspec.in_per_launch)
            print(f"{args.label}: {name} step alone: back to back "
                  f"{eager:.4f} ms, graph {graph:.4f} ms a call")


def single_ms(label: str, smi: str, seconds: int = 10,
              chunk: int = 1024, reps: int = 5) -> None:
    """The single-stream drift route, chunked and one shot (``--single``)."""
    from speex_resampler_tpu_torch import SpeexResampler
    for c in (2, 8, 64):
        pcm = np.random.default_rng(c).integers(
            -32768, 32768, (seconds * 44100, c), dtype=np.int16).tobytes()
        step = chunk * c * 2
        for frames in (chunk, 0):
            def run():
                r = SpeexResampler(c, 44100, 44101, 7, engine="device",
                                   device="cuda")
                if not frames:
                    return r.process_chunk(pcm)
                return b"".join(r.process_chunk(pcm[a:a + step])
                                for a in range(0, len(pcm), step))
            run()
            walls = []
            for _ in range(reps):
                t0 = time.perf_counter()
                run()
                walls.append(time.perf_counter() - t0)
            what = f"chunks of {frames}" if frames else "one shot"
            print(f"{label}: single-stream {c}ch 44100->44101 q7 device "
                  f"route, {seconds} s in {what} on {smi}: "
                  f"{float(np.median(walls)) * 1e3:.2f} ms")


def step_ms(torch, step, n_in: int, lanes: int = 2048, reps: int = 20):
    """(back to back, graph replay) ms of one call of ``step.fn``."""
    gen = torch.Generator(device="cuda").manual_seed(5)

    def samples(rows):
        return torch.randint(-32768, 32768, (rows, lanes), generator=gen,
                             dtype=torch.int16, device="cuda")

    hist = samples(step.hist_rows)
    x = torch.zeros((step.chunk_rows, lanes), dtype=torch.int16,
                    device="cuda")
    x[:n_in] = samples(n_in)

    def run():
        return step.fn(hist, x, step.w)

    def timed(fn):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    def queue():
        for _ in range(reps):
            run()

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    eager = timed(queue) / reps
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        queue()
    graph.replay()
    replay = timed(graph.replay) / reps
    del graph
    torch.cuda.synchronize()
    return eager, replay


if __name__ == "__main__":
    main()
