"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``speex_resampler_tpu_torch/csrc``,
holds each kernel against its plain PyTorch version on the card, serves
the flagship (44.1 kHz -> 48 kHz, quality 7, 1024 stereo streams, B = 2048
lanes) through ``BatchedResampler.process``/``flush`` and checks streams
0-3 against a CPU engine, then times kernel and plain version at the
flagship launch.  Every phase raises on failure (non-zero exit).  The last
two lines of standard output are the kernels' JSON summary and
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
without a CUDA device or outside a checkout of the repository.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from speex_resampler_tpu_torch import BatchedResampler
from speex_resampler_tpu_torch.ops import _build, phase as ph
from speex_resampler_tpu_torch.ops import filter_design as fd
from speex_resampler_tpu_torch.ops import tiled_fir as tf
from speex_resampler_tpu_torch.parallel import batch as tb

NUM, DEN, QUALITY = 147, 160, 7          # 44100 -> 48000, reduced
STREAMS, CHANNELS, TARGET = 1024, 2, 9408
# ragged process() calls: 41000 frames = 4 launches of 9408 + 3368 staged
SERVE_FRAMES = (12000, 9000, 20000)
AFTER_FLUSH_FRAMES = 10000
SOURCE = "speex_resampler_tpu_torch/csrc/tiled_fir.cu"
REPLACES = "speex_resampler_tpu/ops/pallas_fir.py:341"
KERNEL_NAMES = {"int8": "tiled_fir_int8_kernel",
                "highest": "tiled_fir_f32_kernel"}


def lsb_tie_limit(n: int, rate: float = 5e-3) -> float:
    """Poisson tie bound of the LSB contract (tests/conftest.py)."""
    lam = rate * n
    return lam + 4.0 * float(np.sqrt(lam * (1.0 - rate))) + 2.0


def compare(got: np.ndarray, want: np.ndarray, scheme: str, what: str):
    """int8: bit-identical.  highest: max |err| <= 1 within the tie bound
    (f32 sums in another order).  Returns (max |err|, mismatches)."""
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {got.shape} != {want.shape}")
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    err = int(d.max()) if d.size else 0
    mism = int((d > 0).sum())
    if scheme == "int8" and mism:
        raise AssertionError(f"{what}: {mism} int8 mismatches")
    if err > 1 or mism > lsb_tie_limit(d.size):
        raise AssertionError(f"{what}: max|err| {err}, {mism} ties of "
                             f"{d.size}")
    return err, mism


def launch_inputs(step, n_in: int, B: int, seed: int):
    """Random history and chunk on the card, zero past the chunk."""
    rng = np.random.default_rng(seed)
    hist = rng.integers(-32768, 32768, (step.hist_rows, B), dtype=np.int16)
    x = np.zeros((step.chunk_rows, B), dtype=np.int16)
    x[:n_in] = rng.integers(-32768, 32768, (n_in, B), dtype=np.int16)
    return (torch.from_numpy(hist).cuda(), torch.from_numpy(x).cuda())


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median of per-launch CUDA-event times, after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def serve(scheme: str, frames: list, f0_after: int):
    """Drive the flagship engine; returns (engine, outputs per call)."""
    eng = BatchedResampler(STREAMS, CHANNELS, 44100, 48000, QUALITY,
                           target_chunk_frames=TARGET, device="cuda",
                           scheme=scheme)
    outs = [eng.process(f) for f in frames[:3]]
    outs.append(eng.flush())
    if eng._f0 != f0_after:
        raise AssertionError(f"flush left f0 {eng._f0}, expected {f0_after}")
    outs.append(eng.process(frames[3]))
    torch.cuda.synchronize()
    return eng, outs


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    t_start = time.time()
    # -- phase 1: the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- phase 2: build the kernels from the checkout
    t0 = time.time()
    _build.load()
    print(f"build: {time.time() - t0:.1f} s ({_build.build_dir()})")
    for log in sorted(_build.build_dir().glob("*.log")):
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas: {line.strip()}")

    # -- phase 3: kernel against plain, both on the card
    spec = fd.design_filter(NUM, DEN, QUALITY)
    staged = sum(SERVE_FRAMES) % TARGET
    m = ph.producible_outputs(staged, 0, 0, NUM, DEN)
    f0_flush = (m * NUM) % DEN
    max_err = {"int8": 0, "highest": 0}
    for scheme in ("int8", "highest"):
        for f0 in (0, f0_flush):
            bspec = tb._launch_geometry(spec, TARGET, f0=f0)
            step = tb.make_batched_step(spec, bspec, device="cuda",
                                        scheme=scheme)
            for B in (STREAMS * CHANNELS, 130):
                hist, x = launch_inputs(step, bspec.in_per_launch, B,
                                        seed=B + f0)
                got = tf.resample_tiled(hist, x, step.w, **step.kernel_kw)
                want = tf.resample_tiled_reference(hist, x, step.w,
                                                   **step.kernel_kw)
                torch.cuda.synchronize()
                err, mism = compare(got.cpu().numpy(), want.cpu().numpy(),
                                    scheme, f"{scheme} f0={f0} B={B}")
                max_err[scheme] = max(max_err[scheme], err)
                print(f"kernel vs plain: {scheme:7s} f0={f0:3d} B={B:4d} "
                      f"n_blocks={bspec.n_blocks} max|err|={err} "
                      f"mismatches={mism}")

    # -- phase 4: the slice end to end
    rng = np.random.default_rng(2024)
    frames = [rng.integers(-32768, 32768, (STREAMS, n, CHANNELS),
                           dtype=np.int16)
              for n in SERVE_FRAMES + (AFTER_FLUSH_FRAMES,)]
    tf.launches.update(int8=0, highest=0)
    t0 = time.time()
    eng8, outs8 = serve("auto", frames, f0_flush)
    t_serve = time.time() - t0
    engh, outsh = serve("highest", frames, f0_flush)
    counts = dict(tf.launches)
    if eng8._step.scheme != "int8" or eng8._step.w[0].shape[0] != 3:
        raise AssertionError(f"auto resolved {eng8._step.scheme}, "
                             f"D={eng8._step.w[0].shape[0]}")
    if eng8.launches < 5 or counts["int8"] != eng8.launches \
            or counts["highest"] != engh.launches:
        raise AssertionError(f"kernel launches {counts} vs engine "
                             f"{eng8.launches}/{engh.launches}")
    for scheme, outs in (("int8", outs8), ("highest", outsh)):
        ref = BatchedResampler(4, CHANNELS, 44100, 48000, QUALITY,
                               target_chunk_frames=TARGET, device="cpu",
                               scheme=scheme)
        want = [ref.process(f[:4]) for f in frames[:3]]
        want.append(ref.flush())
        want.append(ref.process(frames[3][:4]))
        for i, (g, w) in enumerate(zip(outs, want)):
            if g.shape[0] != STREAMS or g.shape[2] != CHANNELS:
                raise AssertionError(f"call {i}: output shape {g.shape}")
            err, mism = compare(g[:4], w, scheme, f"{scheme} call {i}")
            print(f"serve {scheme:7s} call {i}: out {tuple(g.shape)} "
                  f"streams 0-3 vs cpu max|err|={err} mismatches={mism}")
    print(f"serve: scheme auto -> int8 D=3, {eng8.launches} launches, "
          f"{t_serve:.2f} s for {sum(SERVE_FRAMES) + AFTER_FLUSH_FRAMES} "
          f"frames x {STREAMS * CHANNELS} lanes (engine construction, "
          f"host staging and pageable copies included)")

    # -- phase 5: timing at the flagship launch
    bspec = tb._launch_geometry(spec, TARGET)
    out_samples = bspec.out_per_launch * STREAMS * CHANNELS
    kernels = []
    for scheme in ("int8", "highest"):
        step = tb.make_batched_step(spec, bspec, device="cuda",
                                    scheme=scheme)
        hist, x = launch_inputs(step, bspec.in_per_launch,
                                STREAMS * CHANNELS, seed=7)
        ms = cuda_ms(lambda: tf.resample_tiled(hist, x, step.w,
                                               **step.kernel_kw), 30)
        plain_ms = cuda_ms(lambda: tf.resample_tiled_reference(
            hist, x, step.w, **step.kernel_kw), 20)
        print(f"timing {scheme:7s} on {smi}: kernel {ms:.4f} ms/launch "
              f"({out_samples / ms / 1e6:.2f} G out samples/s), plain "
              f"{plain_ms:.4f} ms/launch "
              f"({out_samples / plain_ms / 1e6:.2f} G out samples/s)")
        kernels.append({"name": KERNEL_NAMES[scheme], "route": "cuda",
                        "source": SOURCE, "replaces": REPLACES,
                        "launches": counts[scheme],
                        "max_abs_err": max_err[scheme], "ms": ms,
                        "plain_ms": plain_ms})
    # one steady-state process() call per launch quantum, host included
    quantum = frames[0][:, :TARGET]
    for eng in (eng8, engh):
        eng.process(quantum)
        walls = []
        for _ in range(10):
            t0 = time.perf_counter()
            eng.process(quantum)
            walls.append(time.perf_counter() - t0)
        wall = float(np.median(walls)) * 1e3
        print(f"process() {eng._step.scheme:7s} on {smi}: {wall:.2f} ms "
              f"per call of one launch ({out_samples / wall / 1e6:.3f} G "
              f"out samples/s end to end, median of 10)")
    print(f"total: {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
