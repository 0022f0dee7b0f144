"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``speex_resampler_tpu_torch/csrc`` (one
nvcc per source, in parallel) and drives the serving paths of
``BatchedResampler``, 1024 stereo streams (B = 2048 lanes) each:

- the tiled path, 44.1 kHz -> 48 kHz q7 (``csrc/tiled_fir.cu``);
- the streamed path, 48 kHz -> 44.1 kHz q10 (``csrc/streamed_fir.cu``),
  with "auto" (int8), "highest" and an explicit "split5";
- the same two in the fixed-point (Q15) universe (``fixed_point=True``,
  the kernels' "fixed" scheme with 4 accumulator column sets), and
  24 kHz -> 48 kHz q5 fixed, a direct filter (1 column set);
- the voip preset's engine, 44.1 kHz -> 48 kHz q3 under a hard 20 ms cap:
  the dense geometry (``csrc/dense_fir.cu``), and its fixed twin (plain
  torch on the card, no kernel);
- clock drift, 44100 Hz -> 44101 Hz q7: the gather geometry, float and
  fixed (plain torch on the card, no kernel);
- 96 kHz -> 8 kHz q10, where "auto" resolves split5 (the tiled kernel's
  split5 scheme); the f32 kernel is checked and timed at the same launch;
- the serving runtime: ``FleetResampler`` at the flagship (1024 stereo
  streams, 9408-frame quanta), float (the int8 kernel) and fixed, through
  the native C++ stager, pinned slabs and the copy/compute pipeline.

For each path it holds every kernel against its plain PyTorch version on
the card at the path's launch shapes (fixed: 0 mismatches, with lanes that
drive the int32 accumulators past 2^31; the streamed kernel also takes the
direct filter's weights; highest and split5: the mismatch rate beside the
tie bound), serves the path through
``process``/``flush``/``process`` with the launch counts set to 0 just
before and read just after (every kernel of the path must have launched,
once per engine launch; a plain-torch path launches none and keeps its
step's tensors on the card), checks streams 0-3 against a CPU engine, then
times kernel, plain version and, where one exists, the one PyTorch call
that computes the same product (plain-torch paths: the step, by the host
clock), and prints split5's time over highest's where both are timed.
The fleet phase pushes two quanta and a ragged remainder per stream (odd
streams as bytes cut at odd offsets), polls, flushes and pulls every
stream; it requires the native stager, pinned slabs, no degradation and
one kernel launch per fleet launch, holds streams 0-3 and 1023 bit for bit
against a CPU fleet fed those streams' bytes, then times steady-state
``poll()`` at pipeline depths 1 and 2 (out samples/s, the per-phase host
ms a launch of ``stats``, and the device's busy share from a
``torch.profiler`` trace) and ``BatchedResampler.process()`` of four
quanta at the flagship.
Kernel and library times are read three ways: launches queued back to
back between two events, the same launches captured in one CUDA graph and
replayed (the device's time alone: the wrapper's Python runs once, at
capture), and one launch between two events (which also holds the
wrapper's host call).  After the build it prints each kernel's registers
and spills (``ptxas -v``) and the tensor-core instructions of the split5
(HGMMA), int8 and fixed (IGMMA) kernels' SASS (``cuobjdump``; a missing
tool or a count of 0 fails the run).  Every phase raises on
failure (non-zero exit).  The last two lines of standard output are the
kernels' JSON summary and ``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result, without a
CUDA device or outside a checkout of the repository.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from speex_resampler_tpu_torch import BatchedResampler, FleetResampler
from speex_resampler_tpu_torch.ops import _build, phase as ph
from speex_resampler_tpu_torch.ops.convert import word2int
from speex_resampler_tpu_torch.ops import dense_fir as df
from speex_resampler_tpu_torch.ops import filter_design as fd
from speex_resampler_tpu_torch.ops import fir_matmul as fm
from speex_resampler_tpu_torch.ops import streamed_fir as sf
from speex_resampler_tpu_torch.ops import tiled_fir as tf
from speex_resampler_tpu_torch.parallel import batch as tb
from speex_resampler_tpu_torch.utils.profiling import LaunchStats

# block origins and the fixed kernels' wrap input, shared with the tests
# (tests/ is no package)
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tests"))
import fixed_inputs  # noqa: E402

STREAMS, CHANNELS = 1024, 2
LANES = STREAMS * CHANNELS


#: every kernel module, by the geometry it launches
MODULES = {"tiled": tf, "streamed": sf, "dense": df}


class Path:
    """One serving path: its config, its kernel module (None for a path
    that runs plain torch on the card) and its schedule (ragged process()
    calls, flush, one more process() call)."""

    def __init__(self, name, rates, reduced, quality, target, frames, after,
                 module, source, replaces, kernel, fixed=False,
                 flush_moves_f0=True, max_latency_ms=None):
        self.name, self.rates, self.quality = name, rates, quality
        self.num, self.den = reduced
        self.target, self.frames, self.after = target, frames, after
        self.module, self.source, self.replaces = module, source, replaces
        self.kernel = kernel          # BatchSpec.kernel of the path
        self.fixed = fixed            # the Q15 universe (fixed_point=True)
        self.max_latency_ms = max_latency_ms
        self.max_in = (None if max_latency_ms is None
                       else int(max_latency_ms * rates[0] / 1000))
        self.spec = fd.design_filter(self.num, self.den, quality,
                                     fixed_point=fixed)
        # the phase the flush of the staged remainder leaves
        m = ph.producible_outputs(sum(frames) % self.quantum(), 0, 0,
                                  self.num, self.den)
        self.f0_flush = (m * self.num) % self.den
        if flush_moves_f0 and self.f0_flush == 0:
            raise AssertionError(f"{name}: the schedule leaves f0 at 0")

    def geometry(self, f0: int = 0):
        return tb._launch_geometry(self.spec, self.target, f0=f0,
                                   max_in_frames=self.max_in)

    def quantum(self) -> int:
        return self.geometry().in_per_launch

    def engine(self, n_streams: int, device: str, scheme: str):
        return BatchedResampler(n_streams, CHANNELS, *self.rates,
                                self.quality, target_chunk_frames=self.target,
                                device=device, scheme=scheme,
                                fixed_point=self.fixed,
                                max_latency_ms=self.max_latency_ms)


def launch(hist, x, step):
    """The step's kernel (tiled, streamed or dense) on one launch's
    buffers."""
    fn = {"tiled": tf.resample_tiled, "streamed": sf.resample_streamed,
          "dense": df.resample_dense}[step.kernel]
    return fn(hist, x, step.w, **step.kernel_kw)


def plain(hist, x, step):
    """The step kernel's plain PyTorch version on the same buffers."""
    fn = {"tiled": tf.resample_tiled_reference,
          "streamed": sf.resample_streamed_reference,
          "dense": df.resample_dense_reference}[step.kernel]
    return fn(hist, x, step.w, **step.kernel_kw)


def kernel_name(kernel: str, scheme: str, n_accum: int = 1) -> str:
    """The CUDA kernel a (geometry, resolved scheme, n_accum) launches."""
    if scheme == "fixed":
        return f"{kernel}_fir_fixed_kernel<{n_accum}>"
    suffix = {"highest": "f32", "int8": "int8", "split5": "split5"}[scheme]
    return f"{kernel}_fir_{suffix}_kernel"


# 9408-frame quanta: 41000 frames = 4 launches + 3368 staged (f0 -> 147)
FLAGSHIP = Path("tiled 44.1k->48k q7", (44100, 48000), (147, 160), 7, 9408,
                (12000, 9000, 20000), (10000,), tf,
                "speex_resampler_tpu_torch/csrc/tiled_fir.cu",
                "speex_resampler_tpu/ops/pallas_fir.py:341", "tiled")
# 20480-frame quanta: 45000 frames = 2 launches + 4040 staged (f0 -> 40)
SLICE = Path("streamed 48k->44.1k q10", (48000, 44100), (160, 147), 10,
             20480, (25000, 7000, 13000), (22000,), sf,
             "speex_resampler_tpu_torch/csrc/streamed_fir.cu",
             "speex_resampler_tpu/ops/pallas_fir.py:594", "streamed")
# the same two schedules in the fixed universe (n_accum 4)
FIXED_FLAGSHIP = Path("tiled fixed 44.1k->48k q7", (44100, 48000),
                      (147, 160), 7, 9408, (12000, 9000, 20000), (10000,),
                      tf, "speex_resampler_tpu_torch/csrc/tiled_fir.cu",
                      "speex_resampler_tpu/ops/pallas_fir.py:404", "tiled",
                      fixed=True)
FIXED_SLICE = Path("streamed fixed 48k->44.1k q10", (48000, 44100),
                   (160, 147), 10, 20480, (25000, 7000, 13000), (22000,),
                   sf, "speex_resampler_tpu_torch/csrc/streamed_fir.cu",
                   "speex_resampler_tpu/ops/pallas_fir.py:654", "streamed",
                   fixed=True)
# a direct filter (n_accum 1), 5120-frame quanta: 20000 frames = 3
# launches + 4640 staged; num 1, den 2, so every flush leaves f0 at 0
FIXED_DIRECT = Path("tiled fixed 24k->48k q5", (24000, 48000), (1, 2), 5,
                    4096, (6000, 5000, 9000), (5120,), tf,
                    "speex_resampler_tpu_torch/csrc/tiled_fir.cu",
                    "speex_resampler_tpu/ops/pallas_fir.py:404", "tiled",
                    fixed=True, flush_moves_f0=False)

# the voip preset's engine: Q3 under a hard 20 ms cap (882-frame quanta,
# the dense geometry); 4200 frames = 4 launches + 672 staged (f0 -> 84)
VOIP = Path("dense voip 44.1k->48k q3 20 ms", (44100, 48000), (147, 160), 3,
            882, (2000, 1500, 700), (1764,), df,
            "speex_resampler_tpu_torch/csrc/dense_fir.cu",
            "speex_resampler_tpu/ops/pallas_fir.py:198", "dense",
            max_latency_ms=20)
VOIP_FIXED = Path("dense fixed voip 44.1k->48k q3 20 ms", (44100, 48000),
                  (147, 160), 3, 882, (2000, 1500, 700), (1764,), None,
                  None, None, "dense", fixed=True, max_latency_ms=20)
# clock drift: one 44100-frame block per launch; 90000 frames = 2
# launches + 1800 staged
DRIFT = Path("gather 44.1k->44.101k q7", (44100, 44101), (44100, 44101), 7,
             44100, (30000, 20000, 40000), (44100,), None, None, None,
             "gather")
DRIFT_FIXED = Path("gather fixed 44.1k->44.101k q7", (44100, 44101),
                   (44100, 44101), 7, 44100, (30000, 20000, 40000), (44100,),
                   None, None, None, "gather", fixed=True)
# 12:1 decimation at q10, where "auto" resolves split5 (filt_len 3072, K
# 4600, P 1); 30720-frame quanta: 73000 frames = 2 launches + 11560 staged
DECIMATE = Path("tiled 96k->8k q10", (96000, 8000), (12, 1), 10, 30720,
                (40000, 25000, 8000), (30720,), tf,
                "speex_resampler_tpu_torch/csrc/tiled_fir.cu",
                "speex_resampler_tpu/ops/pallas_fir.py:416", "tiled",
                flush_moves_f0=False)

# the TPU branch a scheme's kernel replaces, where it is not the path's
REPLACES = {("tiled", "split5"): "speex_resampler_tpu/ops/pallas_fir.py:416",
            ("streamed", "split5"):
                "speex_resampler_tpu/ops/pallas_fir.py:667"}

# H100 SXM published peaks (NVIDIA H100 datasheet): HBM, FP32 outside
# the tensor cores, int8 and bf16 tensor-core operations
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
INT8_OPS = 1979e12
BF16_FLOPS = 989e12


def lsb_tie_limit(n: int, rate: float = 5e-3) -> float:
    """Poisson tie bound of the LSB contract (tests/conftest.py)."""
    lam = rate * n
    return lam + 4.0 * float(np.sqrt(lam * (1.0 - rate))) + 2.0


def ties(mism: int, n: int) -> str:
    """A mismatch count as a rate, beside the tie bound of n outputs."""
    limit = lsb_tie_limit(n)
    return (f"({mism / max(n, 1):.2e}; tie limit {limit:.0f} = "
            f"{limit / max(n, 1):.2e})")


def compare(got: np.ndarray, want: np.ndarray, scheme: str, what: str):
    """int8, fixed: bit-identical.  highest, split5: max |err| <= 1 within
    the tie bound (f32 sums in another order).  Returns (max |err|, mismatches)."""
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {got.shape} != {want.shape}")
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    err = int(d.max()) if d.size else 0
    mism = int((d > 0).sum())
    if scheme in ("int8", "fixed") and mism:
        raise AssertionError(f"{what}: {mism} {scheme} mismatches")
    if err > 1 or mism > lsb_tie_limit(d.size):
        raise AssertionError(f"{what}: max|err| {err}, {mism} ties of "
                             f"{d.size}")
    return err, mism


def card_inputs(step, n_in: int, B: int, seed: int, wrap: bool = False,
                edges: bool = False):
    """Random history and chunk on the card, zero past the chunk; with
    ``wrap``, every third lane drives one output's int32 accumulator past
    2^31 (tests/fixed_inputs.py); with ``edges``, one chunk row of -32768
    and one of 32767 in every block's window and -32768 history rows."""
    hist, x = fixed_inputs.launch_inputs(step, n_in, B, seed, wrap)
    if edges:
        x[0:n_in:97] = -32768
        x[1:n_in:89] = 32767
        hist[::5] = -32768
    return torch.from_numpy(hist).cuda(), torch.from_numpy(x).cuda()


def cuda_ms(fn, reps: int, warmup: int = 3, warm_ms: float = 25.0,
            mode: str = "queue") -> float:
    """Device ms of one call of ``fn``, after ``warmup`` calls and as many
    more as ``warm_ms`` of the host clock take (the card raises its clocks
    under load; a short kernel timed after idle host work reads slow).

    "queue": the median over 5 groups of ``reps`` calls queued back to
    back between two CUDA events, over ``reps``, so the host's work in each
    call overlaps the device's (unless the host is the slower).  "graph":
    ``reps`` calls captured in one CUDA graph (after 3 more on a side
    stream), replayed between two events in 5 groups, the median over
    ``reps``: the device's time alone, the host's part of a call having run
    once, at capture.  A capture that fails raises.  "host": the median of
    ``reps`` single calls, each between its own two events, which then also
    hold the host's part of the call (a Python wrapper's checks and launch)
    while the card waits."""
    t0, n = time.perf_counter(), 0
    while n < warmup or (time.perf_counter() - t0) * 1e3 < warm_ms:
        fn()
        n += 1
        if n % 8 == 0:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    graph = None
    if mode == "graph":
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()
        torch.cuda.synchronize()
    times = []
    for _ in range(reps if mode == "host" else 5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        if graph is not None:
            graph.replay()
        else:
            for _ in range(1 if mode == "host" else reps):
                fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / (1 if mode == "host" else reps))
    del graph
    return float(np.median(times))


def launch_bound(spec, step, bspec, B: int):
    """(bound_ms, bound_by, bytes, operations, needed multiply-adds, band
    multiply-adds) of one launch.  The bound counts the work the function
    needs, not the work the kernel's tiling walks: filt_len multiply-adds
    per output sample (times n_accum, the weight column sets, for
    "fixed"); the input rows the outputs' windows span (each output j reads
    filt_len rows of hist ++ x from (f0 + j*num) // den + H - (filt_len -
    1); dense steps: H = filt_len - 1, shift 0); the nonzero weights once
    ("int8": D digit bytes each, and the bias; "fixed": 2 bytes each, and
    the int32 cubic coefficients; "split5": 2 bytes per nonzero entry of
    each bf16 plane); y.  It is the larger of the bytes over HBM and the
    operations over the peak of their type (f32 FMA = 2 FLOP on the CUDA
    cores for "highest"; for "int8", 2*D int8 products per multiply-add, an
    int16 sample being two int8 digits; for "fixed", an int16 x int16
    multiply-add is 4 int8 products, 8 operations; both on the int8 tensor
    cores; for "split5", 5 bf16 products, 10 FLOP, on the bf16 tensor
    cores).  The band multiply-adds, returned beside it, are those the
    kernel walks: each row tile's nonzero tap band (64 rows; "fixed": the
    fixed CTA's ``tiled_fir.FIXED_ROWS``; times n_accum), K_pad padding
    skipped; for "highest", each 16-row sub-band's 8-tap slices
    (``tiled_fir.f32_walk``; the dense kernel's too)."""
    n_out, N = bspec.out_per_launch, spec.filt_len
    n_accum = step.kernel_kw.get("n_accum", 1)
    macs = n_out * N * B * n_accum
    shift = step.hist_rows - (N - 1)
    first = bspec.f0 // spec.den + shift
    last = (bspec.f0 + (n_out - 1) * spec.num) // spec.den + shift + N
    if step.scheme == "int8":
        D = step.w[0].shape[0]
        w_bytes = (int((step.w[0] != 0).any(0).sum()) * D
                   + step.w[1].numel() * 4)
        ops = 2 * (2 * D) * macs
    elif step.scheme == "fixed":                  # planes [2, P, C, K_pad]
        w_bytes = (int((step.w[0] != 0).any(0).sum()) * 2
                   + (step.w[2].numel() * 4 if n_accum == 4 else 0))
        ops = 8 * macs
    elif step.scheme == "split5":
        w_bytes = int((step.w[0] != 0).sum()) * 2
        ops = 10 * macs
    else:
        w_bytes = int((step.w[0] != 0).sum()) * 4
        ops = 2 * macs
    nbytes = (last - first) * B * 2 + w_bytes + n_out * B * 2
    taps = step.w[-1].cpu().numpy()
    if step.scheme == "highest":
        band, rows = tf.f32_walk(taps), tf.SUB_ROWS       # [P, sub-bands]
    else:
        band = (taps[..., 1] - taps[..., 0]).astype(np.int64)  # [P, tiles]
        rows = bspec.R // taps.shape[1]
    k = np.arange(bspec.n_blocks)
    band_macs = (int(band[k % max(bspec.P, 1)].sum()) * rows * B
                 * n_accum)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    peak = {"highest": FP32_FLOPS, "split5": BF16_FLOPS}.get(step.scheme,
                                                             INT8_OPS)
    t_ops = ops / peak * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, nbytes, ops, macs, band_macs


def library_call(step, bspec, hist, x, reps: int):
    """One torch.bmm (TF32 off) of the block weights against the patches,
    both gathered outside the timed region: the product only, no WORD2INT
    (dense: one torch.matmul of W^T, its R columns, against every block's
    patch).  Returned as a function, the yardstick of the "highest" and
    "split5" kernels; the port never calls it.

    split5: the three bf16 planes and the two bf16 parts of x concatenated
    along K as [w_hi, w_hi, w_mid, w_mid, w_lo] . [x_hi, x_lo, x_hi, x_lo,
    x_hi], so one bmm takes the five exact products and sums them in f32:
    a bf16 bmm with an f32 ``out_dtype`` (tensor cores), returned, and an
    f32 bmm of the same operands, timed and printed.  Its WORD2INT is held
    against the plain version (max |err| <= 1)."""
    if step.kernel == "dense":
        wt = step.w[0][:, :step.kernel_kw["R"]].t().contiguous()
        L, stride = wt.shape[1], step.kernel_kw["stride"]
        rows = (bspec.n_blocks + L // stride) * stride
        virt = torch.cat([hist, x, x.new_zeros((rows, x.shape[1]))])[:rows]
        patch = fm.dense_patches(virt, L, stride).float().contiguous()
        out = torch.empty((bspec.n_blocks, wt.shape[0], x.shape[1]),
                          dtype=torch.float32, device="cuda")
        return lambda: torch.matmul(wt, patch, out=out)
    w = step.w[0]
    K = w.shape[-2]
    phase = torch.arange(bspec.n_blocks, device="cuda") % bspec.P
    v0 = torch.from_numpy(fixed_inputs.block_origins(step)).cuda()
    virt = torch.cat([hist, x])
    idx = (v0[:, None] + torch.arange(K, device="cuda")[None, :]).clamp(
        max=virt.shape[0] - 1)
    patch = virt[idx].float()
    out = torch.empty((bspec.n_blocks, bspec.R, x.shape[1]),
                      dtype=torch.float32, device="cuda")
    if step.scheme != "split5":
        wt = w[phase].transpose(1, 2).contiguous()
        return lambda: torch.bmm(wt, patch, out=out)
    xh = patch.to(torch.bfloat16)
    xl = (patch - xh.float()).to(torch.bfloat16)
    wt = torch.cat([w[p][phase] for p in (0, 0, 1, 1, 2)],
                   dim=1).transpose(1, 2).contiguous()     # [nb, R, 5K]
    xk = torch.cat([xh, xl, xh, xl, xh], dim=1)            # [nb, 5K, B]
    del patch, xh, xl
    got = word2int(torch.bmm(wt, xk, out_dtype=torch.float32)).reshape(
        -1, x.shape[1])
    wt32, xk32 = wt.float(), xk.float()
    f32_ms = cuda_ms(lambda: torch.bmm(wt32, xk32, out=out), reps)
    del wt32, xk32
    d = (got.int() - plain(hist, x, step).int()).abs()
    err, mism = int(d.max()), int((d > 0).sum())
    print(f"library split5: f32 bmm {f32_ms:.4f} ms, K {5 * K}; bf16 bmm "
          f"(f32 out) vs plain max|err|={err} mismatches={mism} of "
          f"{d.numel()}")
    if err > 1:
        raise AssertionError(f"split5 library bmm: max|err| {err}")
    return lambda: torch.bmm(wt, xk, out_dtype=torch.float32)


def kernel_of(symbol: str) -> str:
    """A kernel's name (with its int and bool template arguments) from its
    mangled symbol, else the symbol."""
    m = re.search(r"\d+((?:tiled|streamed|dense)_fir_\w+?_kernel)"
                  r"(I((?:L[ib]\d+E)+)E)?", symbol)
    if m is None:
        return symbol
    if not m.group(2):
        return m.group(1)
    args = [v if t == "i" else ("true" if v == "1" else "false")
            for t, v in re.findall(r"L([ib])(\d+)E", m.group(3))]
    return f"{m.group(1)}<{', '.join(args)}>"


def ptxas_props(log) -> dict:
    """Each kernel's registers, shared memory, spills and any wgmma
    warning from one source's ``-Xptxas -v`` report (the file
    ``<source>.log``, a ``pathlib.Path``):
    {kernel: [line, ...]}."""
    name, props = None, {}
    for line in log.read_text().splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )(\w+)", line)
        if m:
            name = kernel_of(m.group(1))
        elif name and ("spill" in line or "Used" in line or "wgmma" in line):
            props.setdefault(name, []).append(
                line.split(":", 1)[-1].strip() if "Used" in line
                else line.strip())
    return props


def ptxas_report() -> None:
    """The build's ptxas report (:func:`ptxas_props`), one line a kernel."""
    for log in sorted(_build.build_dir().glob("*.log")):
        for name, lines in ptxas_props(log).items():
            print(f"  ptxas {log.stem} {name}: {'; '.join(lines)}")


def sass_check() -> None:
    """Counts the tensor-core (wgmma) instructions of each split5 (HGMMA),
    int8 and fixed (IGMMA) kernel in the built library's SASS
    (``cuobjdump -sass``, which ships with the CUDA toolkit beside nvcc);
    raises if the tool is missing or fails, or if one of them has none."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        raise AssertionError("SASS check: cuobjdump not found")
    res = subprocess.run([tool, "-sass", str(_build.lib_path())],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise AssertionError(f"cuobjdump exit {res.returncode}: "
                             f"{res.stderr[-2000:]}")
    counts, name = {}, None
    for line in res.stdout.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            name = kernel_of(m.group(1))
        elif name and "GMMA" in line:
            op = "IGMMA" if "IGMMA" in line else "HGMMA"
            counts[(name, op)] = counts.get((name, op), 0) + 1
    want = [("tiled_fir_split5_kernel", "HGMMA"),
            ("streamed_fir_split5_kernel", "HGMMA")] + [
        (f"{name}<{d}{vec}>", "IGMMA") for d in (1, 2, 3, 4)
        for name, vec in (("tiled_fir_int8_kernel", ", true"),
                          ("tiled_fir_int8_kernel", ", false"),
                          ("tiled_fir_int8_long_kernel", ""),
                          ("streamed_fir_int8_kernel", ""))] + [
        (f"{geo}_fir_fixed_kernel<{n}>", "IGMMA")
        for geo in ("tiled", "streamed") for n in (1, 4)]
    found = ", ".join(f"{n} {counts.get((n, op), 0)} {op}" for n, op in want)
    print(f"SASS check (cuobjdump -sass, exit {res.returncode}): {found}")
    if any(counts.get(key, 0) == 0 for key in want):
        raise AssertionError("a tensor-core kernel has no wgmma instruction")


def check_kernels(path: Path, schemes, max_err: dict, kernel=None) -> None:
    """Kernel against plain, both on the card, at the path's launch, at
    f0 0 and after the flush, B = 2048 and 130, and 129 for "highest",
    "int8" and "fixed" (x rows not 16-byte aligned: 2-byte loads), and 64
    for "int8" and "fixed" (one 64-lane CTA tile); fixed with the wrap
    input on every third lane, int8 with rows of -32768 and 32767.
    ``kernel`` overrides the geometry: "streamed" feeds a tiled direct
    filter's weights to the streamed kernel."""
    for scheme in schemes:
        for f0 in sorted({0, path.f0_flush}):
            bspec = path.geometry(f0)
            if kernel is not None:
                bspec = dataclasses.replace(bspec, kernel=kernel)
            step = tb.make_batched_step(path.spec, bspec, device="cuda",
                                        scheme=scheme)
            if step.kernel != (kernel or path.kernel):
                raise AssertionError(f"{path.name}: {step.kernel} step")
            D = step.w[0].shape[0] if step.scheme == "int8" else 0
            n_accum = step.kernel_kw.get("n_accum", 1)
            for B in (LANES, 130) + {"highest": (129,), "int8": (129, 64),
                                     "fixed": (129, 64)}.get(step.scheme,
                                                             ()):
                hist, x = card_inputs(step, bspec.in_per_launch, B,
                                      seed=B + f0, wrap=path.fixed,
                                      edges=step.scheme == "int8")
                got = launch(hist, x, step)
                want = plain(hist, x, step)
                torch.cuda.synchronize()
                what = f"{path.name} {scheme} f0={f0} B={B}"
                err, mism = compare(got.cpu().numpy(), want.cpu().numpy(),
                                    step.scheme, what)
                key = (step.kernel, step.scheme, n_accum)
                max_err[key] = max(max_err.get(key, 0), err)
                print(f"kernel vs plain: {path.name} {scheme:7s} -> "
                      f"{kernel_name(*key)} D={D} f0={f0:3d} B={B:4d} "
                      f"n_blocks={bspec.n_blocks} max|err|={err} "
                      f"mismatches={mism} {ties(mism, got.numel())}")


def serve_engine(path: Path, scheme: str, frames: list):
    """Drive one engine of the path; returns (engine, outputs per call)."""
    eng = path.engine(STREAMS, "cuda", scheme)
    n = len(path.frames)
    outs = [eng.process(f) for f in frames[:n]]
    outs.append(eng.flush())
    if eng._f0 != path.f0_flush:
        raise AssertionError(f"flush left f0 {eng._f0}, expected "
                             f"{path.f0_flush}")
    outs += [eng.process(f) for f in frames[n:]]
    torch.cuda.synchronize()
    return eng, outs


def serve(path: Path, requests: dict, want_digits: int = 0):
    """The path end to end, one engine per requested scheme (``requests``:
    request -> the scheme it must resolve), launch counts set to 0 just
    before and read just after; streams 0-3 against a CPU engine.  A path
    without a kernel module (plain torch on the card) must launch no
    kernel and hold its step's tensors on the card.  Returns (counts,
    engines by resolved scheme, frames)."""
    rng = np.random.default_rng(2024)
    frames = [rng.integers(-32768, 32768, (STREAMS, n, CHANNELS),
                           dtype=np.int16)
              for n in path.frames + path.after]
    for module in MODULES.values():
        module.launches.update(dict.fromkeys(module.launches, 0))
    engines, outs, walls = {}, {}, {}
    for request, scheme in requests.items():
        t0 = time.time()
        eng, outs[scheme] = serve_engine(path, request, frames)
        walls[scheme] = time.time() - t0
        if eng._step.scheme != scheme or eng._step.kernel != path.kernel:
            raise AssertionError(f"{path.name}: {request} built "
                                 f"{eng._step.kernel}/{eng._step.scheme}")
        engines[scheme] = eng
    counts = dict(path.module.launches) if path.module else {}
    for kind, module in MODULES.items():
        if module is not path.module and any(module.launches.values()):
            raise AssertionError(f"{path.name} launched {module.launches} "
                                 f"of the {kind} geometry's kernels")
    if path.module is None and not all(
            t.is_cuda for e in engines.values() for t in e._step.w):
        raise AssertionError(f"{path.name}: step tensors off the card")
    if "int8" in engines and engines["int8"]._step.w[0].shape[0] \
            != want_digits:
        raise AssertionError(f"auto resolved int8 D="
                             f"{engines['int8']._step.w[0].shape[0]}")
    n = len(path.frames)
    launched = {s: e.launches for s, e in engines.items()}
    if any(counts[s] != launched.get(s, 0) for s in counts) \
            or (path.module and not counts) or min(launched.values()) < n:
        raise AssertionError(f"kernel launches {counts} vs engines "
                             f"{launched}")
    for request, scheme in requests.items():
        ref = path.engine(4, "cpu", request)
        want = [ref.process(f[:4]) for f in frames[:n]]
        want.append(ref.flush())
        want += [ref.process(f[:4]) for f in frames[n:]]
        for i, (g, w) in enumerate(zip(outs[scheme], want)):
            if g.shape[0] != STREAMS or g.shape[2] != CHANNELS:
                raise AssertionError(f"call {i}: output shape {g.shape}")
            err, mism = compare(g[:4], w, scheme,
                                f"{path.name} {scheme} call {i}")
            print(f"serve {path.name} {scheme:7s} call {i}: out "
                  f"{tuple(g.shape)} streams 0-3 vs cpu max|err|={err} "
                  f"mismatches={mism} {ties(mism, w.size)}")
    first = next(iter(requests.values()))
    print(f"serve {path.name}: {requests} (int8 D={want_digits}, "
          f"{path.quantum()} frames per launch), "
          f"launches {counts}, f0 after flush {path.f0_flush}, "
          f"{walls[first]:.2f} s for the {first} engine's "
          f"{sum(path.frames + path.after)} frames x {LANES} lanes (engine "
          f"construction, host staging and pageable copies included)")
    return counts, engines, frames


def time_launch(label: str, spec, step, bspec, smi: str, reps: int):
    """Kernel, plain and library times of one launch at B = 2048 (library:
    the highest and split5 schemes' bmm; no PyTorch call computes the exact
    int8 digit sums or the wrapped int32 sums of "fixed"); kernel and
    library also from a CUDA graph of ``reps`` launches, the kernel also
    one launch at a time (:func:`cuda_ms`).  Returns the JSON entry's
    numbers."""
    out_samples = bspec.out_per_launch * LANES
    hist, x = card_inputs(step, bspec.in_per_launch, LANES, seed=7)
    ms = cuda_ms(lambda: launch(hist, x, step), reps)
    graph_ms = cuda_ms(lambda: launch(hist, x, step), reps, mode="graph")
    host_ms = cuda_ms(lambda: launch(hist, x, step), reps, mode="host")
    plain_ms = cuda_ms(lambda: plain(hist, x, step), reps)
    library_ms = library_graph_ms = None
    if step.scheme in ("highest", "split5"):
        lib_fn = library_call(step, bspec, hist, x, reps)
        library_ms = cuda_ms(lib_fn, reps)
        library_graph_ms = cuda_ms(lib_fn, reps, mode="graph")
        del lib_fn
    bound_ms, bound_by, nbytes, ops, macs, band_macs = launch_bound(
        spec, step, bspec, LANES)
    lib = ("none" if library_ms is None else
           f"{library_ms:.4f} ms (graph {library_graph_ms:.4f})")
    print(f"timing {label} on {smi}: kernel {ms:.4f} ms/launch back to "
          f"back ({out_samples / ms / 1e6:.2f} G out samples/s), graph "
          f"{graph_ms:.4f} ms, single {host_ms:.4f} ms (single - graph = "
          f"{host_ms - graph_ms:.4f} ms of the launch's host call), plain "
          f"{plain_ms:.4f} ms, library {lib}"
          f", bound {bound_ms:.4f} ms by {bound_by} "
          f"({nbytes / 1e6:.1f} MB, {ops / 1e9:.1f} G ops) -> "
          f"{bound_ms / ms:.3f} of the bound; the kernel's tiles walk "
          f"{band_macs / 1e9:.2f} G band multiply-adds, the function "
          f"needs {macs / 1e9:.2f} G")
    if library_graph_ms is not None:
        print(f"  graph: kernel / library = {graph_ms:.4f} / "
              f"{library_graph_ms:.4f} ms = {graph_ms / library_graph_ms:.3f}")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms, graph_ms=graph_ms,
                library_graph_ms=library_graph_ms, host_ms=host_ms)


def time_path(path: Path, schemes, smi: str, counts: dict, max_err: dict,
              engines: dict, frames: list, reps: int, unlisted=()) -> list:
    """Kernel, plain and library times at the path's steady-state launch
    (B = 2048), and one steady-state process() call of one quantum.  The
    ``unlisted`` schemes are timed and printed but not listed (another
    path's entry lists their kernel).  A path without a kernel times its
    plain-torch step by the host clock."""
    bspec = path.geometry()
    out_samples = bspec.out_per_launch * LANES
    entries, ms = [], {}
    for scheme in (schemes + unlisted) if path.module else ():
        step = tb.make_batched_step(path.spec, bspec, device="cuda",
                                    scheme=scheme)
        key = (step.kernel, step.scheme, step.kernel_kw.get("n_accum", 1))
        D = step.w[0].shape[0] if step.scheme == "int8" else 0
        nums = time_launch(f"{path.name} {scheme:7s} ({kernel_name(*key)} "
                           f"D={D})", path.spec, step, bspec, smi, reps)
        ms[step.scheme] = nums["ms"]
        if scheme in unlisted:
            continue
        entries.append({
            "name": kernel_name(*key), "route": "cuda",
            "source": path.source,
            "replaces": REPLACES.get(key[:2], path.replaces),
            "launches": counts[step.scheme], "max_abs_err": max_err[key],
            **nums})
    if "split5" in ms and "highest" in ms:
        print(f"split5 / highest at {path.name} on {smi}: "
              f"{ms['split5']:.4f} / {ms['highest']:.4f} ms = "
              f"{ms['split5'] / ms['highest']:.3f}")
    if path.module is None:
        step = next(iter(engines.values()))._step
        hist, x = card_inputs(step, bspec.in_per_launch, LANES, seed=7,
                              wrap=path.fixed)
        walls = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step.fn(hist, x, step.w)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        wall = float(np.median(walls[1:])) * 1e3
        print(f"timing {path.name} {step.scheme} (plain torch on the card, "
              f"no kernel) on {smi}: step {wall:.4f} ms/launch by the host "
              f"clock ({out_samples / wall / 1e6:.2f} G out samples/s), "
              f"median of 5 after one warm-up")
    quantum = frames[0][:, :bspec.in_per_launch]
    for scheme, eng in engines.items():
        eng.process(quantum)
        walls = []
        for _ in range(10):
            t0 = time.perf_counter()
            eng.process(quantum)
            walls.append(time.perf_counter() - t0)
        wall = float(np.median(walls)) * 1e3
        print(f"process() {path.name} {scheme:7s} on {smi}: {wall:.2f} ms "
              f"per call of one launch ({out_samples / wall / 1e6:.3f} G "
              f"out samples/s end to end, median of 10)")
    return entries


# the fleet phase: the flagship's streams; the CPU fleet's reference lanes
FLEET_RATES = (44100, 48000, 7)
FLEET_TARGET = 9408
FLEET_CHECKED = (0, 1, 2, 3, STREAMS - 1)


def fleet(n_streams: int, device: str, fixed: bool, depth: int = 2):
    return FleetResampler(n_streams, CHANNELS, *FLEET_RATES,
                          target_chunk_frames=FLEET_TARGET, device=device,
                          fixed_point=fixed, pipeline_depth=depth)


def fleet_push(f, s: int, frames: np.ndarray, rng) -> None:
    """One stream's frames in three ragged pieces; odd streams as bytes cut
    at odd offsets (the stager's alignment carry holds the partial
    frame)."""
    cuts = sorted(rng.integers(1, frames.shape[0], 2).tolist())
    for a, b in zip([0] + cuts, cuts + [frames.shape[0]]):
        if s % 2:
            raw = frames[a:b].astype("<i2").tobytes()
            k = len(raw) // 2 | 1
            f.push_bytes(s, raw[:k])
            f.push_bytes(s, raw[k:])
        else:
            f.push(s, frames[a:b])


def fleet_check(fixed: bool) -> None:
    """Two quanta and a ragged remainder per stream through poll, flush
    and pull; launch counts reset just before, read just after."""
    name = "fixed" if fixed else "int8"
    f = fleet(STREAMS, "cuda", fixed)
    q = f.bspec.in_per_launch
    if f.stager_kind != "native":
        raise AssertionError(f"fleet stager {f.stager_kind}")
    if f._step.scheme != name or f._step.kernel != "tiled":
        raise AssertionError(f"fleet step {f._step.kernel}/{f._step.scheme}")
    pinned = all(s._pinned.is_pinned() for s in f._slabs) and all(
        b.is_pinned() for b in f._readback_bufs)
    if not pinned:
        raise AssertionError("fleet slabs or readback buffers not pinned")
    rng = np.random.default_rng(77)
    rem = rng.integers(0, q, STREAMS)
    frames = rng.integers(-32768, 32768, (STREAMS, 2 * q + q, CHANNELS),
                          dtype=np.int16)
    for module in MODULES.values():
        module.launches.update(dict.fromkeys(module.launches, 0))
    t0 = time.perf_counter()
    for s in range(STREAMS):
        fleet_push(f, s, frames[s, :2 * q + rem[s]], rng)
    t_push = time.perf_counter() - t0
    t0 = time.perf_counter()
    ran = f.poll()
    f.flush()
    outs = [f.pull(s) for s in range(STREAMS)]
    torch.cuda.synchronize()
    t_serve = time.perf_counter() - t0
    counts = {k: dict(m.launches) for k, m in MODULES.items()}
    launched = f.stats.launches
    if ran != 2 or counts["tiled"][name] != launched or launched != 3 \
            or any(v for k, m in counts.items() for sch, v in m.items()
                   if (k, sch) != ("tiled", name)):
        raise AssertionError(f"fleet {name}: {ran} polled, {launched} "
                             f"launches, kernel counts {counts}")
    if f.degraded:
        raise AssertionError(f"fleet degraded: {f.degraded_cause!r}")
    ref = fleet(len(FLEET_CHECKED), "cpu", fixed)
    for i, s in enumerate(FLEET_CHECKED):
        ref.push_bytes(i, frames[s, :2 * q + rem[s]].astype("<i2").tobytes())
    ref.poll()
    ref.flush()
    for i, s in enumerate(FLEET_CHECKED):
        want = ref.pull(i)
        n_want = (2 * f.bspec.out_per_launch + ph.producible_outputs(
            int(rem[s]), 0, 0, f.spec.num, f.spec.den))
        if want.shape != (n_want, CHANNELS):
            raise AssertionError(f"cpu fleet stream {s}: {want.shape}")
        compare(outs[s], want, name, f"fleet {name} stream {s}")
    print(f"fleet {name}: {STREAMS} streams x {CHANNELS}, stager "
          f"{f.stager_kind}, slabs pinned {pinned}, {launched} launches = "
          f"kernel launches {counts['tiled'][name]} "
          f"({kernel_name('tiled', name, f._step.kernel_kw['n_accum'])}), "
          f"degraded {f.degraded}; streams {FLEET_CHECKED} bit-identical "
          f"with the cpu fleet; pushes {t_push:.2f} s, poll+flush+pull "
          f"{t_serve:.2f} s (first launches: build of the step included)")


def device_busy_ms(prof) -> float | None:
    """The union of the device's kernel and copy intervals in a
    ``torch.profiler`` trace, in ms; None where the trace has none."""
    spans = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
    if not spans:
        return None
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e3


def fleet_time(fixed: bool, depth: int, smi: str, n: int = 8) -> None:
    """Steady-state ``poll()`` of n launches (pushes outside the timed
    region), after a warm-up poll of two; the stats reset before it.
    Then one poll of 4 launches under ``torch.profiler``: the device's
    busy share of that poll's wall time."""
    f = fleet(STREAMS, "cuda", fixed, depth)
    q = f.bspec.in_per_launch
    rng = np.random.default_rng(5)
    block = rng.integers(-32768, 32768, (STREAMS, q, CHANNELS),
                         dtype=np.int16)

    def feed(k):
        for _ in range(k):
            for s in range(STREAMS):
                f.push(s, block[s])

    feed(2)
    f.poll()
    f.stats = LaunchStats()
    feed(n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ran = f.poll()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if ran != n or f.degraded:
        raise AssertionError(f"fleet timing: {ran} launches, degraded "
                             f"{f.degraded}")
    out = n * f.bspec.out_per_launch * LANES
    st = f.stats.as_dict()
    name = "fixed" if fixed else "int8"
    print(f"fleet poll() {name} depth {depth} on {smi}: {n} launches in "
          f"{wall * 1e3:.2f} ms = {wall * 1e3 / n:.2f} ms a launch, "
          f"{out / wall / 1e6:.2f} M out samples/s; per-phase host ms a "
          f"launch {st['phase_ms_per_launch']}, min {st['phase_ms_min']}")
    print(f"  stats {json.dumps(st)}")
    feed(4)
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        f.poll()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = device_busy_ms(prof)
    share = ("not measured (no device events in the trace)" if busy is None
             else f"{busy:.2f} ms busy of {wall:.2f} ms = "
                  f"{busy / wall:.3f} busy, {1 - busy / wall:.3f} idle")
    print(f"  device under the profiler, 4 launches: {share}")


def process_time(eng, frames: np.ndarray, smi: str, quanta: int) -> None:
    """``BatchedResampler.process()`` of ``quanta`` quanta a call (the
    depth-1 pipeline over two pinned slabs), median of 5 after one."""
    q = eng.in_frames_per_launch
    x = frames[:, :quanta * q]
    eng.process(x)
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        eng.process(x)
        walls.append(time.perf_counter() - t0)
    wall = float(np.median(walls)) * 1e3
    out = quanta * eng.out_frames_per_launch * LANES
    print(f"process() flagship {eng._step.scheme} {quanta} quanta a call on "
          f"{smi}: {wall:.2f} ms ({out / wall / 1e3:.2f} M out samples/s, "
          f"median of 5)")


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

    # -- phase 2: build the kernels from the checkout, one nvcc per source
    t0 = time.time()
    _build.load()
    print(f"build: {time.time() - t0:.1f} s ({_build.build_dir()})")
    ptxas_report()
    sass_check()

    # -- phase 3: every kernel against its plain version, on the card
    max_err: dict = {}
    check_kernels(FLAGSHIP, ("int8", "highest"), max_err)
    check_kernels(SLICE, ("auto", "int8", "highest", "split5"), max_err)
    check_kernels(VOIP, ("auto",), max_err)
    check_kernels(DECIMATE, ("auto", "highest"), max_err)
    for path in (FIXED_FLAGSHIP, FIXED_SLICE, FIXED_DIRECT):
        check_kernels(path, ("auto",), max_err)
    check_kernels(FIXED_DIRECT, ("auto",), max_err, kernel="streamed")
    print(f"kernels checked: {time.time() - t_start:.1f} s")

    # -- phase 4: each path end to end, its launches counted from 0
    float_requests = {"auto": "int8", "highest": "highest"}
    served = {FLAGSHIP: serve(FLAGSHIP, float_requests, want_digits=3),
              SLICE: serve(SLICE, {**float_requests, "split5": "split5"},
                           want_digits=4)}
    for path in (FIXED_FLAGSHIP, FIXED_SLICE, FIXED_DIRECT, VOIP_FIXED,
                 DRIFT_FIXED):
        served[path] = serve(path, {"auto": "fixed"})
    for path in (VOIP, DRIFT):
        served[path] = serve(path, {"auto": "highest"})
    served[DECIMATE] = serve(DECIMATE, {"auto": "split5"})
    print(f"served: {time.time() - t_start:.1f} s")

    # -- phase 5: timing at each path's launch
    # (listed, printed only): explicit streamed int8 (D = 3) beside auto
    # (D = 4); highest at 96k->8k, the launch auto served before split5
    kernels = []
    for path, schemes, unlisted in (
            (FLAGSHIP, ("int8", "highest"), ()),
            (SLICE, ("auto", "highest", "split5"), ("int8",)),
            (FIXED_FLAGSHIP, ("auto",), ()),
            (FIXED_SLICE, ("auto",), ()),
            (FIXED_DIRECT, ("auto",), ()),
            (VOIP, ("auto",), ()),
            (DECIMATE, ("auto",), ("highest",)),
            (VOIP_FIXED, (), ()), (DRIFT, (), ()), (DRIFT_FIXED, (), ())):
        counts, engines, frames = served[path]
        kernels += time_path(path, schemes, smi, counts, max_err, engines,
                             frames, reps=20, unlisted=unlisted)
    # the streamed kernel with one column set: no served path launches it
    bspec = dataclasses.replace(
        tb._launch_geometry(FIXED_DIRECT.spec, FIXED_DIRECT.target),
        kernel="streamed")
    step = tb.make_batched_step(FIXED_DIRECT.spec, bspec, device="cuda")
    time_launch(f"{FIXED_DIRECT.name} weights on the streamed kernel "
                f"({kernel_name('streamed', 'fixed', 1)}, on no served "
                f"path)", FIXED_DIRECT.spec, step, bspec, smi, reps=20)
    # -- phase 6: the serving runtime (FleetResampler) at the flagship
    for fixed in (False, True):
        fleet_check(fixed)
    for fixed, depth in ((False, 1), (False, 2), (True, 2)):
        fleet_time(fixed, depth, smi)
    _, engines, frames = served[FLAGSHIP]
    big = np.concatenate(frames[:3], axis=1)     # 41000 frames a stream
    process_time(engines["int8"], big, smi, quanta=4)
    print(f"total: {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
