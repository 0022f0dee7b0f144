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
  the dense geometry (``csrc/dense_fir.cu``), float and fixed (its int8
  tensor-core kernel), and wideband voip from 48 kHz capture, 48 kHz ->
  16 kHz q3 under the same cap, fixed: a direct filter (1 column set) on
  the dense kernel;
- clock drift, 44100 Hz -> 44101 Hz q7: the gather geometry, float and
  fixed (``csrc/gather_fir.cu``), served in its band form (the FP64 and
  int8 tensor-core kernels); both forms, band and rows, are checked and
  timed at its launch; and the steep gather decimation 96 kHz -> 401 Hz
  q3, float and fixed, whose band is too wide to be resident: served in
  its stream form (the band streamed through shared memory, the same two
  tensor-core products), its rows form (a chunk's rows staged in pieces)
  checked and timed beside it; the fixed stream kernel also forced at the
  drift launch with the wrap lanes;
- 96 kHz -> 8 kHz q10, where "auto" resolves split5 (the tiled kernel's
  split5 scheme); the f32 kernel is checked and timed at the same launch;
- the serving runtime: ``FleetResampler`` at the flagship (1024 stereo
  streams, 9408-frame quanta), float (the int8 kernel) and fixed, through
  the native C++ stager, pinned slabs and the copy/compute pipeline;
- phase 7, the single-stream layer: the reference integration matrix
  (seven configs, 10 s of seeded PCM, one shot and 1024-frame chunks)
  through ``SpeexResampler.process_chunk`` on the device route
  (``engine="device"``, one f32 matmul a call on the card, plain torch)
  against the host route (the native loops, bit-identical to the
  reference float build) within 1 LSB under the tie bound; the default
  route's native loops; 16- and 64-channel cores (``auto`` takes the
  device route); the gather route (44.1 kHz -> 44.101 kHz, the float
  gather's rows form on f32 samples, its launches counted); the fixed
  universe bit-exact against ``device="cpu"``; one core with TF32 switched
  on around it; then process_chunk out samples/s, host against device
  route, at 2, 8, 16 and 64 channels;
- phase 8, ``MultiFleet`` at full width: 1024 stereo streams over four
  buckets (44.1k -> 48k q7, 24k -> 48k q5, 48k -> 44.1k q10, 44.1k -> 24k
  q5; 257 slots each, 2048-frame target), one quantum a stream a round,
  an end_stream, an add_stream and an exact set_stream_rate mid-run, ten
  timed rounds, float and fixed: every bucket's kernel launched (the
  kernel counts equal the buckets' launches), no bucket degraded, streams
  0-3 and the last of each bucket, the ended, switched and added streams
  bit-identical with a ``device="cpu"`` MultiFleet fed the same frames,
  and out samples/s with the push, poll and pull ms a round;
- phase 9, the functional step and ``mesh=`` at full width (1024 stereo
  streams): ``make_stream_fn`` at the flagship, float (the int8 kernel)
  and fixed, and at 48 kHz -> 44.1 kHz q10 (the streamed int8 kernel),
  three quanta eagerly, bit for bit against a CUDA ``BatchedResampler`` on
  the same frames and, at lanes 0-7 and 2047, against a ``device="cpu"``
  step, one kernel launch a quantum; the step plus a feature stage
  (256-frame window energies) captured in one CUDA graph and replayed
  over four quanta, bit for bit against the eager stage, the kernel count
  moving once, at capture; the voip dense steps (float and fixed) and
  the drift gather steps through ``make_stream_fn`` (float and fixed)
  captured in a CUDA graph too, one kernel launch each, bit for bit
  against eager and, at lanes 0-7 and 2047, against ``device="cpu"``
  (float: within the tie bound); ``resample_array`` on 10 s of stereo PCM, the
  card against ``device="cpu"`` (float and fixed: bit-identical); a
  two-shard mesh on one card (``mesh=["cuda:0"] * 2``) and a mesh of every
  visible card against the unmeshed engine through process / flush /
  process, float and fixed, bit for bit, with twice (once a shard) the
  engine's launches; the functional step on the two-shard mesh against
  the unsharded step; then ms a quantum of the eager stage and of its
  graph replay, and ms a ``process()`` call meshed and unmeshed.

For each path it holds every kernel against its plain PyTorch version on
the card at the path's launch shapes (fixed: 0 mismatches, with lanes that
drive the int32 accumulators past 2^31; the streamed kernel also takes the
direct filter's weights; highest and split5: the mismatch rate beside the
tie bound), serves the path through
``process``/``flush``/``process`` with the launch counts set to 0 just
before and read just after (every kernel of the path must have launched,
once per engine launch, and the step's tensors lie on the card), checks
streams 0-3 against a CPU engine, then times kernel, plain version and
the one PyTorch call that computes the same product (int8 and fixed: one
exact float64 product, its epilogue applied outside the timed call and
held bit for bit against the plain version), and prints split5's time
over highest's where both are timed.
The fleet phase pushes two quanta and a ragged remainder per stream (odd
streams as bytes cut at odd offsets), polls, flushes and pulls every
stream; it requires the native stager, pinned slabs, no degradation and
one kernel launch per fleet launch, holds streams 0-3 and 1023 bit for bit
against a CPU fleet fed those streams' bytes, then times steady-state
``poll()`` at pipeline depths 1 and 2 (out samples/s, the per-phase host
ms a launch of ``stats``, and the device's busy share from a
``torch.profiler`` trace) and ``BatchedResampler.process()`` of four
quanta at the flagship.
- phase 10, the TPU probes (``speex_resampler_tpu_torch.probes``,
  ``csrc/probes/``; the Hopper counterparts of ``experiments/mxu_peak.py``,
  ``mxu_shape_probe.py``, ``v4_overhead_anatomy.py``,
  ``fixed_interp_anatomy.py``, ``v3_overhead_anatomy.py``,
  ``mosaic_int_dot_bench.py``, ``kernel_anatomy.py``, ``prec_bench.py``,
  ``v5_int8_bench.py``, ``v4_k_layout.py``, ``batched_dot.py`` and
  ``v3_bench.py``): their library, ``libprobes``, built beside the
  kernels' in phase 2 (its build time, ``-Xptxas -v`` lines and SASS
  counts printed: IGMMA or HGMMA in every tensor-core probe, FFMA (FADD
  for nodot) and no wgmma in the CUDA-core ones, else the run fails);
  every probe kernel against its plain version on the card at the TPU
  probe's full shape (the rate kernel at the flagship block [128, 264] x
  128 lanes, int8 and bf16, at its own N-tile and at N = 32 and 64; the
  int8 block's three variants at N = 32 and 64; the fixed ladder's four
  rungs; the flagship launch's five variants, full and hoist also against
  the served K1b, hoist's pre-pass against its plain split; the exact
  integer dots of each form on the rate kernel, the wide forms on
  full-range operands; the f32 block's four variants;
  the FIR dot at four precisions, with their error against the float64
  gold printed beside the plain version's; P9's int8 and split5 launches
  without the halo, also against the served tiled kernels at H = 0 and
  the gold; P10's K 512 / 448 / 440 (and 100) with W as [R, K] and [K,
  R]; P11's m-loop at 128 and 64 lanes and batched form, also against
  the served f32 kernel, and its pre-pass; P12's conv against P6's full
  and its concat step; each at the full shape and a ragged one): 0
  mismatches for the integer probes and nodot, max |err| <= 1 within the
  tie bound for the float ones; then, with the probe launch counts set to
  0, one case of each
  timed (every SM busy: ms a launch, the rate from the slope between two
  iteration counts, the plain version and, where one PyTorch call
  computes the function, the library call; P5's ladder beside the served
  K1b with hoist's pre-pass timed alone, P7's cost a body by operand
  width, P10's slope and intercept, P11 beside the served K1a with the
  pre-pass alone, P12's step eager and in a CUDA graph beside the served
  highest step), each probe kernel required to have launched.  The probe kernels join the ``{"kernels": ...}`` line
  (a name ends with its variant, rung, form or precision) with
  ``launches`` 0 (no served path launches them) and their phase-10
  launches beside.
- phase 11, the fuzz campaign and the soak on the card
  (``tools/fuzz_torch.py``, ``tools/soak_torch.py``): the campaign at
  :data:`FUZZ_SEED`, its stratified round (one draw of each served kernel
  by name and of the core's matmul and gather routes), pinned draws, then
  free draws up to :data:`FUZZ_DRAWS`, each held against the host route's
  native loops and ``device="cpu"``: draws by mode and class, failures
  (0, else the run fails), launches by kernel (every served kernel at
  least once, else the run fails; each entry of the ``kernels`` line
  carries its ``phase11_launches``); then :data:`SOAK_SECONDS` of
  ``MultiFleet`` churn at 64 stereo streams a bucket: no bucket degraded,
  every bucket's kernel launched, the peak and final growth of RSS,
  device-allocated and pinned bytes within the soak's limits.
Kernel and library times are read three ways: launches queued back to
back between two events, the same launches captured in one CUDA graph and
replayed (the device's time alone: the wrapper's Python runs once, at
capture), and one launch between two events (which also holds the
wrapper's host call).  After the build it prints each kernel's registers
and spills (``ptxas -v``) and the tensor-core instructions of the split5
(HGMMA), int8 and fixed (IGMMA) kernels' SASS (``cuobjdump``; a missing
tool or a count of 0 fails the run).  Every phase raises on
failure (non-zero exit).  The last three lines of standard output are
the seconds of each phase (with the card's name and power limit), the
kernels' JSON summary and ``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result, without a
CUDA device or outside a checkout of the repository.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from speex_resampler_tpu_torch import (BatchedResampler, FleetResampler,
                                       SpeexResampler, make_stream_fn,
                                       resample_array)
from speex_resampler_tpu_torch.runtime import MultiFleet
from speex_resampler_tpu_torch.ops import _build, phase as ph
from speex_resampler_tpu_torch.ops.convert import lsb_tie_limit, word2int
from speex_resampler_tpu_torch.ops import dense_fir as df
from speex_resampler_tpu_torch.ops import filter_design as fd
from speex_resampler_tpu_torch.ops import fir_exact
from speex_resampler_tpu_torch.ops import fir_matmul as fm
from speex_resampler_tpu_torch.ops.fixed_math import (fixed_interp_mix_rows,
                                                    sat32pshr15)
from speex_resampler_tpu_torch.ops import streamed_fir as sf
from speex_resampler_tpu_torch.ops import tiled_fir as tf
from speex_resampler_tpu_torch.parallel import batch as tb
from speex_resampler_tpu_torch.parallel.mesh import join_lanes, split_lanes
from speex_resampler_tpu_torch.probes import (
    batched_dot as pbd, fixed_interp_anatomy as pfa, kernel_anatomy as pka,
    mosaic_int_dot_bench as pid, prec_bench as ppb, tc_rate as ptr,
    v3_bench as pv3b, v3_overhead_anatomy as pv3, v4_k_layout as pkl,
    v4_overhead_anatomy as pv4, v5_int8_bench as pv5)
from speex_resampler_tpu_torch.utils.launches import (CORE_GATHER, MODULES,
                                                      kernel_name,
                                                      launch_counts,
                                                      n_accum_of,
                                                      reset_launches)
from speex_resampler_tpu_torch.utils.profiling import LaunchStats

# block origins and the fixed kernels' wrap input, shared with the tests
# (tests/ is no package)
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tests"))
import fixed_inputs  # noqa: E402

STREAMS, CHANNELS = 1024, 2
LANES = STREAMS * CHANNELS


class Path:
    """One serving path: its config, its kernel module and its schedule
    (ragged process() calls, flush, one more process() call)."""

    def __init__(self, name, rates, reduced, quality, target, frames, after,
                 module, source, replaces, kernel, fixed=False,
                 flush_moves_f0=True, max_latency_ms=None, wrap=None):
        self.name, self.rates, self.quality = name, rates, quality
        self.num, self.den = reduced
        self.target, self.frames, self.after = target, frames, after
        self.module, self.source, self.replaces = module, source, replaces
        self.kernel = kernel          # BatchSpec.kernel of the path
        self.fixed = fixed            # the Q15 universe (fixed_point=True)
        # the wrap input in the kernel checks (fixed; a filter whose taps
        # cannot drive a sum past 2^31 takes plain random samples)
        self.wrap = fixed if wrap is None else wrap
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


_FORCED = {}


def gather_kw(step, form: str | None = None) -> dict:
    """A gather step's launch arguments, its own (``form`` None) or with
    its form forced: an explicit plan of that form over the step's starts
    and, for the band form, its band (built once a step and form)."""
    if form is None or form == step.kernel_kw["plan"].form:
        return dict(step.kernel_kw)
    key = (id(step), form)
    if key not in _FORCED:
        taps, starts = step.w[0], step.w[1].cpu().numpy()
        n_accum = n_accum_of(step) if step.scheme == "fixed" else None
        planner = {"band": fm.gather_plan_band, "rows": fm.gather_plan_rows,
                   "stream": fm.gather_plan_stream}[form]
        plan = planner(starts, taps.shape[-1], n_accum=n_accum)
        _FORCED[key] = (step, dict(plan=plan, band=fm.gather_band(
            taps, starts, plan) if form != "rows" else None))
    return dict(_FORCED[key][1])


def gather_forms(step) -> tuple:
    """The forms a gather step's launch is checked and timed in: the band
    form where its band fits a CTA, else the stream form; and the rows
    form."""
    n_accum = n_accum_of(step) if step.scheme == "fixed" else None
    fits = fm.gather_plan_band(step.w[1].cpu().numpy(), step.w[0].shape[-1],
                               n_accum=n_accum) is not None
    return ("band" if fits else "stream", "rows")


def kernel_key(step, form: str | None = None) -> tuple:
    """(geometry, scheme, n_accum) of a step's kernel, for a gather also
    its form and the rows form's kO (:func:`kernel_name`'s arguments)."""
    key = (step.kernel, step.scheme, n_accum_of(step))
    if step.kernel != "gather":
        return key
    plan = gather_kw(step, form)["plan"]
    return key + (plan.form, plan.outputs // 8 if plan.form == "rows" else 0)


def kernel_call(hist, x, step, reference: bool = False,
                form: str | None = None):
    """A function that runs the step's kernel (or, with ``reference``, its
    plain PyTorch version) on one launch's buffers, as the step launches
    it (a gather reads hist and x as [B, rows] views; ``form`` forces its
    form, :func:`gather_kw`)."""
    fixed = step.scheme == "fixed"
    if step.kernel == "gather":
        fn = fm.resample_gather_fixed if fixed else fm.resample_gather
        kw = dict(gather_kw(step, form), hist=hist.t())
        X = x[:step.chunk_rows].t()
        if reference:      # the wrapper's plain version, on the card
            fn = (fm.resample_gather_fixed_reference if fixed
                  else fm.resample_gather_reference)
            kw, X = {}, torch.cat([hist, x[:step.chunk_rows]]).t()
        return lambda: fn(X, *step.w, **kw)
    fn = {"tiled": (tf.resample_tiled, tf.resample_tiled_reference),
          "streamed": (sf.resample_streamed, sf.resample_streamed_reference),
          "dense": ((df.resample_dense_fixed,
                     df.resample_dense_fixed_reference) if fixed else
                    (df.resample_dense, df.resample_dense_reference))
          }[step.kernel][reference]
    return lambda: fn(hist, x, step.w, **step.kernel_kw)


def launch(hist, x, step, form: str | None = None):
    """The step's kernel on one launch's buffers."""
    return kernel_call(hist, x, step, form=form)()


def plain(hist, x, step):
    """The step kernel's plain PyTorch version on the same buffers."""
    return kernel_call(hist, x, step, reference=True)()


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
# the JAX package runs the fixed dense and the gather launches as XLA
# programs outside Pallas (speex_resampler_tpu/ops/fir_matmul.py)
VOIP_FIXED = Path("dense fixed voip 44.1k->48k q3 20 ms", (44100, 48000),
                  (147, 160), 3, 882, (2000, 1500, 700), (1764,), df,
                  "speex_resampler_tpu_torch/csrc/dense_fir.cu",
                  "speex_resampler_tpu/ops/fir_matmul.py:224", "dense",
                  fixed=True, max_latency_ms=20)
# wideband voip from 48 kHz capture: a direct filter (n_accum 1) under a
# hard 20 ms cap, the dense geometry (864-frame quanta, 3 blocks of 288
# frames); 4200 frames = 4 launches + 744 staged; num 3, den 1, so every
# flush leaves f0 at 0
VOIP_FIXED_DIRECT = Path("dense fixed voip 48k->16k q3 20 ms",
                         (48000, 16000), (3, 1), 3, 882, (2000, 1500, 700),
                         (1728,), df,
                         "speex_resampler_tpu_torch/csrc/dense_fir.cu",
                         "speex_resampler_tpu/ops/fir_matmul.py:224", "dense",
                         fixed=True, flush_moves_f0=False, max_latency_ms=20)
# clock drift: one 44100-frame block per launch; 90000 frames = 2
# launches + 1800 staged
DRIFT = Path("gather 44.1k->44.101k q7", (44100, 44101), (44100, 44101), 7,
             44100, (30000, 20000, 40000), (44100,), fm,
             "speex_resampler_tpu_torch/csrc/gather_fir.cu",
             "speex_resampler_tpu/ops/fir_matmul.py:120", "gather")
DRIFT_FIXED = Path("gather fixed 44.1k->44.101k q7", (44100, 44101),
                   (44100, 44101), 7, 44100, (30000, 20000, 40000), (44100,),
                   fm, "speex_resampler_tpu_torch/csrc/gather_fir.cu",
                   "speex_resampler_tpu/ops/fir_matmul.py:270", "gather",
                   fixed=True)
# a steep gather decimation (N 11496, outputs 239.4 rows apart): its band
# (K 15104 taps a 16-output tile) is too wide to be resident, so the plan
# takes the stream form; 96000-frame quanta: 210000 frames = 2
# launches + 18000 staged (f0 -> 206).  Its small taps cannot drive a
# fixed sum past 2^31.
STEEP = Path("gather 96k->401 q3", (96000, 401), (96000, 401), 3, 44100,
             (100000, 60000, 50000), (96000,), fm,
             "speex_resampler_tpu_torch/csrc/gather_fir.cu",
             "speex_resampler_tpu/ops/fir_matmul.py:120", "gather")
STEEP_FIXED = Path("gather fixed 96k->401 q3", (96000, 401), (96000, 401), 3,
                   44100, (100000, 60000, 50000), (96000,), fm,
                   "speex_resampler_tpu_torch/csrc/gather_fir.cu",
                   "speex_resampler_tpu/ops/fir_matmul.py:270", "gather",
                   fixed=True, wrap=False)
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
# the tensor cores, int8, bf16 and TF32 tensor-core operations
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
INT8_OPS = 1979e12
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12


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


def launch_bound(spec, step, bspec, B: int, form: str | None = None):
    """(bound_ms, bound_by, bytes, operations, needed multiply-adds, band
    multiply-adds) of one launch.  The bound counts the work the function
    needs, not the work the kernel's tiling walks: filt_len multiply-adds
    per output sample (times n_accum, the weight column sets or tap rows,
    for "fixed"); the input rows the outputs' windows span (each output j
    reads filt_len rows of hist ++ x from (f0 + j*num) // den + H -
    (filt_len - 1); dense and gather steps: H = filt_len - 1, shift 0); the
    nonzero weights once ("int8": D digit bytes each, and the bias;
    "fixed": 2 bytes each, and the int32 cubic coefficients; "split5": 2
    bytes per nonzero entry of each bf16 plane; gather: every output's tap
    row, f32 or int16, and the coefficients); y.  It is the larger of the
    bytes over HBM and the operations over the peak of their type (f32 FMA
    = 2 FLOP on the CUDA cores for "highest", the float gather's too; for
    "int8", 2*D int8 products per multiply-add, an int16 sample being two
    int8 digits; for "fixed", an int16 x int16 multiply-add is 4 int8
    products, 8 operations; both on the int8 tensor cores; for "split5", 5
    bf16 products, 10 FLOP, on the bf16 tensor cores).  The band
    multiply-adds, returned beside it, are those the kernel walks: each
    row tile's nonzero tap band (64 rows; "fixed": the fixed CTA's
    ``tiled_fir.FIXED_ROWS``; times n_accum), K_pad padding skipped; for
    "highest", each 16-row sub-band's 8-tap slices (``tiled_fir.f32_walk``;
    the dense kernel's too); for a gather in the rows form (``form``, the
    step's own by default), the row loop's (row, output) slots: each
    warp's start spread + filt_len rows for each of its outputs; in the
    band and stream forms, the band's: every group's (fixed: times
    n_accum) or 16-output tile's (float) outputs, the last padded, times
    its K taps (``csrc/gather_fir.cu``)."""
    n_out, N = bspec.out_per_launch, spec.filt_len
    fixed = step.scheme == "fixed"
    n_accum = n_accum_of(step)
    macs = n_out * N * B * n_accum
    shift = step.hist_rows - (N - 1)
    first = bspec.f0 // spec.den + shift
    last = (bspec.f0 + (n_out - 1) * spec.num) // spec.den + shift + N
    if step.kernel == "gather":
        starts = step.w[1].cpu().numpy().astype(np.int64)
        first, last = starts[0], starts[-1] + N
        w_bytes = sum(t.numel() * t.element_size() for t in step.w
                      if t is not step.w[1])
        ops = (8 if fixed else 2) * macs
    elif step.kernel == "dense" and fixed:   # the int16 taps [L_pad, C]
        w_bytes = (int((step.w.w16 != 0).sum()) * 2
                   + (step.w.coef.numel() * 4 if n_accum == 4 else 0))
        ops = 8 * macs
    elif step.scheme == "int8":
        D = step.w[0].shape[0]
        w_bytes = (int((step.w[0] != 0).any(0).sum()) * D
                   + step.w[1].numel() * 4)
        ops = 2 * (2 * D) * macs
    elif fixed:                                   # planes [2, P, C, K_pad]
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
    if step.kernel == "gather":
        plan = gather_kw(step, form)["plan"]
        if plan.form != "rows":
            G = plan.outputs if fixed else 16
            band_macs = -(-n_out // G) * G * plan.taps * B * n_accum
        else:
            kO = plan.outputs // 8
            lo = np.arange(0, n_out, kO)
            spread = starts[np.minimum(lo + kO, n_out) - 1] - starts[lo]
            band_macs = int(((spread + N) * kO).sum()) * B * n_accum
    else:
        taps = step.w[-1].cpu().numpy()
        if step.scheme == "highest":
            band, rows = tf.f32_walk(taps), tf.SUB_ROWS   # [P, sub-bands]
        else:
            band = (taps[..., 1] - taps[..., 0]).astype(np.int64)
            rows = (tf.FIXED_ROWS[n_accum] if fixed
                    else bspec.R // taps.shape[1])
        k = np.arange(bspec.n_blocks)
        band_macs = (int(band[k % max(bspec.P, 1)].sum()) * rows * B
                     * n_accum)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    peak = (FP32_FLOPS if step.scheme == "highest" else
            BF16_FLOPS if step.scheme == "split5" else INT8_OPS)
    t_ops = ops / peak * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, nbytes, ops, macs, band_macs


def library_call(step, bspec, hist, x, reps: int):
    """One torch.bmm (TF32 off) of the block weights against the patches,
    both gathered outside the timed region: the product only, no WORD2INT
    (dense: one torch.matmul of W^T, its R columns, against every block's
    patch; fixed dense: the same in float64, the exact int16 dots of the
    plain version; tiled and streamed "fixed": one float64 bmm of the int16
    taps against the patches, :func:`fixed_library_call`; gather: one
    torch.sparse.mm of the banded tap matrix, CSR, row o holding taps[o]
    at columns starts[o] .. starts[o] + N - 1, against hist ++ x, in f32
    for the float gather, in float64 for the fixed one, whose four
    accumulator rows an output are four band rows and whose int16 dots are
    then exact; "int8": one float64 bmm of the D digit planes, stacked
    along the output axis, against the patches of x - 128, the exact
    integer digit dots of the plain version, :func:`int8_library_call`).
    Returned as a function, the yardstick of every kernel; the port never
    calls it.  The fixed, int8 and gather products are held against the
    plain version (fixed and int8: bit for bit after the int32 wrap and the
    Q15 epilogue, or the f32 digit epilogue; the float gather's WORD2INT
    within 1 LSB).  For int8, :func:`time_launch` also prints the f32 bmm
    of the same launch beside it.

    split5: the three bf16 planes and the two bf16 parts of x concatenated
    along K as [w_hi, w_hi, w_mid, w_mid, w_lo] . [x_hi, x_lo, x_hi, x_lo,
    x_hi], so one bmm takes the five exact products and sums them in f32:
    a bf16 bmm with an f32 ``out_dtype`` (tensor cores), returned, and an
    f32 bmm of the same operands, timed and printed.  Its WORD2INT is held
    against the plain version (max |err| <= 1)."""
    fixed = step.scheme == "fixed"
    if step.kernel == "gather":
        return gather_library_call(step, hist, x)
    if step.scheme == "int8":
        return int8_library_call(step, bspec, hist, x)
    if fixed and step.kernel != "dense":
        return fixed_library_call(step, bspec, hist, x)
    if step.kernel == "dense":
        dtype = torch.float64 if fixed else torch.float32
        w = step.w.w16 if fixed else step.w[0][:, :step.kernel_kw["R"]]
        wt = w.t().to(dtype).contiguous()
        L, stride = wt.shape[1], step.kernel_kw["stride"]
        rows = (bspec.n_blocks + L // stride) * stride
        virt = torch.cat([hist, x, x.new_zeros((rows, x.shape[1]))])[:rows]
        patch = fm.dense_patches(virt, L, stride).to(dtype).contiguous()
        out = torch.empty((bspec.n_blocks, wt.shape[0], x.shape[1]),
                          dtype=dtype, device="cuda")
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


def fixed_library_call(step, bspec, hist, x):
    """:func:`library_call`'s tiled and streamed "fixed": the int16 taps
    (``tiled_fir.fixed_taps16`` of the planes) of each block's phase in
    float64, [n_blocks, C, K], and each block's patch of hist ++ x ++
    zeros in float64, [n_blocks, K, B], built here on the tensors'
    device; one bmm of the two is the exact int16 dots (every product at
    most 2^30, every sum an integer below 2^53).  Its int32 wrap and Q15
    epilogue are held bit for bit against the plain version here."""
    taps = tf.fixed_taps16(step.w[0])                       # [P, K, C]
    n_accum, (P, K, C), B = n_accum_of(step), taps.shape, x.shape[1]
    nb, dev = bspec.n_blocks, x.device
    phase = torch.arange(nb, device=dev) % P
    v0 = torch.from_numpy(fixed_inputs.block_origins(step)).to(dev)
    virt = torch.cat([hist, x, x.new_zeros((K, B))])
    idx = (v0[:, None] + torch.arange(K, device=dev)[None, :]).clamp(
        max=virt.shape[0] - 1)
    patch = virt[idx].double()                              # [nb, K, B]
    wt = taps[phase].transpose(1, 2).double().contiguous()  # [nb, C, K]
    del virt, idx, taps
    out = torch.empty((nb, C, B), dtype=torch.float64, device=dev)
    torch.bmm(wt, patch, out=out)
    acc = tf.wrap_int32(out)
    got = (sat32pshr15(acc) if n_accum == 1 else fixed_interp_mix_rows(
        acc.view(nb, 4, C // 4, B), step.w[2][phase])).reshape(-1, B)
    d = (got.int() - plain(hist, x, step).int()).abs()
    err, mism = int(d.max()), int((d > 0).sum())
    print(f"library fixed {step.kernel} n_accum {n_accum}: float64 bmm "
          f"[{nb}, {C}, {K}] x [{nb}, {K}, {B}], wrapped, Q15 epilogue, vs "
          f"plain max|err|={err} mismatches={mism} of {d.numel()}")
    del acc, got, d
    if mism:
        raise AssertionError(f"fixed library bmm: {mism} mismatches")
    return lambda: torch.bmm(wt, patch, out=out)


def int8_library_call(step, bspec, hist, x):
    """:func:`library_call`'s "int8" (tiled and streamed):
    :func:`int8_exact_bmm` at the step's block origins, held against its
    plain version."""
    v0 = torch.from_numpy(fixed_inputs.block_origins(step)).to(x.device)
    return int8_exact_bmm(hist, x, step.w, v0, step.kernel_kw["scales"],
                          plain(hist, x, step), step.kernel)


def int8_exact_bmm(hist, x, w, v0, scales, want, what: str, raw=False):
    """One float64 bmm of an int8 launch: the digit planes ``w[0]`` in tap
    order (``tiled_fir.int8_n_major``) of each block's phase, the D digits
    stacked along the output axis, [n_blocks, D * R, K], and each block's
    patch of hist ++ x ++ zeros from its origin ``v0`` less 128,
    [n_blocks, K, B], built here on the tensors' device; the bmm of the
    two is every exact integer digit dot sum w_d * (x - 128) (each below
    2^31, as the certificate holds).  Its f32 epilogue (the dots to int32,
    then scaled and summed in digit order, plus the bias ``w[1]``, then
    WORD2INT) is held bit for bit against ``want``, the plain version's
    int16 [n_blocks * R, B].  ``raw``: P5's raw variants, the summed
    planes, [n_blocks, R, K], against the patches of xh + xl
    (``v3_overhead_anatomy.split``), wrapped to int16."""
    planes = tf.int8_n_major(w[0])                          # [D, P, K, R]
    (D, P, K, R), B, dev = planes.shape, x.shape[1], x.device
    nb = v0.shape[0]
    phase = torch.arange(nb, device=dev) % P
    virt = torch.cat([hist, x, x.new_zeros((K, B))])
    idx = (v0[:, None] + torch.arange(K, device=dev)[None, :]).clamp(
        max=virt.shape[0] - 1)
    if raw:
        xh, xl = pv3.split(virt[idx])
        patch = (xh + xl).double()                          # [nb, K, B]
        wt = planes.double().sum(0)[phase].transpose(1, 2).contiguous()
    else:
        patch = virt[idx].double() - 128.0                  # [nb, K, B]
        wt = planes[:, phase].permute(1, 0, 3, 2).reshape(
            nb, D * R, K).double().contiguous()             # [nb, D R, K]
    del planes, virt, idx
    out = torch.empty((nb, wt.shape[1], B), dtype=torch.float64, device=dev)
    torch.bmm(wt, patch, out=out)
    if raw:
        got = pv3.wrap16(out).reshape(-1, B)
    else:
        dots = out.view(nb, D, R, B)
        acc = torch.zeros((nb, R, B), dtype=torch.float32, device=dev)
        for d, s in enumerate(scales):
            acc = acc + dots[:, d].to(torch.int32).float() * s
        got = word2int(acc + w[1][phase][:, :, None]).reshape(-1, B)
        del acc
    d = (got.int() - want.int()).abs()
    err, mism = int(d.max()), int((d > 0).sum())
    print(f"library int8 {what} D={D}: float64 bmm [{nb}, {wt.shape[1]}, "
          f"{K}] x [{nb}, {K}, {B}], "
          f"{'wrapped to int16' if raw else 'f32 digit epilogue'}, vs plain "
          f"max|err|={err} mismatches={mism} of {d.numel()}")
    del got, d
    if mism:
        raise AssertionError(f"int8 library bmm: {mism} mismatches")
    return lambda: torch.bmm(wt, patch, out=out)


def int8_probe_library_call(family: str, variant: str, hist, x, w, kw):
    """The exact library call (:func:`int8_exact_bmm`) of an int8 probe
    launch, held against the probe's plain version: P5's variants
    (``family`` "v3_anatomy": K1b's function at each variant's patch
    origins, the raw variants no_epilogue and dots_only the summed
    planes' dots wrapped to int16) and P9a ("v5_bench": K1b's function
    without the halo; ``hist`` is None)."""
    if family == "v5_bench":
        hist = x.new_zeros((0, x.shape[1]))
        P = w[0].shape[1]
        k = torch.arange(kw["n_blocks"], device=x.device)
        v0 = (k // P) * kw["S"] + kw["offsets"].long()[k % P]
        want = pv5.bench_reference("int8", x, w, **kw)
    else:
        v0 = pv3._origins(variant, kw["offsets"], kw["S"], kw["n_blocks"])
        want = pv3.anatomy_reference(variant, hist, x, w, **kw)
    return int8_exact_bmm(hist, x, w, v0, kw["scales"], want,
                          f"{family} {variant}",
                          raw=variant in ("no_epilogue", "dots_only"))


def gather_library_call(step, hist, x):
    """:func:`library_call`'s gather: the CSR band and hist ++ x built
    here, the product checked against the plain version here."""
    fixed = step.scheme == "fixed"
    taps, starts = step.w[0], step.w[1]
    N, n_out = taps.shape[-1], starts.numel()
    rows = taps.numel() // N                    # n_out, or 4 n_out
    virt = torch.cat([hist, x[:step.chunk_rows]])           # [T, B]
    dtype = torch.float64 if fixed else torch.float32
    cols = (starts.repeat_interleave(rows // n_out)[:, None]
            + torch.arange(N, device="cuda", dtype=torch.int32))
    band = torch.sparse_csr_tensor(
        torch.arange(rows + 1, device="cuda", dtype=torch.int32) * N,
        cols.reshape(-1), taps.reshape(-1).to(dtype),
        size=(rows, virt.shape[0]), check_invariants=True)
    X = virt.to(dtype)
    del cols, virt
    y = torch.sparse.mm(band, X)                            # [rows, B]
    if fixed:
        acc = tf.wrap_int32(y).view(n_out, rows // n_out, -1)
        got = (sat32pshr15(acc[:, 0]) if rows == n_out else
               fixed_interp_mix_rows(acc[:, :, None, :],
                                     step.w[2][:, :, None])[:, 0])
    else:
        got = word2int(y)
    d = (got.t().int() - plain(hist, x, step).int()).abs()
    err, mism = int(d.max()), int((d > 0).sum())
    print(f"library {'fixed ' if fixed else ''}gather: torch.sparse.mm of "
          f"the CSR band ({band.values().numel()} taps, {dtype}) vs plain "
          f"max|err|={err} mismatches={mism} of {d.numel()}")
    del y, got, d
    if err > (0 if fixed else 1):
        raise AssertionError(f"gather library sparse.mm: max|err| {err}")
    return lambda: torch.sparse.mm(band, X)


def kernel_of(symbol: str) -> str:
    """A kernel's name (with its type, int and bool template arguments)
    from its mangled symbol, else the symbol."""
    m = re.search(r"\d+((?:tiled|streamed|dense|gather)_fir_\w+?_kernel|"
                  r"(?:tc_rate|int8_anatomy|fixed_anatomy|partial_sum|"
                  r"v3_anatomy|v3_split|f32_anatomy|prec_tc|"
                  r"prec_f32|v5_int8|v5_split5|batched_mloop|"
                  r"batched_patch|batched_product)_kernel)"
                  r"(I((?:[sf]|L[ib]\d+E)+)E)?", symbol)
    if m is None:
        return symbol
    if not m.group(2):
        return m.group(1)
    args = [{"s": "short", "f": "float"}[ty] if ty
            else v if t == "i" else ("true" if v == "1" else "false")
            for ty, t, v in re.findall(r"([sf])|L([ib])(\d+)E",
                                       m.group(3))]
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


def gmma_counts(lib) -> dict:
    """{(kernel, "IGMMA" | "HGMMA" | "FFMA" | "FADD" | "DFMA" | "DMMA"):
    wgmma, f32 FMA, f32 add, f64 FMA and f64 mma.sync instructions} in a
    built library's SASS
    (``cuobjdump -sass``, which ships with the CUDA toolkit beside nvcc);
    raises if the tool is missing or fails."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        raise AssertionError("SASS check: cuobjdump not found")
    res = subprocess.run([tool, "-sass", str(lib)],
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
        elif name:
            f = re.search(r"\b(FFMA|FADD|DFMA|DMMA)\b", line)
            if f:
                key = (name, f.group(1))
                counts[key] = counts.get(key, 0) + 1
    return counts


def sass_check() -> None:
    """Counts the tensor-core (wgmma) instructions of each split5 (HGMMA),
    int8 and fixed (IGMMA; the fixed band and stream gathers too) kernel in
    the built library's SASS (:func:`gmma_counts`), the f64 FMAs of the
    float rows gather kernels (their dots are double FMA chains) and the
    FP64 tensor-core instructions (DMMA) of the float band and stream
    gather kernels; raises if one of them has none."""
    counts = gmma_counts(_build.lib_path())
    want = [("tiled_fir_split5_kernel", "HGMMA"),
            ("streamed_fir_split5_kernel", "HGMMA")] + [
        (f"{name}<{d}{vec}>", "IGMMA") for d in (1, 2, 3, 4)
        for name, vec in (("tiled_fir_int8_kernel", ", true"),
                          ("tiled_fir_int8_kernel", ", false"),
                          ("tiled_fir_int8_long_kernel", ""),
                          ("streamed_fir_int8_kernel", ""))] + [
        (f"{geo}_fir_fixed_kernel<{n}>", "IGMMA")
        for geo in ("tiled", "streamed", "dense") for n in (1, 4)] + [
        (f"gather_fir_f32_kernel<{t}, {k}>", "DFMA")
        for t in ("short", "float") for k in (1, 2, 4, 8)] + [
        (f"gather_fir_fixed_band_kernel<{n}>", "IGMMA") for n in (1, 4)] + [
        (f"gather_fir_f64mma_kernel<{t}>", "DMMA")
        for t in ("short", "float")] + [
        (f"gather_fir_fixed_stream_kernel<{n}>", "IGMMA") for n in (1, 4)] + [
        ("gather_fir_f64mma_stream_kernel<short>", "DMMA")]
    found = ", ".join(f"{n} {counts.get((n, op), 0)} {op}" for n, op in want)
    print(f"SASS check (cuobjdump -sass, exit 0): {found}")
    if any(counts.get(key, 0) == 0 for key in want):
        raise AssertionError("a tensor-core kernel has no wgmma or DMMA "
                             "instruction or a float rows gather kernel no "
                             "DFMA")


def check_kernels(path: Path, schemes, max_err: dict, kernel=None,
                  only=None) -> None:
    """Kernel against plain, both on the card, at the path's launch, at
    f0 0 and after the flush, B = 2048 and 130, and 129 for "highest",
    "int8" and "fixed" (x rows not 16-byte aligned: 2-byte loads), and 64
    for "int8" and "fixed" (one 64-lane CTA tile); fixed with the wrap
    input on every third lane, int8 with rows of -32768 and 32767.
    ``kernel`` overrides the geometry: "streamed" feeds a tiled direct
    filter's weights to the streamed kernel.  A gather runs its forms
    (:func:`gather_forms`, or those ``only`` names), each forced through
    an explicit plan (:func:`gather_kw`), at every B of 2048 / 130 / 129
    / 64, the float one's raw f32 sums also held within one f32 rounding
    of the plain version's."""
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
            n_accum = n_accum_of(step)
            lanes = (LANES, 130) + {"highest": (129,), "int8": (129, 64),
                                    "fixed": (129, 64)}.get(step.scheme, ())
            forms = (None,)
            if step.kernel == "gather":
                lanes = (LANES, 130, 129, 64)
                forms = only or gather_forms(step)
            for form, B in ((f, b) for f in forms for b in lanes):
                hist, x = card_inputs(step, bspec.in_per_launch, B,
                                      seed=B + f0, wrap=path.wrap,
                                      edges=step.scheme == "int8")
                got = launch(hist, x, step, form)
                want = plain(hist, x, step)
                torch.cuda.synchronize()
                what = f"{path.name} {scheme} {form or ''} f0={f0} B={B}"
                err, mism = compare(got.cpu().numpy(), want.cpu().numpy(),
                                    step.scheme, what)
                key = kernel_key(step, form)
                max_err[key] = max(max_err.get(key, 0), err)
                print(f"kernel vs plain: {path.name} {scheme:7s} -> "
                      f"{kernel_name(*key)} D={D} f0={f0:3d} B={B:4d} "
                      f"n_blocks={bspec.n_blocks} max|err|={err} "
                      f"mismatches={mism} {ties(mism, got.numel())}")
                if step.kernel == "gather" and not path.fixed:
                    kw = dict(gather_kw(step, form), hist=hist.t(), raw=True)
                    g = fm.resample_gather(x[:step.chunk_rows].t(), *step.w,
                                           **kw)
                    w = fm.resample_gather_reference(
                        torch.cat([hist, x[:step.chunk_rows]]).t(), *step.w,
                        raw=True)
                    ulp = torch.abs(torch.nextafter(w, w + 1) - w)
                    if not bool(((g - w).abs() <= ulp).all()):
                        raise AssertionError(f"{what}: raw sums off by more "
                                             f"than one f32 rounding")


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
    before and read just after (the path's kernel once per engine launch,
    no other module's kernel), its step's tensors on the card; streams 0-3
    against a CPU engine.  Returns (counts, engines by resolved scheme,
    frames)."""
    rng = np.random.default_rng(2024)
    frames = [rng.integers(-32768, 32768, (STREAMS, n, CHANNELS),
                           dtype=np.int16)
              for n in path.frames + path.after]
    reset_launches()
    engines, outs, walls = {}, {}, {}
    for request, scheme in requests.items():
        t0 = time.time()
        eng, outs[scheme] = serve_engine(path, request, frames)
        walls[scheme] = time.time() - t0
        if eng._step.scheme != scheme or eng._step.kernel != path.kernel:
            raise AssertionError(f"{path.name}: {request} built "
                                 f"{eng._step.kernel}/{eng._step.scheme}")
        engines[scheme] = eng
    counts = dict(path.module.launches)
    for kind, module in MODULES.items():
        if module is not path.module and any(module.launches.values()):
            raise AssertionError(f"{path.name} launched {module.launches} "
                                 f"of the {kind} geometry's kernels")
    if not all(t.is_cuda for e in engines.values() for t in e._step.w
               if isinstance(t, torch.Tensor)):
        raise AssertionError(f"{path.name}: step tensors off the card")
    if "int8" in engines and engines["int8"]._step.w[0].shape[0] \
            != want_digits:
        raise AssertionError(f"auto resolved int8 D="
                             f"{engines['int8']._step.w[0].shape[0]}")
    n = len(path.frames)
    # a gather's launches in the form its engine's step was built with
    launched = {(fm.launch_key(s, e._step.kernel_kw["plan"].form)
                 if path.kernel == "gather" else s): e.launches
                for s, e in engines.items()}
    if any(counts[s] != launched.get(s, 0) for s in counts) \
            or not any(counts.values()) or min(launched.values()) < n:
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


# the measured int8 tensor-core rates, multiply-adds/s with a shared
# fragment, by wgmma N (PERF.md section 5: P1's N 32 and 64 on the H100)
INT8_MEASURED = {32: 523.7e12, 64: 675.7e12}


def time_launch(label: str, spec, step, bspec, smi: str, reps: int,
                form: str | None = None):
    """Kernel, plain and library times of one launch at B = 2048 (library:
    :func:`library_call`, where one PyTorch call computes the product);
    kernel and library also from a CUDA graph of ``reps`` launches, the
    kernel also one launch at a time (:func:`cuda_ms`); the plain gathers,
    ~0.1-0.3 s a launch, in groups of 2.  ``form`` forces a gather's form
    (:func:`gather_kw`); the fixed band's walked band is also put at the
    measured int8 rate (:data:`INT8_MEASURED`), the float band's as the
    DMMA rate it reached.  Returns the JSON entry's numbers."""
    out_samples = bspec.out_per_launch * LANES
    hist, x = card_inputs(step, bspec.in_per_launch, LANES, seed=7)
    run = kernel_call(hist, x, step, form=form)
    ms = cuda_ms(run, reps)
    graph_ms = cuda_ms(run, reps, mode="graph")
    host_ms = cuda_ms(run, reps, mode="host")
    plain_ms = cuda_ms(kernel_call(hist, x, step, reference=True),
                       2 if step.kernel == "gather" else reps)
    library_ms = library_graph_ms = f32_bmm_ms = None
    lib_fn = library_call(step, bspec, hist, x, reps)
    if lib_fn is not None:
        library_ms = cuda_ms(lib_fn, reps)
        library_graph_ms = cuda_ms(lib_fn, reps, mode="graph")
        del lib_fn
    if step.scheme == "int8":
        f32_bmm_ms = int8_yardstick(spec, step, bspec, hist, x, reps)
    bound_ms, bound_by, nbytes, ops, macs, band_macs = launch_bound(
        spec, step, bspec, LANES, form)
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
    if step.kernel == "gather" and gather_kw(step, form)["plan"].form \
            != "rows":
        if step.scheme == "fixed":    # four int8 products a multiply-add
            n = 64 if n_accum_of(step) == 4 else 32
            print(f"  band at the measured int8 rate (N {n}, "
                  f"{INT8_MEASURED[n] / 1e12:.1f} T): "
                  f"{4 * band_macs / INT8_MEASURED[n] * 1e3:.4f} ms")
        else:
            print(f"  band DMMA rate: {band_macs / ms / 1e9:.2f} T f64 "
                  f"multiply-adds/s back to back, "
                  f"{band_macs / graph_ms / 1e9:.2f} in a graph")
    nums = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms, graph_ms=graph_ms,
                library_graph_ms=library_graph_ms, host_ms=host_ms)
    if f32_bmm_ms is not None:
        nums["f32_bmm_ms"] = f32_bmm_ms
    return nums


def int8_yardstick(spec, step, bspec, hist, x, reps: int) -> float:
    """The output-equal yardstick of an int8 launch, beside its exact
    library call (:func:`int8_library_call`): the f32 bmm of the same
    launch, the
    "highest" step's weights against the patches (TF32 off), timed; its
    WORD2INT against the int8 plain version within 1 LSB (the mismatches
    printed beside the tie bound).  Returns its ms a launch back to
    back."""
    hstep = tb.make_batched_step(spec, bspec, device="cuda",
                                 scheme="highest")
    fn = library_call(hstep, bspec, hist, x, reps)
    d = (word2int(fn()).reshape(-1, x.shape[1]).int()
         - plain(hist, x, step).int()).abs()
    err, mism = int(d.max()), int((d > 0).sum())
    ms, graph_ms = cuda_ms(fn, reps), cuda_ms(fn, reps, mode="graph")
    print(f"  int8 yardstick: the f32 bmm of the same launch {ms:.4f} ms "
          f"(graph {graph_ms:.4f}), its WORD2INT vs the int8 plain version "
          f"max|err|={err} mismatches={mism} {ties(mism, d.numel())}")
    if err > 1:
        raise AssertionError(f"int8 yardstick: max|err| {err}")
    return ms


def time_path(path: Path, schemes, smi: str, counts: dict, max_err: dict,
              engines: dict, frames: list, reps: int, unlisted=()) -> list:
    """Kernel, plain and library times at the path's steady-state launch
    (B = 2048), and one steady-state process() call of one quantum.  The
    ``unlisted`` schemes are timed and printed but not listed (another
    path's entry lists their kernel)."""
    bspec = path.geometry()
    out_samples = bspec.out_per_launch * LANES
    entries, ms = [], {}
    for scheme in schemes + unlisted:
        step = tb.make_batched_step(path.spec, bspec, device="cuda",
                                    scheme=scheme)
        forms = gather_forms(step) if step.kernel == "gather" else (None,)
        for form in forms:
            key = kernel_key(step, form)
            D = step.w[0].shape[0] if step.scheme == "int8" else 0
            nums = time_launch(f"{path.name} {scheme:7s} "
                               f"({kernel_name(*key)} D={D})", path.spec,
                               step, bspec, smi, reps, form)
            ms[step.scheme] = nums["ms"]
            if scheme in unlisted:
                continue
            n = counts[fm.launch_key(step.scheme, form) if form
                       else step.scheme]
            entries.append({
                "name": kernel_name(*key), "route": "cuda",
                "source": path.source,
                "replaces": REPLACES.get(key[:2], path.replaces),
                "launches": n, "max_abs_err": max_err[key], **nums})
    if "split5" in ms and "highest" in ms:
        print(f"split5 / highest at {path.name} on {smi}: "
              f"{ms['split5']:.4f} / {ms['highest']:.4f} ms = "
              f"{ms['split5'] / ms['highest']:.3f}")
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
    reset_launches()
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


# -- phase 7: the single-stream layer ------------------------------------

# the reference integration matrix (tests/conftest.py AUDIO_TESTS,
# src/test.ts:14-22): (channels, in_rate, out_rate, quality)
SINGLE = [(1, 24000, 48000, 5), (2, 24000, 24000, 5), (2, 24000, 48000, 10),
          (2, 44100, 48000, 7), (2, 44100, 48000, 10), (2, 44100, 48000, 1),
          (2, 44100, 24000, 5)]
SINGLE_SECONDS = 10
SINGLE_CHUNK = 1024           # frames a process_chunk call, chunked runs


def stream_pcm(channels: int, rate: int, seed: int,
               seconds: float = SINGLE_SECONDS) -> bytes:
    rng = np.random.default_rng(seed)
    return rng.integers(-32768, 32768, (int(seconds * rate), channels),
                        dtype=np.int16).astype("<i2").tobytes()


def run_chunks(r, pcm: bytes, chunk_frames: int) -> bytes:
    """One shot (chunk_frames 0) or chunk_frames a process_chunk call."""
    if not chunk_frames:
        return r.process_chunk(pcm)
    step = chunk_frames * r.channels * 2
    return b"".join(r.process_chunk(pcm[a:a + step])
                    for a in range(0, len(pcm), step))


def check_device_core(core, what: str) -> None:
    """The core took the device route on the card and did not degrade."""
    if core._host_route or core.fixed_point or core.device.type != "cuda":
        raise AssertionError(f"{what}: host route or device "
                             f"{core.device}")
    if core.degraded:
        raise AssertionError(f"{what}: degraded: {core.degraded_cause!r}")
    if not all(w.is_cuda for w in core._weights._cache.values()):
        raise AssertionError(f"{what}: weights off the card")


def lsb_check(got: bytes, want: bytes, what: str) -> str:
    g, w = (np.frombuffer(b, dtype="<i2") for b in (got, want))
    err, mism = compare(g, w, "highest", what)
    return f"max|err|={err} mismatches={mism} {ties(mism, w.size)}"


def single_stream_check(seconds: float = SINGLE_SECONDS) -> None:
    """The integration matrix through SpeexResampler.process_chunk, one
    shot and in 1024-frame chunks: the device route on the card against
    the host route (the reference float build's bits) within 1 LSB under
    the tie bound; the default route runs the native loops; 16- and
    64-channel cores (auto: the device route), the gather route, the
    fixed universe (bit-exact against device="cpu") and the TF32 guard.
    The matmul route is plain torch on the card; the gather route launches
    the gather kernel (counted, at least once; its rows form, its x an f32
    [channels, T] array read by element); no other kernel of MODULES
    launches.  Returns the gather launches."""
    reset_launches()
    gathers = 0
    for i, (c, ir, orr, q) in enumerate(SINGLE):
        pcm = stream_pcm(c, ir, 100 + i, seconds)
        for chunk in (0, SINGLE_CHUNK):
            outs = {}
            for engine in ("host", "device"):
                r = SpeexResampler(c, ir, orr, q, engine=engine,
                                   device="cuda")
                outs[engine] = run_chunks(r, pcm, chunk)
                if engine == "device":
                    check_device_core(r._core, f"{ir}->{orr} q{q}")
            what = (f"single {c}ch {ir}->{orr} q{q} "
                    f"{'chunks of %d' % chunk if chunk else 'one shot'}")
            print(f"{what}: device vs host route "
                  f"{lsb_check(outs['device'], outs['host'], what)}, "
                  f"{len(outs['host']) // 2 // c} frames out")
    # the default route (auto, stereo): the native host loops
    loops = dict(fir_exact.loops)
    r = SpeexResampler(2, 44100, 48000, 7)
    out = run_chunks(r, stream_pcm(2, 44100, 7, seconds), SINGLE_CHUNK)
    native = fir_exact.loops["native"] - loops["native"]
    numpy_loops = fir_exact.loops["numpy"] - loops["numpy"]
    if not r._core._host_route or native == 0 or numpy_loops:
        raise AssertionError(f"default route: host {r._core._host_route}, "
                             f"native {native}, numpy {numpy_loops}")
    print(f"single default route (auto, stereo): host loops, {native} "
          f"native calls, {numpy_loops} NumPy, {len(out) // 4} frames out")
    # wide cores (auto -> device), the gather route, the TF32 guard
    for c, ir, orr, engine, tf32 in ((16, 44100, 48000, "auto", False),
                                     (64, 44100, 48000, "auto", False),
                                     (2, 44100, 44101, "device", False),
                                     (16, 44100, 48000, "auto", True)):
        pcm = stream_pcm(c, ir, c + orr, seconds)
        host = run_chunks(SpeexResampler(c, ir, orr, 7, engine="host"),
                          pcm, SINGLE_CHUNK)
        r = SpeexResampler(c, ir, orr, 7, engine=engine, device="cuda")
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        before = fm.launches["highest"]
        try:
            got = run_chunks(r, pcm, SINGLE_CHUNK)
            if torch.backends.cuda.matmul.allow_tf32 is not tf32:
                raise AssertionError("the TF32 flag was not restored")
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
        check_device_core(r._core, f"{c}ch {ir}->{orr}")
        route = ("gather" if orr == 44101 else "matmul")
        ran = fm.launches["highest"] - before
        if (ran > 0) != (route == "gather"):
            raise AssertionError(f"{route} route: {ran} gather launches")
        gathers += ran
        what = (f"single {c}ch {ir}->{orr} q7 {engine} ({route}"
                f"{', TF32 on around it' if tf32 else ''}"
                f"{f', {ran} gather kernel launches' if ran else ''})")
        print(f"{what}: device vs host route {lsb_check(got, host, what)}")
    pcm = stream_pcm(2, 44100, 5, seconds)
    fixed = [run_chunks(SpeexResampler(2, 44100, 48000, 7, fixed_point=True,
                                       device=d), pcm, SINGLE_CHUNK)
             for d in ("cuda", "cpu")]
    if fixed[0] != fixed[1]:
        raise AssertionError("fixed universe: cuda and cpu differ")
    print(f"single fixed 2ch 44100->48000 q7: device='cuda' bit-identical "
          f"to device='cpu' ({len(fixed[0]) // 4} frames)")
    if launch_counts() != {"gather": {"highest": gathers}}:
        raise AssertionError(f"single-stream layer launched kernels "
                             f"{launch_counts()}, {gathers} of them by the "
                             f"gather route (the rows form)")
    return gathers


def single_stream_time(smi: str, seconds: float = SINGLE_SECONDS) -> None:
    """process_chunk out samples/s, host against device route, at 2, 8,
    16 and 64 channels, 44.1k -> 48k q7, 1024-frame chunks and one shot
    (the first run of each warms up)."""
    for c in (2, 8, 16, 64):
        pcm = stream_pcm(c, 44100, c, seconds)
        row = []
        for engine in ("host", "device"):
            for chunk in (SINGLE_CHUNK, 0):
                walls = []
                for _ in range(3):
                    r = SpeexResampler(c, 44100, 48000, 7, engine=engine,
                                       device="cuda")
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = run_chunks(r, pcm, chunk)
                    walls.append(time.perf_counter() - t0)
                wall = float(np.median(walls[1:]))
                rate = len(out) // 2 / wall
                row.append(f"{engine} {'chunks' if chunk else 'one shot'} "
                           f"{rate / 1e6:.2f} M/s")
        print(f"single-stream timing {c}ch 44100->48000 q7 on {smi}: "
              f"out samples/s {', '.join(row)} ({seconds} s of audio, "
              f"median of 2 after one)")


# -- phase 8: MultiFleet at full width ------------------------------------

MF_CONFIGS = [(44100, 48000, 7), (24000, 48000, 5), (48000, 44100, 10),
              (44100, 24000, 5)]
MF_TARGET = 2048
MF_ROUNDS = 10


def multifleet_run(fixed: bool, per: int, smi: str, rounds: int,
                   checked: set):
    """``per`` stereo streams a bucket over the four buckets, one quantum a
    stream a round: a warm-up round, one end_stream (b0s4), one add_stream
    ("fresh", bucket 0) and one exact set_stream_rate (b0s5 to bucket 1's
    config), two more rounds, ``rounds`` timed rounds, then flush.  A CPU
    MultiFleet makes the same calls on the ``checked`` streams, outside
    the timed regions.  Returns (card fleet, card outputs, CPU outputs by
    stream id)."""
    mf = MultiFleet(CHANNELS, capacity_per_bucket=per + 1,
                    target_chunk_frames=MF_TARGET, fixed_point=fixed)
    ref = MultiFleet(CHANNELS, capacity_per_bucket=8,
                     target_chunk_frames=MF_TARGET, device="cpu",
                     fixed_point=fixed)
    cfg_of = {f"b{b}s{i}": MF_CONFIGS[b] for b in range(len(MF_CONFIGS))
              for i in range(per)}
    for sid, cfg in cfg_of.items():
        mf.add_stream(sid, *cfg)
        if sid in checked:
            ref.add_stream(sid, *cfg)
    if mf._buckets[MF_CONFIGS[0]].fleet.stager_kind != "native":
        raise AssertionError("multifleet stager not native")
    q = {cfg: mf._buckets[cfg].fleet.bspec.in_per_launch
         for cfg in MF_CONFIGS}
    rng = np.random.default_rng(31 + fixed)
    outs = {sid: [] for sid in checked}
    ref_outs = {sid: [] for sid in checked}

    def row(sid):
        # "fresh" and the switched stream take the spare rows
        return per + 1 if sid in ("fresh", "b0s5") else int(sid[3:])

    def round_(times=None):
        blocks = {cfg: rng.integers(-32768, 32768,
                                    (per + 2, q[cfg], CHANNELS),
                                    dtype=np.int16) for cfg in MF_CONFIGS}
        t0 = time.perf_counter()
        for sid, cfg in cfg_of.items():
            mf.push(sid, blocks[cfg][row(sid)])
        t1 = time.perf_counter()
        n = mf.poll()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        pulled = 0
        for sid in cfg_of:
            y = mf.pull(sid)
            pulled += y.shape[0]
            if sid in checked:
                outs[sid].append(y)
        t3 = time.perf_counter()
        for sid in checked & cfg_of.keys():
            ref.push(sid, blocks[cfg_of[sid]][row(sid)])
        ref.poll()
        for sid in checked & cfg_of.keys():
            ref_outs[sid].append(ref.pull(sid))
        if times is not None:
            times.append((t1 - t0, t2 - t1, t3 - t2, pulled, n))

    round_()
    for m, o in ((mf, outs), (ref, ref_outs)):
        m.end_stream("b0s4")
        o["b0s4"].append(m.pull("b0s4"))
        m.add_stream("fresh", *MF_CONFIGS[0])
        m.set_stream_rate("b0s5", *MF_CONFIGS[1])
    del cfg_of["b0s4"]
    cfg_of["fresh"] = MF_CONFIGS[0]
    cfg_of["b0s5"] = MF_CONFIGS[1]
    for _ in range(2):
        round_()
    times = []
    for _ in range(rounds):
        round_(times)
    for m, o in ((mf, outs), (ref, ref_outs)):
        m.flush()
        for sid in o:
            if sid in cfg_of:
                o[sid].append(m.pull(sid))
    push, poll, pull, out, n = (np.array(v) for v in zip(*times))
    samples = int(out.sum()) * CHANNELS
    wall = float((push + poll + pull).sum())
    print(f"multifleet {'fixed' if fixed else 'float'} on {smi}: "
          f"{len(cfg_of)} stereo streams over {len(MF_CONFIGS)} buckets, "
          f"{rounds} timed rounds of one quantum a stream: "
          f"{samples / wall / 1e6:.2f} M out samples/s ("
          f"{wall * 1e3 / rounds:.2f} ms a round, the CPU reference's "
          f"calls excluded); card ms a round: push "
          f"{push.mean() * 1e3:.2f}, poll {poll.mean() * 1e3:.2f}, pull "
          f"{pull.mean() * 1e3:.2f} (min {push.min() * 1e3:.2f} / "
          f"{poll.min() * 1e3:.2f} / {pull.min() * 1e3:.2f}); "
          f"{int(n.sum())} launches in the timed rounds")
    print(f"  bucket stats (whole run) {json.dumps(mf.stats())}")
    return mf, outs, ref_outs


def multifleet_check(fixed: bool, smi: str, per: int = STREAMS // 4,
                     rounds: int = MF_ROUNDS) -> dict:
    """Phase 8 in one universe, its kernel launches counted from 0: every
    bucket's kernel launched (the kernel counts equal the buckets' launch
    counts), no bucket degraded, the checked streams (0-3 and the last of
    each bucket, the ended, the switched and the fresh stream)
    bit-identical to the CPU MultiFleet fed the same frames.  Returns the
    run's launches by kernel name."""
    checked = {f"b{b}s{i}" for b in range(len(MF_CONFIGS))
               for i in (0, 1, 2, 3, per - 1)} | {"b0s4", "b0s5", "fresh"}
    reset_launches()
    mf, outs, ref_outs = multifleet_run(fixed, per, smi, rounds, checked)
    counts = {k: dict(m.launches) for k, m in MODULES.items()}
    if mf.degraded or any(mf.degraded_buckets().values()):
        raise AssertionError(f"multifleet degraded: {mf.degraded_buckets()}")
    by_kernel: dict = {}
    by_scheme: dict = {}
    for cfg, b in mf._buckets.items():
        fleet, step = b.fleet, b.fleet._step
        key = (fleet.bspec.kernel, step.scheme,
               n_accum_of(step))
        n = fleet.stats.launches
        if n <= 0:
            raise AssertionError(f"bucket {cfg}: no launch")
        by_kernel[kernel_name(*key)] = by_kernel.get(kernel_name(*key),
                                                     0) + n
        by_scheme[key[:2]] = by_scheme.get(key[:2], 0) + n
        print(f"  bucket {cfg}: {fleet.bspec.kernel} {step.scheme} -> "
              f"{kernel_name(*key)}, quantum {fleet.bspec.in_per_launch} "
              f"frames, {n} launches, degraded {fleet.degraded}")
    ran = {(k, s): n for k, m in counts.items() for s, n in m.items() if n}
    if ran != by_scheme:
        raise AssertionError(f"kernel launches {ran} vs buckets {by_scheme}")
    scheme = "fixed" if fixed else "int8"
    for sid in sorted(checked):
        got, want = (np.concatenate(o[sid]) for o in (outs, ref_outs))
        if got.shape[0] == 0:
            raise AssertionError(f"multifleet stream {sid}: no output")
        compare(got, want, scheme, f"multifleet {scheme} stream {sid}")
    print(f"multifleet {scheme}: kernel launches {by_kernel}; streams "
          f"{sorted(checked)} bit-identical with the cpu MultiFleet")
    return by_kernel


# -- phase 9: the functional step and mesh= at full width -----------------

# (name, rates and quality, target_in_frames, fixed_point, the step's
# geometry and scheme)
FN_CASES = [
    ("flagship int8", (44100, 48000, 7), 9408, False, ("tiled", "int8")),
    ("flagship fixed", (44100, 48000, 7), 9408, True, ("tiled", "fixed")),
    ("48k->44.1k q10 int8", (48000, 44100, 10), 20480, False,
     ("streamed", "int8")),
]
FN_QUANTA = 3                 # eager quanta against the engine
FN_REPLAYS = 4                # graph replays against the eager stage
FN_LANES = list(range(8)) + [LANES - 1]   # held against a CPU step
WINDOW = 256                  # frames a feature window
ARRAY_SECONDS = 10


def window_energies(y: torch.Tensor) -> torch.Tensor:
    """The feature stage: mean square of each full 256-frame window of
    every lane, y int16 [n, B] -> f32 [n // 256, B]."""
    n = (y.shape[0] // WINDOW) * WINDOW
    f = y[:n].float() / 32768.0
    return f.view(-1, WINDOW, y.shape[1]).square().mean(1)


def fn_quanta(rs, k: int, seed: int) -> list:
    """k quanta of seeded PCM, [STREAMS, in_frames, CHANNELS] each."""
    rng = np.random.default_rng(seed)
    return [rng.integers(-32768, 32768, (STREAMS, rs.in_frames, CHANNELS),
                         dtype=np.int16) for _ in range(k)]


def lanes(frames: np.ndarray) -> np.ndarray:
    """[S, n, C] -> time-major lanes [n, S*C] (lane = stream*C + channel)."""
    S, n, C = frames.shape
    return np.ascontiguousarray(frames.transpose(1, 0, 2).reshape(n, S * C))


def functional_check(name, rates, target, fixed, kind) -> tuple:
    """Eager step against the CUDA engine and a CPU step; then the step
    plus the feature stage in one CUDA graph against the eager stage.
    Returns (the stream function, its launches: eager, at capture)."""
    rs = make_stream_fn(*rates, target_in_frames=target, fixed_point=fixed)
    if rs.scheme != kind[1] or rs.device.type != "cuda":
        raise AssertionError(f"{name}: scheme {rs.scheme} on {rs.device}")
    frames = fn_quanta(rs, FN_QUANTA, seed=90 + fixed)
    cpu = make_stream_fn(*rates, target_in_frames=target, fixed_point=fixed,
                         device="cpu")
    reset_launches()
    hist, ys = rs.init(LANES), []
    for f in frames:
        hist, y = rs.step(hist, torch.from_numpy(lanes(f)).cuda())
        ys.append(y)
    torch.cuda.synchronize()
    eager = launch_counts()
    if eager != {kind[0]: {kind[1]: FN_QUANTA}}:
        raise AssertionError(f"{name}: eager launches {eager}")
    eng = BatchedResampler(STREAMS, CHANNELS, *rates,
                           target_chunk_frames=target, fixed_point=fixed)
    h_cpu = cpu.init(len(FN_LANES))
    for i, (f, y) in enumerate(zip(frames, ys)):
        got = y.cpu().numpy()
        want = lanes(eng.process(f))
        if got.shape != (rs.out_frames, LANES):
            raise AssertionError(f"{name}: step output {got.shape}")
        compare(got, want, rs.scheme, f"{name} step vs engine, quantum {i}")
        h_cpu, y_cpu = cpu.step(h_cpu,
                                torch.from_numpy(lanes(f)[:, FN_LANES]))
        compare(got[:, FN_LANES], y_cpu.numpy(), rs.scheme,
                f"{name} step vs cpu step, quantum {i}")
    del eng, ys
    # the stage in one CUDA graph, replayed over FN_REPLAYS quanta, each
    # with the history the eager stage carried to it
    inputs, h = [], rs.init(LANES)
    for f in fn_quanta(rs, FN_REPLAYS, seed=95 + fixed):
        x = torch.from_numpy(lanes(f)).cuda()
        inputs.append((h, x))
        h = rs.step(h, x)[0]

    def stage(h, x):
        h2, y = rs.step(h, x)
        return h2, y, window_energies(y)

    captured = graph_equals_eager(f"functional {name} step + window "
                                  f"energies", stage, inputs)
    if captured != {kind[0]: {kind[1]: 1}}:
        raise AssertionError(f"{name}: launches at capture {captured}")
    print(f"functional {name}: {rs.in_frames} -> {rs.out_frames} frames a "
          f"quantum, {kernel_name(kind[0], kind[1], 4 if fixed else 1)}; "
          f"eager step bit-identical with the CUDA engine over "
          f"{FN_QUANTA} quanta (lanes {FN_LANES[:8]}..{FN_LANES[-1]} with "
          f"the cpu step), launches {eager}; in one CUDA graph: launches "
          f"{captured} at capture, none at replay")
    return rs, eager[kind[0]][kind[1]] + 1


def graph_equals_eager(name: str, run, inputs: list) -> dict:
    """``run(hist, x)`` (a tuple of tensors) captured in one CUDA graph on
    static copies of ``inputs[0]`` after a warm-up on a side stream, then
    replayed on each (hist, x) of ``inputs`` copied into them: every
    output bit for bit against the eager call on the same tensors, and
    the replays launching no kernel the wrapper counts.  Returns the
    launch counts of the capture; a capture that fails raises."""
    eager = [run(h, x) for h, x in inputs]
    hist, x = (t.clone() for t in inputs[0])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run(hist, x)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    reset_launches()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = run(hist, x)
    captured = launch_counts()
    for i, ((h, xx), want) in enumerate(zip(inputs, eager)):
        hist.copy_(h)
        x.copy_(xx)
        graph.replay()
        torch.cuda.synchronize()
        if not all(torch.equal(o, w) for o, w in zip(out, want)):
            raise AssertionError(f"{name}: graph replay {i} differs")
    if launch_counts() != captured:
        raise AssertionError(f"{name}: replays moved the kernel counts "
                             f"{captured} -> {launch_counts()}")
    print(f"graph capture {name}: {len(inputs)} replays bit-identical with "
          f"the eager call, y {tuple(out[1].shape)}")
    del graph
    return captured


def capture_geometries() -> dict:
    """The steps make_stream_fn does not reach through the kernels of
    FN_CASES, each captured in a CUDA graph at full width: the voip dense
    steps (float and fixed) and the drift gather steps through
    make_stream_fn (float and fixed).  Each capture launches its kernel
    once; the replays equal the eager step bit for bit, and the eager step
    at lanes FN_LANES equals the same step on the CPU (fixed: bit for bit;
    float: within the tie bound).  Returns {kernel: launches at capture}."""
    captured = {}

    def check(name, run, cpu_run, inputs, scheme, kind):
        counts = graph_equals_eager(name, run, inputs)
        want = {kind[0]: {fm.launch_key(scheme, kind[2]) if kind[0] ==
                          "gather" else scheme: 1}}
        if counts != want:
            raise AssertionError(f"{name}: capture launched {counts}, "
                                 f"expected {want}")
        for i, (h, x) in enumerate(inputs):
            got = [t.cpu().numpy()[:, FN_LANES] for t in run(h, x)]
            ref = [t.numpy() for t in cpu_run(h[:, FN_LANES].cpu(),
                                              x[:, FN_LANES].cpu())]
            if not np.array_equal(got[0], ref[0]):
                raise AssertionError(f"{name}: history differs from cpu")
            err, mism = compare(got[1], ref[1], scheme,
                                f"{name} vs cpu, input {i}")
            print(f"graph capture {name} input {i}: lanes {FN_LANES[:8]}.."
                  f"{FN_LANES[-1]} vs device='cpu' max|err|={err} "
                  f"mismatches={mism}")
        key = kernel_name(kind[0], scheme, *kind[1:])
        captured[key] = captured.get(key, 0) + 1

    for path in (VOIP, VOIP_FIXED):
        step = tb.make_batched_step(path.spec, path.geometry(),
                                    device="cuda")
        cpu = tb.make_batched_step(path.spec, path.geometry(), device="cpu")
        inputs = [card_inputs(step, path.quantum(), LANES, seed=s,
                              wrap=path.fixed) for s in (1, 2)]
        check(f"{path.name} step", lambda h, x: step.fn(h, x, step.w),
              lambda h, x: cpu.fn(h, x, cpu.w), inputs, step.scheme,
              ("dense", n_accum_of(step)))
    for fixed in (False, True):
        rs, cpu = (make_stream_fn(44100, 44101, 7, target_in_frames=44100,
                                  fixed_point=fixed, device=d)
                   for d in ("cuda", "cpu"))
        rng = np.random.default_rng(50 + fixed)
        inputs = [tuple(torch.from_numpy(rng.integers(
            -32768, 32768, (rows, LANES), dtype=np.int16)).cuda()
            for rows in (rs.hist_rows, rs.in_frames)) for _ in range(2)]
        check(f"gather{' fixed' if fixed else ''} 44.1k->44.101k q7 "
              f"make_stream_fn step", rs.step, cpu.step, inputs, rs.scheme,
              ("gather", 4 if fixed else 1, "band"))
    return captured


def functional_time(name: str, rs, smi: str) -> None:
    """ms a quantum of the stage (step + window energies): eager, each of
    10 calls between two events (its host part inside), and back to back;
    against 10 calls captured in one CUDA graph (:func:`cuda_ms`); the gap
    is the stage's host cost."""
    x = torch.from_numpy(lanes(fn_quanta(rs, 1, seed=99)[0])).cuda()
    hist = rs.init(LANES)

    def stage():
        return window_energies(rs.step(hist, x)[1])

    eager = cuda_ms(stage, 10, mode="host")
    queued = cuda_ms(stage, 10)
    graph = cuda_ms(stage, 10, mode="graph")
    out = rs.out_frames * LANES
    print(f"functional timing {name} on {smi}: eager {eager:.4f} ms a "
          f"quantum ({out / eager / 1e6:.2f} G out samples/s; back to back "
          f"{queued:.4f} ms), graph {graph:.4f} ms "
          f"({out / graph / 1e6:.2f} G out samples/s); eager - graph = "
          f"{eager - graph:.4f} ms of host cost a quantum")


def array_check() -> None:
    """resample_array on 10 s of seeded stereo PCM at the flagship, the
    card against device="cpu", float (auto: int8) and fixed, bit for
    bit."""
    rng = np.random.default_rng(41)
    pcm = rng.integers(-32768, 32768, (ARRAY_SECONDS * 44100, CHANNELS),
                       dtype=np.int16)
    for fixed in (False, True):
        t0 = time.perf_counter()
        got = resample_array(pcm, 44100, 48000, 7, fixed_point=fixed)
        wall = time.perf_counter() - t0
        want = resample_array(pcm, 44100, 48000, 7, fixed_point=fixed,
                              device="cpu")
        scheme = "fixed" if fixed else "int8"
        compare(got, want, scheme, f"resample_array {scheme}")
        if abs(got.shape[0] / 48000 - pcm.shape[0] / 44100) >= 0.01:
            raise AssertionError(f"resample_array: {got.shape[0]} frames")
        print(f"resample_array {scheme} {ARRAY_SECONDS} s stereo "
              f"44100->48000 q7: {got.shape} bit-identical with "
              f"device='cpu', {wall:.2f} s on the card (engine build "
              f"included)")


def mesh_serve(mesh, fixed: bool, frames: list):
    """FLAGSHIP's schedule through an engine (meshed when ``mesh``);
    returns (engine, outputs, kernel launch counts)."""
    kw = dict(target_chunk_frames=FLAGSHIP.target, fixed_point=fixed)
    eng = (BatchedResampler(STREAMS, CHANNELS, 44100, 48000, 7, mesh=mesh,
                            **kw) if mesh else
           BatchedResampler(STREAMS, CHANNELS, 44100, 48000, 7, **kw))
    n = len(FLAGSHIP.frames)
    reset_launches()
    outs = [eng.process(f) for f in frames[:n]]
    outs.append(eng.flush())
    outs += [eng.process(f) for f in frames[n:]]
    torch.cuda.synchronize()
    return eng, outs, launch_counts()


def mesh_check(smi: str) -> None:
    """Two shards on card 0, and one shard on every visible card, against
    the unmeshed engine, float and fixed, bit for bit; launches once a
    shard; the functional step on two shards against the unsharded step;
    then ms a process() call of one quantum, meshed and unmeshed."""
    rng = np.random.default_rng(61)
    frames = [rng.integers(-32768, 32768, (STREAMS, n, CHANNELS),
                           dtype=np.int16)
              for n in FLAGSHIP.frames + FLAGSHIP.after]
    cards = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    engines = {}
    for fixed in (False, True):
        scheme = "fixed" if fixed else "int8"
        base, want, counts = mesh_serve(None, fixed, frames)
        engines[f"{scheme} unmeshed"] = base
        for mesh in (["cuda:0"] * 2, cards):
            eng, got, mcounts = mesh_serve(mesh, fixed, frames)
            for i, (g, w) in enumerate(zip(got, want)):
                compare(g, w, scheme, f"mesh {mesh} {scheme} call {i}")
            if eng.launches != len(mesh) * base.launches or mcounts != {
                    "tiled": {scheme: eng.launches}} or eng.degraded:
                raise AssertionError(
                    f"mesh {mesh}: {eng.launches} launches (unmeshed "
                    f"{base.launches}), kernel counts {mcounts}, degraded "
                    f"{eng.degraded}")
            engines[f"{scheme} mesh {mesh}"] = eng
            print(f"mesh {mesh} {scheme}: {len(got)} calls bit-identical "
                  f"with the unmeshed engine; launches {eng.launches} = "
                  f"{len(mesh)} x {base.launches}, kernel counts {mcounts}")
    print(f"mesh: {torch.cuda.device_count()} visible card(s); the "
          f"two-shard mesh repeats cuda:0")
    # the functional step on two shards against the unsharded step
    for fixed in (False, True):
        one = make_stream_fn(44100, 48000, 7, target_in_frames=9408,
                             fixed_point=fixed)
        two = make_stream_fn(44100, 48000, 7, target_in_frames=9408,
                             fixed_point=fixed, mesh=["cuda:0"] * 2)
        h1, h2 = one.init(LANES), two.init(LANES)
        for f in fn_quanta(one, 2, seed=70 + fixed):
            x = torch.from_numpy(lanes(f)).cuda()
            h1, y1 = one.step(h1, x)
            h2, y2 = two.step(h2, split_lanes(x, two.mesh))
            if not (torch.equal(join_lanes(y2), y1)
                    and torch.equal(join_lanes(h2), h1)):
                raise AssertionError(f"meshed step {one.scheme} differs")
        print(f"mesh functional step {one.scheme}: two shards on cuda:0 "
              f"bit-identical with the unsharded step over 2 quanta")
    # one quantum a process() call, meshed and unmeshed in turn
    quantum = frames[0][:, :FLAGSHIP.quantum()]
    walls = {k: [] for k in engines}
    for eng in engines.values():
        eng.process(quantum)
    for _ in range(10):
        for k, eng in engines.items():
            t0 = time.perf_counter()
            eng.process(quantum)
            walls[k].append(time.perf_counter() - t0)
    row = ", ".join(f"{k} {np.median(w) * 1e3:.2f}"
                    for k, w in walls.items())
    print(f"mesh process() timing on {smi}: ms a call of one flagship "
          f"quantum (median of 10, engines in turn): {row}")


# -- phase 10: the tensor-core probes -------------------------------------

class ProbeBuild:
    """``_build.load_probes()`` in a thread, started beside phase 2's build
    so that the two libraries' nvcc runs overlap; :meth:`wait` returns its
    seconds or raises its error."""

    def __init__(self):
        self.seconds, self.error = 0.0, None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        t0 = time.time()
        try:
            _build.load_probes()
        except Exception as e:  # re-raised by wait()
            self.error = e
        self.seconds = time.time() - t0

    def wait(self) -> float:
        self._thread.join()
        if self.error is not None:
            raise self.error
        return self.seconds


PROBE_SOURCE = "speex_resampler_tpu_torch/csrc/probes/{}.cu"
PROBE_REPLACES = {"tc_rate": "experiments/mxu_peak.py:68",
                  "int8_anatomy": "experiments/v4_overhead_anatomy.py:53",
                  "fixed_anatomy": "experiments/fixed_interp_anatomy.py:68",
                  "v3_anatomy": "experiments/v3_overhead_anatomy.py:230",
                  "f32_anatomy": "experiments/kernel_anatomy.py:63",
                  "prec_fir": "experiments/prec_bench.py:55",
                  "v5_bench": "experiments/v5_int8_bench.py:77",
                  "batched_dot": "experiments/batched_dot.py:102"}
PROBE_MODULES = {"tc_rate": ptr, "int8_anatomy": pv4, "fixed_anatomy": pfa,
                 "v3_anatomy": pv3, "f32_anatomy": pka,
                 "prec_fir": ppb, "v5_bench": pv5, "batched_dot": pbd}
# the rate kernel's checked cases at the flagship block [128, 264] x 128
# lanes: (dtype, N-tile; None: the case's own, C = 128)
PROBE_RATE = [("int8", None), ("bf16", None), ("int8", 32), ("int8", 64),
              ("bf16", 32), ("bf16", 64)]
# iterations of a timed launch: 1-5 ms each on the H100
PROBE_ITERS = {"tc_rate": 512, "int8_anatomy": 512, "fixed_anatomy": 128,
               "int_dot": 256, "k_layout": 512}
# the probes' flagship launches (P5, P6, P9, P11, P12): 4 weight periods
N_PERIODS_FLAGSHIP = 4
# P7's integer forms (bf16 is the rate kernel's case at [512, 264]); P7
# runs on the rate kernel, so its entries name P7's TPU kernel
INT_FORMS = ("i8i8", "i16i16", "i16i8", "i32i32")
P7_REPLACES = "experiments/mosaic_int_dot_bench.py:44"
# P9's split5 kernel (P9's int8 is its family's), P10 on the rate kernel,
# P12 on P6's kernel: the TPU kernels their entries name
P9_SPLIT5_REPLACES = "experiments/v5_int8_bench.py:95"
P10_REPLACES = "experiments/v4_k_layout.py:51"
P12_REPLACES = "experiments/v3_bench.py:58"
# P11's cases (form, lane tile)
P11_CASES = (("m-loop", 128), ("m-loop", 64), ("batched", 128))


def probe_report() -> None:
    """The probe library's ptxas lines and its instruction counts; raises
    if a tensor-core probe kernel has no wgmma instruction (IGMMA for the
    int8 ones, HGMMA for bf16 and TF32), or a CUDA-core one (P6, P8's
    HIGHEST, P11) has a wgmma or lacks its f32 FMA (FADD for nodot)."""
    for log in sorted(_build.probe_log_dir().glob("*.log")):
        for name, lines in ptxas_props(log).items():
            print(f"  ptxas {log.stem} {name}: {'; '.join(lines)}")
    counts = gmma_counts(_build.probe_lib_path())
    cores = ([(f"f32_anatomy_kernel<{v}>", "FADD" if v == 1 else "FFMA")
              for v in range(len(pka.VARIANTS))]
             + [("prec_f32_kernel", "FFMA"), ("batched_product_kernel", "FFMA")]
             + [(f"batched_mloop_kernel<{n}>", "FFMA") for n in pbd.LANES])
    want = ([(f"tc_rate_kernel<{b}, {n}, 1, 1>", op)
             for b, op in (("false", "IGMMA"), ("true", "HGMMA"))
             for n in ptr.N_TILES]
            + [(f"tc_rate_kernel<false, {n}, {na}, {nb}>", "IGMMA")
               for na, nb, n in ptr.DIGIT_CASES]
            + [(f"int8_anatomy_kernel<{v}, {n}>", "IGMMA")
               for v in range(len(pv4.VARIANTS)) for n in pv4.N_TILES]
            + [(f"fixed_anatomy_kernel<{r}>", "IGMMA") for r in range(3)]
            + [(f"v3_anatomy_kernel<{v}>", "IGMMA")
               for v in range(len(pv3.VARIANTS))]
            + [(f"prec_tc_kernel<{m}>", "HGMMA") for m in (1, 2, 3)]
            + [("v5_int8_kernel", "IGMMA"), ("v5_split5_kernel", "HGMMA")]
            + cores)
    found = ", ".join(f"{n} {counts.get((n, op), 0)} {op}" for n, op in want)
    print(f"probe SASS check (cuobjdump -sass): {found}")
    if any(counts.get(key, 0) == 0 for key in want):
        raise AssertionError("a probe kernel lacks its instruction")
    gmma = [n for n, _ in cores
            if counts.get((n, "IGMMA"), 0) + counts.get((n, "HGMMA"), 0)]
    if gmma:
        raise AssertionError(f"CUDA-core probe kernels with wgmma: {gmma}")


def exact_check(got, want, what: str) -> int:
    """0 mismatches or raise; returns max |err| (0)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {tuple(got.shape)} {got.dtype} != "
                             f"{tuple(want.shape)} {want.dtype}")
    d = (got.to(torch.int64) - want.to(torch.int64)).abs()
    mism = int((d > 0).sum())
    print(f"probe check {what}: {mism} mismatches of {d.numel()}")
    if mism:
        raise AssertionError(f"{what}: {mism} mismatches")
    return int(d.max())


def probe_inputs_fixed():
    """The fixed ladder's operands on the card, x16 with the wrap input
    (tests/fixed_inputs.py) on every fifth lane, for the set-0 row of the
    largest sum |w|, and rows of -32768 and 32767 on every seventh."""
    planes, bias, coef, xh, x16 = pfa.inputs(seed=5)
    w = planes[0].to(torch.int64) * 256 + planes[1].to(torch.int64)
    c = int(w[:pfa.R].abs().sum(1).argmax())
    x = x16.numpy().copy()
    fixed_inputs.wrap_column(w[c].numpy(), x, np.arange(0, pfa.LB, 5))
    x[0, 1::7], x[1, 1::7] = -32768, 32767
    return tuple(t.cuda() for t in (planes, bias, coef, xh,
                                     torch.from_numpy(x)))


def probe_inputs_v3(g):
    """P5's launch on the card: x drawn as the experiment draws it, with
    a row of -32768 and one of 32767 in every block's window, and a
    nonzero history."""
    hist, x = pv3.inputs(g, seed=8, device="cuda")
    x[0:g.in_per_launch:97] = -32768
    x[1:g.in_per_launch:89] = 32767
    rng = np.random.default_rng(9)
    hist = torch.from_numpy(rng.integers(-32768, 32768, tuple(hist.shape))
                            .astype(np.int16)).cuda()
    return hist, x


def probe_inputs_int(form: str):
    """P7's operands: the probe's draw, with full-range int16 (i16.i16,
    and W of i16.i8) or int32 (i32.i32) operands for the wide forms, whose
    sums then wrap mod 2^32."""
    w, x = pid.inputs(seed=6)
    rng = np.random.default_rng(10)
    lo, hi, dt = ((-2 ** 31, 2 ** 31, np.int32) if form == "i32i32"
                  else (-32768, 32768, np.int16))
    if form != "i8i8":
        w = torch.from_numpy(rng.integers(lo, hi, tuple(w.shape)).astype(dt))
    if form in ("i16i16", "i32i32"):
        x = torch.from_numpy(rng.integers(lo, hi, tuple(x.shape)).astype(dt))
    return w.cuda(), x.cuda()


def probe_check() -> dict:
    """Every probe kernel against its plain version on the card at the TPU
    probe's full shape (one copy of each tile, 16 iterations): the rate
    kernel (PROBE_RATE), the int8 block's variants at N = 32 and 64, the
    fixed ladder's rungs; P5's five variants at the flagship (full and
    hoist also against the served K1b, bit for bit; hoist's pre-pass
    against its plain split), P7's integer forms at their N-tile and its
    bf16 case, P6's four variants and P8's four precisions (max |err|
    <= 1 within the tie bound; nodot exact), and P8's error table against
    the float64 gold.  Returns {(family, case): max |err|}."""
    errs = {}
    w, x = ptr.operands(128, 264, 128, seed=3, device="cuda")
    for dtype, n in PROBE_RATE:
        errs[("tc_rate", dtype, n)] = exact_check(
            ptr.tc_rate(w, x, dtype, n=n), ptr.rate_reference(w, x, dtype),
            f"tc_rate {dtype} [128, 264] x 128 N {n or 128}")
    w8, x16, x8 = pv4.inputs(seed=4, device="cuda")
    x16[0, ::7], x16[1, ::7] = -32768, 32767
    for n in pv4.N_TILES:
        for v in pv4.VARIANTS:
            xv = x8 if v == "mxu_only" else x16
            errs[("int8_anatomy", v, n)] = exact_check(
                pv4.anatomy(v, w8, xv, n=n),
                pv4.anatomy_reference(v, w8, xv),
                f"int8_anatomy {v} N {n} [128, 512] . [512, 1024]")
    planes, bias, coef, xh, x16 = probe_inputs_fixed()
    for rung in pfa.RUNGS:
        xr = pfa.rung_input(rung, xh, x16)
        errs[("fixed_anatomy", rung)] = exact_check(
            pfa.ladder(rung, planes, bias, coef, xr),
            pfa.ladder_reference(rung, planes, bias, coef, xr),
            f"fixed_anatomy {rung} [512, 264] . [264, 128]")
    g = pv3.geometry()
    w3, kw3 = pv3.weights(g, "cuda"), pv3.launch_kw(g, "cuda")
    hist, x = probe_inputs_v3(g)
    k1b = pv3.served(hist, x, w3, **kw3)
    for v in pv3.VARIANTS:
        got = pv3.anatomy(v, hist, x, w3, **kw3)
        errs[("v3_anatomy", v)] = exact_check(
            got, pv3.anatomy_reference(v, hist, x, w3, **kw3),
            f"v3_anatomy {v} flagship [10240, 2048]")
        if v in ("full", "hoist"):
            exact_check(got, k1b, f"v3_anatomy {v} against the served K1b")
    al = pv3.AnatomyLaunch("hoist", hist, x, w3, **kw3)
    print(f"probe check v3_split (hoist's pre-pass): "
          f"{pv3.split_check(al, hist, x)['split_mismatches']} mismatches")
    for form in INT_FORMS:
        w, x = probe_inputs_int(form)
        errs[("int_dot", form)] = exact_check(
            pid.int_dot(w, x, form), pid.int_dot_reference(w, x, form),
            f"int_dot {form} N {pid.N_TILE[form]} [512, 264] x 128")
    w, x = pid.inputs(seed=6, device="cuda")
    errs[("int_dot", "bf16bf16")] = exact_check(
        pid.int_dot(w, x, "bf16bf16"),
        pid.int_dot_reference(w, x, "bf16bf16"),
        "int_dot bf16bf16 (tc_rate) [512, 264] x 128")
    g6 = pka.geometry()
    w6, kw6 = pka.weights(g6, "cuda"), pka.launch_kw(g6, "cuda")
    x16 = pka.inputs(g6, seed=11, device="cuda")
    x16[0, ::7], x16[1, ::7] = -32768, 32767
    for v in pka.VARIANTS:
        xv = pka.variant_input(v, x16)
        got = pka.anatomy(v, xv, w6, **kw6)
        want = pka.anatomy_reference(v, xv, w6, **kw6)
        if v == "nodot":
            errs[("f32_anatomy", v)] = exact_check(
                got, want, f"f32_anatomy {v} [80 x 128, 2048]")
        else:
            err, mism = compare(got.cpu().numpy(), want.cpu().numpy(),
                                "highest", f"f32_anatomy {v}")
            print(f"probe check f32_anatomy {v} [80 x 128, 2048]: max "
                  f"|err| {err}, {mism} ties {ties(mism, got.numel())}")
            errs[("f32_anatomy", v)] = err
    g8 = ppb.geometry()
    w8 = torch.from_numpy(g8.w).cuda()
    x8 = ppb.inputs(g8, seed=12, device="cuda")
    gold = ppb.gold(w8, x8, g8.n_blocks)
    table = []
    for mode in ppb.PRECISIONS:
        got = ppb.prec(mode, w8, x8, g8.n_blocks)
        want = ppb.prec_reference(mode, w8, x8, g8.n_blocks)
        err, mism = compare(got.cpu().numpy(), want.cpu().numpy(),
                            "highest", f"prec_fir {mode}")
        print(f"probe check prec_fir {mode} [64 x 160, 2048]: max |err| "
              f"{err}, {mism} ties {ties(mism, got.numel())}")
        errs[("prec_fir", mode)] = err
        k, p = ppb.stats(got, gold), ppb.stats(want, gold)
        table.append(f"{mode} kernel max|d| {k['max_abs_d']} rate "
                     f"{k['rate']:.4e}, plain max|d| {p['max_abs_d']} rate "
                     f"{p['rate']:.4e}")
    print("probe P8 against the float64 gold (experiments/prec_bench.py "
          "gold): " + "; ".join(table))
    probe_check_p9_p12(errs)
    return errs


def probe_check_p9_p12(errs: dict) -> None:
    """Probes P9-P12 against their plain versions on the card, at the TPU
    probe's full shape and a ragged one (B = 200 or 136; P10 K = 100),
    rows of -32768 and 32767 in x and nonzero histories: P9's int8 and P10
    0 mismatches, P9's split5, P11 and P12 max |err| <= 1 within the tie
    bound; P9 also against the served tiled kernels at H = 0 and P11
    against the served f32 kernel (bit for bit: the same bodies), P11's
    pre-pass against its plain patches, P12's conv against P6's full and
    its step's next history exactly.  Fills ``errs`` with the full
    shape's max |err|; prints P9's and P12's error against the float64
    gold."""
    g9 = pv5.geometry()
    for B in (LANES, 200):
        x = pv5.inputs(g9, B=B, seed=19, device="cuda")
        x[0::97], x[1::89] = -32768, 32767
        for scheme in pv5.SCHEMES:
            w, kw = pv5.weights(g9, scheme, "cuda"), pv5.launch_kw(
                g9, scheme, "cuda")
            got = pv5.bench(scheme, x, w, **kw)
            want = pv5.bench_reference(scheme, x, w, **kw)
            err, mism = compare(got.cpu().numpy(), want.cpu().numpy(), scheme,
                                f"v5_bench {scheme} B {B}")
            print(f"probe check v5_bench {scheme} [80 x 128, {B}]: max |err| "
                  f"{err}, {mism} ties {ties(mism, got.numel())}")
            exact_check(got, tf.resample_tiled(x.new_zeros((0, B)), x, w,
                                               scheme=scheme, **kw),
                        f"v5_bench {scheme} B {B} against the served tiled "
                        "kernel at H = 0")
            if B == LANES:
                errs[("v5_bench", scheme)] = err
                gold = pv5.gold(x, kw["n_blocks"])
                k, p = pv5.stats(got, gold), pv5.stats(want, gold)
                print(f"probe P9 {scheme} against the float64 gold on lane 0 "
                      f"(experiments/v5_int8_bench.py): kernel max|d| "
                      f"{k['max_abs_d']} tie rate {k['rate']:.2e}, plain "
                      f"max|d| {p['max_abs_d']} tie rate {p['rate']:.2e}")
    for K in pkl.KS + (100,):
        for form in pkl.FORMS:
            w, x = pkl.operands(K, form, seed=20 + K, device="cuda")
            e = exact_check(pkl.k_layout(w, x, form),
                            pkl.k_layout_reference(w, x, form),
                            f"k_layout K {K} {form} [128, {K}] x 1024 x 16")
            if K in pkl.KS:
                errs[("k_layout", K, form)] = e
    g11 = pbd.geometry()
    for B in (LANES, 136):
        w, kw = pbd.weights(g11, "cuda"), pbd.launch_kw(g11, "cuda")
        hist, x = pbd.inputs(g11, B=B, seed=21, device="cuda")
        hist.random_(-32768, 32768)
        x[0:g11.n_in:97], x[1:g11.n_in:89] = -32768, 32767
        want = pbd.batched_dot_reference("m-loop", hist, x, w, **kw)
        k1a = tf.resample_tiled(hist, x, w, scheme="highest", **kw)
        for form, lanes in P11_CASES:
            bl = pbd.BatchedLaunch(form, hist, x, w, lanes=lanes, **kw)
            got = bl.run()
            err, mism = compare(got.cpu().numpy(), want.cpu().numpy(),
                                "highest", f"batched_dot {form} {lanes}")
            print(f"probe check batched_dot {form} lanes {lanes} [80 x 128, "
                  f"{B}]: max |err| {err}, {mism} ties "
                  f"{ties(mism, got.numel())}")
            exact_check(got, k1a, f"batched_dot {form} lanes {lanes} B {B} "
                        "against the served f32 kernel")
            if form == "batched":
                exact_check(bl.run_patches(),
                            pbd.patches_reference(hist, x, g11.K, **kw),
                            f"batched_dot pre-pass B {B}")
            if B == LANES:
                errs[("batched_dot", form, lanes)] = err
    g12 = pka.geometry()
    for B in (LANES, 136):
        w, kw = pka.weights(g12, "cuda"), pka.launch_kw(g12, "cuda")
        x, chunk, hist = pv3b.inputs(g12, B=B, seed=22, device="cuda")
        hist.random_(-32768, 32768)
        conv = pv3b.conv(x, w, **kw)
        err, mism = compare(conv.cpu().numpy(),
                            pv3b.conv_reference(x, w, **kw).cpu().numpy(),
                            "highest", "v3_bench conv")
        exact_check(conv, pka.anatomy("full", x, w, **kw),
                    f"v3_bench conv B {B} against P6's full")
        h, y = pv3b.step(hist, chunk, w, **kw)
        h2, y2 = pv3b.step_reference(hist, chunk, w, **kw)
        exact_check(h, h2, f"v3_bench step's next history B {B}")
        e2, m2 = compare(y.cpu().numpy(), y2.cpu().numpy(), "highest",
                         "v3_bench step")
        print(f"probe check v3_bench [80 x 128, {B}]: conv max |err| {err}, "
              f"{mism} ties {ties(mism, conv.numel())}; step max |err| {e2}, "
              f"{m2} ties")
        if B == LANES:
            errs[("v3_bench",)] = max(err, e2)
            gs = pv5.stats(conv, pv5.gold(x, kw["n_blocks"]))
            print(f"probe P12 conv_v3 against the float64 gold on lane 0 "
                  f"(experiments/v3_bench.py): max|d| {gs['max_abs_d']} "
                  f"rate {gs['rate']:.2e}")


def probe_entry(family, name, smi, ms, plain_ms, library_ms, ops, nbytes,
                err, extra, peak=None, replaces=None) -> dict:
    """One probe kernel's JSON entry and its printed line: the bound of the
    timed launch is the larger of its bytes (inputs once, the output
    once) over HBM and its operations over the peak of their type (int8
    or, for the rate kernel's bf16 case, bf16, unless ``peak`` says); the
    TPU kernel it replaces is its family's unless ``replaces`` says."""
    if peak is None:
        peak = BF16_FLOPS if "<true" in name else INT8_OPS
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    bound_ms = max(t_bytes, t_ops)
    by = "bytes" if t_bytes >= t_ops else "operations"
    lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
    print(f"timing probe {name} on {smi}: {ms:.4f} ms a launch "
          f"({', '.join(f'{k} {v:.4g}' if isinstance(v, float) else f'{k} {v}' for k, v in extra.items())}), "
          f"bound {bound_ms:.4f} ms by {by} -> {bound_ms / ms:.3f} of it; "
          f"plain {plain_ms:.4f} ms, library {lib}")
    return {"name": name, "family": family, "route": "cuda",
            "source": PROBE_SOURCE.format(family),
            "replaces": replaces or PROBE_REPLACES[family], "launches": 0,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by, "library_ms": library_ms,
            **extra}


def probe_time_p5_p8(smi: str, errs: dict) -> list:
    """Probes P5-P8 timed (counts already at 0), their JSON entries:

    - P5, one launch of each variant at the flagship (ms: 20 queued), the
      served K1b's beside; the bound is K1b's (its launch's bytes, each
      needed multiply-add 6 int8 products), the phase-0 variants reading
      only phase 0's K-row patch of each period; the ladder printed;
    - P7, each integer form and the rate kernel's bf16 case at [512, 264]
      x 128 lanes as the rate kernel is timed (one launch of
      PROBE_ITERS["int_dot"] iterations, every SM busy, and the slope),
      the forms' costs a body against i8.i8 printed;
    - P6 and P8, one launch of each variant or precision (20 queued), the
      bound counting the nonzero weights' multiply-adds at the peak of
      their type."""
    entries = []
    # P5
    g = pv3.geometry()
    w3, kw3 = pv3.weights(g, "cuda"), pv3.launch_kw(g, "cuda")
    hist, x = pv3.inputs(g, device="cuda")
    bspec = FLAGSHIP.geometry()
    step = tb.make_batched_step(FLAGSHIP.spec, bspec, device="cuda",
                                scheme="int8")
    _, _, nbytes, ops, _, _ = launch_bound(FLAGSHIP.spec, step, bspec, LANES)
    spec, n_out = FLAGSHIP.spec, bspec.out_per_launch
    x_rows = ((bspec.f0 + (n_out - 1) * spec.num) // spec.den
              + spec.filt_len - bspec.f0 // spec.den)   # launch_bound's
    phase0_bytes = nbytes - (x_rows - g.n_periods * g.K) * LANES * 2
    k1b_ms = cuda_ms(lambda: pv3.served(hist, x, w3, **kw3), 20)
    ladder = {}
    for v in pv3.VARIANTS:
        al = pv3.AnatomyLaunch(v, hist, x, w3, **kw3)
        ms = cuda_ms(al.run, 20)
        ladder[v] = ms
        split = {}
        if v == "hoist":   # the pre-pass alone, and the walk's share
            split = {"split_ms": cuda_ms(al.run_split, 20)}
            split["walk_ms"] = ms - split["split_ms"]
            ladder["hoist walk"] = split["walk_ms"]
        plain_ms = cuda_ms(
            lambda: pv3.anatomy_reference(v, hist, x, w3, **kw3), 3)
        library_ms = cuda_ms(int8_probe_library_call(
            "v3_anatomy", v, hist, x, w3, kw3), 20)
        entries.append(probe_entry(
            "v3_anatomy", f"v3_anatomy_kernel<{al.v}> {v}", smi, ms,
            plain_ms, library_ms, ops,
            phase0_bytes if v in ("no_assemble", "dots_only") else nbytes,
            errs[("v3_anatomy", v)],
            {"variant": v, "served_K1b_ms": k1b_ms, "smem": al.smem,
             "max_slices": al.slices, **split}))
    print(f"probe P5 ladder on {smi}, ms a flagship launch: served K1b "
          f"{k1b_ms:.4f}; full {ladder['full']:.4f} ("
          f"{ladder['full'] - k1b_ms:+.4f} against K1b); "
          + "; ".join(f"{v} {ladder[v] - ladder['full']:+.4f}"
                      for v in ("hoist", "hoist walk") + pv3.VARIANTS[2:])
          + f" against full (hoist's pre-pass alone "
          f"{ladder['hoist'] - ladder['hoist walk']:.4f})")
    # P7
    w, x = pid.inputs(device="cuda")
    macs = pid.N_REPS * pid.C * pid.K * pid.LB
    it = PROBE_ITERS["int_dot"]
    body_us = {}
    for form in INT_FORMS:
        il = pid.int_dot_launch(w, x, form)
        prod, p = pid.products(form), il.plan
        ms = cuda_ms(lambda: il.run(it), 3)
        s = ptr.slope_ms(il.run, il.bodies_per_iter * macs * prod,
                         ptr.DATASHEET_MACS["int8"], target_ms=5.0)
        body_us[form] = s["slope_ms"] * 1e3 / il.bodies_per_iter
        plain_ms = cuda_ms(lambda: pid.int_dot_reference(w, x, form), 3)
        lib = pid.library_call(w, x, form)
        if form in ("i16i16", "i16i8"):    # exact float64: the body, wrapped
            exact_check(tf.wrap_int32(lib()),
                        pid.int_dot_reference(w, x, form)[0],
                        f"library float64 mm of the {form} body")
        entries.append(probe_entry(
            "tc_rate", f"{p.kernel} {form}", smi,
            ms, plain_ms, None if lib is None else cuda_ms(lib, 3),
            2 * prod * macs * it * il.bodies_per_iter,
            (p.na * pid.C + pid.N_REPS * p.nb * pid.LB) * pid.K
            + 4 * pid.SLOTS * pid.C * pid.LB, errs[("int_dot", form)],
            {"form": form, "products": prod, "iters": it,
             "us_per_body": body_us[form],
             "tmacs": macs / (body_us[form] * 1e-6) / 1e12,
             "n_ctas": il.n_ctas, "rs": p.rs}, replaces=P7_REPLACES))
    rl = ptr.RateLaunch(w, x, "bf16")
    p, it_r = rl.plan, PROBE_ITERS["tc_rate"]
    ms = cuda_ms(lambda: rl.run(it_r), 3)
    s = ptr.slope_ms(rl.run, rl.walked_macs, ptr.DATASHEET_MACS["bf16"],
                     target_ms=5.0)
    evals = it_r * rl.bodies_per_iter
    body_us["bf16bf16"] = s["slope_ms"] * 1e3 / rl.bodies_per_iter
    entries.append(probe_entry(
        "tc_rate", f"{p.kernel} bf16bf16", smi, ms,
        cuda_ms(lambda: ptr.rate_reference(w, x, "bf16"), 3),
        cuda_ms(ptr.library_call(w, x, "bf16"), 3), 2 * p.needed_macs * evals,
        2 * (p.C * p.K + ptr.N_REPS * p.K * p.LB) + 4 * ptr.SLOTS * p.C * p.LB,
        errs[("int_dot", "bf16bf16")],
        {"form": "bf16bf16", "iters": it_r, "us_per_body": body_us["bf16bf16"],
         "tmacs": macs / (body_us["bf16bf16"] * 1e-6) / 1e12,
         "n_ctas": rl.n_ctas, "rs": p.rs}, replaces=P7_REPLACES))
    print(f"probe P7 on {smi}, us a body [512, 264] . [264, 128] x 8 "
          f"(against i8.i8): " + "; ".join(
              f"{f} {u:.4f} ({u / body_us['i8i8']:.2f}x)"
              for f, u in body_us.items()))
    # P6
    g6 = pka.geometry()
    w6, kw6 = pka.weights(g6, "cuda"), pka.launch_kw(g6, "cuda")
    x16 = pka.inputs(g6, device="cuda")
    nnz = int((w6[0] != 0).sum()) * pka.N_PERIODS * pka.B  # multiply-adds
    n_y = kw6["n_blocks"] * g6.R * pka.B * 2
    times6 = {}
    for v in pka.VARIANTS:
        xv = pka.variant_input(v, x16)
        al = pka.AnatomyLaunch(v, xv, w6, **kw6)
        ms = cuda_ms(al.run, 20)
        times6[v] = ms
        plain_ms = cuda_ms(lambda: pka.anatomy_reference(v, xv, w6, **kw6), 3)
        rows = g6.K if v == "noslice" else g6.T
        w_bytes = 0 if v == "nodot" else int((w6[0] != 0).sum()) * 4
        ops = (kw6["n_blocks"] * g6.K * pka.B if v == "nodot" else 2 * nnz)
        entries.append(probe_entry(
            "f32_anatomy", f"f32_anatomy_kernel<{al.v}> {v}", smi, ms,
            plain_ms, cuda_ms(pka.library_call(v, xv, w6, **kw6), 3), ops,
            rows * pka.B * xv.element_size() + w_bytes + n_y,
            errs[("f32_anatomy", v)], {"variant": v}, peak=FP32_FLOPS))
    print(f"probe P6 on {smi}, ms a launch: full {times6['full']:.4f}; "
          + "; ".join(f"{v} {times6[v] - times6['full']:+.4f}"
                      for v in pka.VARIANTS[1:]) + " against full")
    # P8
    g8 = ppb.geometry()
    w8 = torch.from_numpy(g8.w).cuda()
    x8 = ppb.inputs(g8, device="cuda")
    nnz8 = int((w8 != 0).sum()) * g8.n_blocks * ppb.B
    peaks = {"HIGHEST": FP32_FLOPS, "HIGH": BF16_FLOPS,
             "DEFAULT": BF16_FLOPS, "TF32": TF32_FLOPS}
    for mode in ppb.PRECISIONS:
        pl = ppb.PrecLaunch(mode, w8, x8, g8.n_blocks)
        ms = cuda_ms(pl.run, 20)
        plain_ms = cuda_ms(
            lambda: ppb.prec_reference(mode, w8, x8, g8.n_blocks), 3)
        lib = ppb.library_call(mode, w8, x8, g8.n_blocks)
        if mode == "HIGH":      # the three products, summed in f32 a call
            d = (word2int(lib()).reshape(-1, x8.shape[1]).int() - ppb.
                 prec_reference(mode, w8, x8, g8.n_blocks).int()).abs()
            print(f"library HIGH: bf16 bmm (f32 out) of the three products "
                  f"vs plain max|err|={int(d.max())} mismatches="
                  f"{int((d > 0).sum())} of {d.numel()}")
            if int(d.max()) > 1:
                raise AssertionError(f"HIGH library bmm: max|err| "
                                     f"{int(d.max())}")
        name = ("prec_f32_kernel" if mode == "HIGHEST"
                else f"prec_tc_kernel<{pl.m}>") + f" {mode}"
        entries.append(probe_entry(
            "prec_fir", name, smi, ms, plain_ms,
            None if lib is None else cuda_ms(lib, 3),
            2 * (3 if mode == "HIGH" else 1) * nnz8,
            g8.T * ppb.B * 2 + int((w8 != 0).sum()) * 4
            + g8.n_blocks * ppb.R * ppb.B * 2, errs[("prec_fir", mode)],
            {"precision": mode}, peak=peaks[mode]))
    return entries


def probe_time_p9_p12(smi: str, errs: dict) -> list:
    """Probes P9-P12 timed (counts already at 0), their JSON entries:

    - P9, one launch of each scheme at the flagship without the halo (ms:
      20 queued), the bound counting the x rows the windows span, the
      nonzero weights once (int8: 3 digit bytes each and the bias; split5:
      2 bytes a nonzero entry of each plane) and y, and each needed
      multiply-add's 6 int8 products or 10 bf16 FLOP;
    - P10, each (K, form) on the rate kernel with 16 x blocks, every SM
      busy: one launch of PROBE_ITERS["k_layout"] iterations, the slope
      against an eighth of them (µs a body) and the intercept (the launch's
      staging);
    - P11, one launch of each form (20 queued), the pre-pass of the
      batched form alone, the served f32 kernel (K1a) at the same launch;
    - P12, conv_v3 (P6's full, 20 queued) and the step around it, eager
      (20 queued) and from a CUDA graph, beside the served highest step
      both ways; the step less the conv is the concat's copy.
    P11 and P12 are bound by their f32 multiply-adds (the nonzero weights'
    per output) at the CUDA cores' peak."""
    entries = []
    # P9
    g9 = pv5.geometry()
    x = pv5.inputs(g9, device="cuda")
    n_out = N_PERIODS_FLAGSHIP * g9.P * g9.R
    macs = n_out * FLAGSHIP.spec.filt_len * LANES
    rows = (n_out - 1) * 147 // 160 + FLAGSHIP.spec.filt_len
    for scheme in pv5.SCHEMES:
        w, kw = pv5.weights(g9, scheme, "cuda"), pv5.launch_kw(g9, scheme,
                                                               "cuda")
        bl = pv5.BenchLaunch(scheme, x, w, **kw)
        ms = cuda_ms(bl.run, 20)
        plain_ms = cuda_ms(lambda: pv5.bench_reference(scheme, x, w, **kw), 3)
        lib = (int8_probe_library_call("v5_bench", scheme, None, x, w, kw)
               if scheme == "int8" else pv5.library_call(
                   scheme, x, w, **{k: kw[k] for k in
                                    ("offsets", "S", "n_blocks")}))
        if scheme == "int8":
            w_bytes = int((w[0] != 0).any(0).sum()) * 3 + w[1].numel() * 4
            ops, peak, kernel = 12 * macs, INT8_OPS, "v5_int8_kernel"
        else:
            w_bytes = int((w[0] != 0).sum()) * 2
            ops, peak, kernel = 10 * macs, BF16_FLOPS, "v5_split5_kernel"
        entries.append(probe_entry(
            "v5_bench", f"{kernel} {scheme}", smi, ms, plain_ms,
            None if lib is None else cuda_ms(lib, 3), ops,
            rows * LANES * 2 + w_bytes + n_out * LANES * 2,
            errs[("v5_bench", scheme)],
            {"scheme": scheme, "out_per_s": n_out * LANES / (ms * 1e-3)},
            peak=peak,
            replaces=None if scheme == "int8" else P9_SPLIT5_REPLACES))
    # P10
    it = PROBE_ITERS["k_layout"]
    for K in pkl.KS:
        for form in pkl.FORMS:
            w, x = pkl.operands(K, form, device="cuda")
            rl = pkl.k_layout_launch(w, x, form)
            p = rl.plan
            ms1 = cuda_ms(lambda: rl.run(it // 8), 3)
            ms = cuda_ms(lambda: rl.run(it), 3)
            slope = (ms - ms1) / (it - it // 8)
            body_us = slope * 1e3 / rl.bodies_per_iter
            body_macs = pkl.N_REPS * pkl.R * K * pkl.LB
            entries.append(probe_entry(
                "tc_rate", f"{p.kernel} K{K} {form}", smi, ms,
                cuda_ms(lambda: pkl.k_layout_reference(w, x, form), 3),
                cuda_ms(pkl.library_call(w, x, form), 3),
                2 * body_macs * it * rl.bodies_per_iter,
                K * pkl.R + pkl.N_REPS * K * pkl.LB
                + 4 * ptr.SLOTS * pkl.R * pkl.LB,
                errs[("k_layout", K, form)],
                {"K": K, "form": form, "K_pad": p.K_pad, "iters": it,
                 "us_per_body": body_us, "intercept_ms": ms - it * slope,
                 "body_bound_us": body_macs / ptr.DATASHEET_MACS["int8"]
                 * 1e6, "tmacs": body_macs / (body_us * 1e-6) / 1e12,
                 "n_ctas": rl.n_ctas, "rs": p.rs},
                replaces=P10_REPLACES))
    # P11
    g11 = pbd.geometry()
    w, kw = pbd.weights(g11, "cuda"), pbd.launch_kw(g11, "cuda")
    hist, x = pbd.inputs(g11, device="cuda")
    nnz = int((w[0] != 0).sum()) * pbd.N_PERIODS * LANES   # multiply-adds
    nbytes11 = ((hist.shape[0] + g11.n_in) * LANES * 2
                + int((w[0] != 0).sum()) * 4 + n_out * LANES * 2)
    k1a_ms = cuda_ms(lambda: tf.resample_tiled(hist, x, w, scheme="highest",
                                               **kw), 20)
    plain_ms = cuda_ms(lambda: pbd.batched_dot_reference(
        "batched", hist, x, w, **kw), 3)
    library_ms = cuda_ms(pbd.library_call(hist, x, w, **kw), 3)
    times11 = {}
    for form, lanes in P11_CASES:
        bl = pbd.BatchedLaunch(form, hist, x, w, lanes=lanes, **kw)
        ms = cuda_ms(bl.run, 20)
        times11[f"{form} {lanes}"] = ms
        extra = {"form": form, "lanes": lanes, "served_K1a_ms": k1a_ms}
        if form == "batched":
            extra["patches_ms"] = cuda_ms(bl.run_patches, 20)
            extra["product_ms"] = ms - extra["patches_ms"]
            times11["pre-pass"] = extra["patches_ms"]
        kernel = ("batched_product_kernel" if form == "batched"
                  else f"batched_mloop_kernel<{lanes}>")
        entries.append(probe_entry(
            "batched_dot", f"{kernel} {form} {lanes}", smi, ms, plain_ms,
            library_ms, 2 * nnz, nbytes11,
            errs[("batched_dot", form, lanes)], extra, peak=FP32_FLOPS))
    print(f"probe P11 on {smi}, ms a flagship launch: served K1a "
          f"{k1a_ms:.4f}; " + "; ".join(f"{k} {v:.4f}"
                                        for k, v in times11.items()))
    # P12
    g12 = pka.geometry()
    w, kw = pka.weights(g12, "cuda"), pka.launch_kw(g12, "cuda")
    x, chunk, hist = pv3b.inputs(g12, device="cuda")
    al = pka.AnatomyLaunch("full", x, w, **kw)
    conv_ms = cuda_ms(al.run, 20)
    state = [hist]

    def one():
        state[0] = pv3b.step(state[0], chunk, w, **kw)[0]
    step_ms = cuda_ms(one, 20)
    step_graph = cuda_ms(one, 20, mode="graph")
    st, sh, sx = pv3b.served_step()
    served_ms = cuda_ms(lambda: st.fn(sh, sx, st.w), 20)
    served_graph = cuda_ms(lambda: st.fn(sh, sx, st.w), 20, mode="graph")
    nnz12 = int((w[0] != 0).sum()) * pv3b.N_PERIODS * LANES
    entries.append(probe_entry(
        "f32_anatomy", "f32_anatomy_kernel<0> v3_bench conv", smi, conv_ms,
        cuda_ms(lambda: pv3b.conv_reference(x, w, **kw), 3),
        cuda_ms(pka.library_call("full", x, w, **kw), 3), 2 * nnz12,
        g12.T * LANES * 2 + int((w[0] != 0).sum()) * 4 + n_out * LANES * 2,
        errs[("v3_bench",)],
        {"variant": "v3_bench conv", "step_ms": step_ms,
         "step_graph_ms": step_graph, "concat_ms": step_graph - conv_ms,
         "served_step_ms": served_ms, "served_step_graph_ms": served_graph},
        peak=FP32_FLOPS, replaces=P12_REPLACES))
    print(f"probe P12 on {smi}, ms a flagship launch: conv_v3 {conv_ms:.4f}; "
          f"its step eager {step_ms:.4f}, graph {step_graph:.4f} (the concat "
          f"{step_graph - conv_ms:+.4f}); served highest step eager "
          f"{served_ms:.4f}, graph {served_graph:.4f}")
    return entries


def probe_time(smi: str, errs: dict) -> list:
    """The probe path: with the probe launch counts set to 0, one case of
    each probe timed, every SM busy (ms of one launch of PROBE_ITERS
    iterations, back to back, and the slope between two iteration counts);
    the counts read after, each probe kernel required to have launched.
    Returns the probe kernels' JSON entries."""
    for module in PROBE_MODULES.values():
        module.launches = 0
    entries = []
    for dtype in ptr.DTYPES:
        w, x = ptr.operands(128, 264, 128, device="cuda")
        rl = ptr.RateLaunch(w, x, dtype)
        p, it = rl.plan, PROBE_ITERS["tc_rate"]
        ms = cuda_ms(lambda: rl.run(it), 3)
        s = ptr.slope_ms(rl.run, rl.walked_macs, ptr.DATASHEET_MACS[dtype],
                         target_ms=5.0)
        rate = rl.needed_macs / (s["slope_ms"] * 1e-3)
        plain_ms = cuda_ms(lambda: ptr.rate_reference(w, x, dtype), 3)
        library_ms = cuda_ms(ptr.library_call(w, x, dtype), 3)
        es = 2 if dtype == "bf16" else 1
        evals = it * rl.n_ctas / p.units
        entries.append(probe_entry(
            "tc_rate", p.kernel, smi, ms, plain_ms, library_ms,
            2 * p.needed_macs * evals,
            es * (p.C * p.K + ptr.N_REPS * p.K * p.LB) + 4 * ptr.SLOTS * p.C
            * p.LB, errs[("tc_rate", dtype, None)],
            {"iters": it, "bodies": evals, "tmacs_needed": rate / 1e12,
             "share_of_datasheet": rate / ptr.DATASHEET_MACS[dtype],
             "n_ctas": rl.n_ctas, "rs": p.rs}))
    w8, x16, x8 = pv4.inputs(device="cuda")
    for v in pv4.VARIANTS:
        xv = x8 if v == "mxu_only" else x16
        al = pv4.AnatomyLaunch(v, w8, xv, 32)
        it = PROBE_ITERS["int8_anatomy"]
        ms = cuda_ms(lambda: al.run(it), 3)
        planes = 2 if v == "extract_i32+2" else 2 * pv4.D
        macs = planes * pv4.R * pv4.K * pv4.LB
        s = ptr.slope_ms(al.run, al.blocks_per_iter * macs,
                         ptr.DATASHEET_MACS["int8"], target_ms=5.0)
        us = s["slope_ms"] * 1e3 / al.blocks_per_iter
        plain_ms = cuda_ms(lambda: pv4.anatomy_reference(v, w8, xv), 3)
        library_ms = cuda_ms(pv4.library_call(v, w8, xv), 3)
        entries.append(probe_entry(
            "int8_anatomy", f"int8_anatomy_kernel<{pv4.VARIANTS.index(v)}, "
            f"32> {v}", smi, ms, plain_ms, library_ms,
            2 * macs * it * al.blocks_per_iter,
            planes * pv4.R * pv4.K + 2 * pv4.K * pv4.LB
            + 4 * pv4.SLOTS * pv4.R * pv4.LB,
            errs[("int8_anatomy", v, 32)],
            {"variant": v, "iters": it, "us_per_block": us,
             "tmacs": macs / (us * 1e-6) / 1e12, "n_ctas": al.n_ctas}))
    planes, bias, coef, xh, x16 = pfa.inputs(device="cuda")
    for rung in pfa.RUNGS:
        xr = pfa.rung_input(rung, xh, x16)
        ll = pfa.LadderLaunch(rung, planes, bias, coef, xr)
        it = PROBE_ITERS["fixed_anatomy"]
        ms = cuda_ms(lambda: ll.run(it), 3)
        macs = 4 * pfa.C * pfa.K * pfa.LB
        s = ptr.slope_ms(ll.run, ll.blocks_per_iter * macs,
                         ptr.DATASHEET_MACS["int8"], target_ms=5.0)
        us = s["slope_ms"] * 1e3 / ll.blocks_per_iter
        plain_ms = cuda_ms(
            lambda: pfa.ladder_reference(rung, planes, bias, coef, xr), 3)
        lib = pfa.library_call(rung, planes, bias, coef, xr)
        exact_check(pfa.library_epilogue(rung, lib(), bias, coef),
                    pfa.ladder_reference(rung, planes, bias, coef, xr),
                    f"library float64 mm of the {rung} bodies, epilogue")
        entries.append(probe_entry(
            "fixed_anatomy", f"fixed_anatomy_kernel<{ll.kr}> {rung}",
            smi, ms, plain_ms, cuda_ms(lib, 3),
            2 * macs * it * ll.blocks_per_iter,
            2 * pfa.C * pfa.K + 4 * pfa.C + 16 * pfa.R
            + xr.element_size() * pfa.K * pfa.LB
            + 2 * pfa.SLOTS * pfa.R * pfa.LB,
            errs[("fixed_anatomy", rung)],
            {"rung": rung, "iters": it, "us_per_block": us,
             "tmacs": macs / (us * 1e-6) / 1e12, "n_ctas": ll.n_ctas}))
    entries += probe_time_p5_p8(smi, errs)
    entries += probe_time_p9_p12(smi, errs)
    counts = {family: m.launches for family, m in PROBE_MODULES.items()}
    print(f"probe launches in phase 10's timed path: {json.dumps(counts)}")
    if not all(counts.values()):
        raise AssertionError(f"a probe kernel never launched: {counts}")
    for e in entries:
        e["phase10_launches"] = counts[e["family"]]
    t = {e["rung"]: e["us_per_block"] for e in entries
         if e["family"] == "fixed_anatomy"}
    u = {e["variant"]: e["us_per_block"] for e in entries
         if e["family"] == "int8_anatomy"}
    print(f"probe ladders on {smi}, us a block: int8 (N 32) mxu_only "
          f"{u['mxu_only']:.4f}, full - mxu_only "
          f"{u['full'] - u['mxu_only']:.4f}; fixed: dots "
          f"{t['mxu_only']:.4f}, combine+bias "
          f"{t['+combine'] - t['mxu_only']:+.4f}, extract "
          f"{t['+extract'] - t['+combine']:+.4f}, mix+sat "
          f"{t['full'] - t['+extract']:+.4f}")
    return entries


# phase 11: the fuzz campaign's seed and draw count (its stratified round
# and pinned draws first) and the soak's seconds
FUZZ_SEED = 11
FUZZ_DRAWS = 24
SOAK_SECONDS = 60


def fuzz_phase() -> dict:
    """``tools/fuzz_torch.py`` on the card at :data:`FUZZ_SEED`, its
    stratified round, pinned draws and free draws up to
    :data:`FUZZ_DRAWS`: every draw passes, the stratified round reaches
    every class, and every kernel of a class (the batched engine's served
    kernels and the single-stream route's rows gather) launches.  Returns
    the launches by kernel name."""
    from tools import fuzz_torch as fz
    out = fz.campaign(FUZZ_SEED, FUZZ_DRAWS, float("inf"), "cuda")
    print(f"phase 11 fuzz: {out['draws']} draws in {out['elapsed_s']} s; "
          f"by mode {json.dumps(out['by_mode'])}")
    print(f"phase 11 fuzz draws by class: {json.dumps(out['by_class'])}")
    print(f"phase 11 fuzz failures: {len(out['failures'])}; clean "
          f"refusals (the CPU engine refusing alike) {out['refused']}; "
          f"fixed draws with a wrap window past 2^31 "
          f"{out['fixed_wrap_draws']}; largest tie rate against the host "
          f"cores by scheme {json.dumps(out['max_tie_rate_vs_host'])}")
    print(f"phase 11 fuzz launches by kernel: {json.dumps(out['launches'])}")
    if out["failures"]:
        raise AssertionError(f"fuzz failures: {out['failures']}")
    missing = [c for c in fz.CLASSES if not any(
        k.startswith(c) for k in out["by_class"])]
    unlaunched = [k for k in fz.CLASSES if k != "core matmul" and
                  out["launches"].get(CORE_GATHER if k == "core gather"
                                      else k, 0) == 0]
    if missing or unlaunched:
        raise AssertionError(f"fuzz classes not reached {missing}, kernels "
                             f"not launched {unlaunched}")
    return out["launches"]


def soak_phase(smi: str) -> None:
    """``tools/soak_torch.py`` on the card for :data:`SOAK_SECONDS`: no
    bucket degraded, every bucket's kernel launched, and the peak and
    final growth of RSS, device-allocated and pinned bytes within the
    soak's limits (the slope, asserted only over minutes, by the
    standalone run)."""
    from tools import soak_torch as st
    gc.collect()          # the earlier phases' engines, not the soak's
    res = st.soak(SOAK_SECONDS, "cuda")
    print(f"phase 11 soak on {smi}: {res['seconds']} s, {res['rounds']} "
          f"rounds, {res['launches']} launches, {res['streams_created']} "
          f"streams created ({res['stream_records']} records held: "
          f"removed streams are kept until pulled), "
          f"{res['pushes_refused']} pushes refused, "
          f"baseline at {res['baseline_s']} s; launches by kernel "
          f"{json.dumps(res['launches_by_kernel'])}")
    for name, v in res["series"].items():
        print(f"phase 11 soak {name}: baseline {v['baseline_mb']} MB, "
              f"growth peak {v['growth_peak_mb']} MB / final "
              f"{v['growth_final_mb']} MB (limits "
              f"{st.GROWTH_PEAK_MB} / {st.GROWTH_FINAL_MB}), slope "
              f"{v['slope_mb_per_min']} MB/min (not asserted here)")
    print(f"phase 11 soak: device reserved at most "
          f"{res['device_reserved_max_mb']} MB; pinned bytes from "
          f"{res['pinned_source']}")
    if not res["pass"]:
        raise AssertionError(f"soak failed: {res['failed']}")


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
    # (the probes' library, for phase 10, builds beside them)
    t0 = time.time()
    probe_build = ProbeBuild()
    _build.load()
    print(f"build: {time.time() - t0:.1f} s ({_build.build_dir()})")
    ptxas_report()
    sass_check()
    marks = {"1-2 card, build": time.time() - t_start}

    # -- phase 3: every kernel against its plain version, on the card
    max_err: dict = {}
    check_kernels(FLAGSHIP, ("int8", "highest"), max_err)
    check_kernels(SLICE, ("auto", "int8", "highest", "split5"), max_err)
    check_kernels(VOIP, ("auto",), max_err)
    check_kernels(DECIMATE, ("auto", "highest"), max_err)
    for path in (FIXED_FLAGSHIP, FIXED_SLICE, FIXED_DIRECT):
        check_kernels(path, ("auto",), max_err)
    check_kernels(FIXED_DIRECT, ("auto",), max_err, kernel="streamed")
    for path in (VOIP_FIXED, VOIP_FIXED_DIRECT, DRIFT, DRIFT_FIXED, STEEP,
                 STEEP_FIXED):
        check_kernels(path, ("auto",), max_err)
    # the fixed stream kernel where its sums wrap (steep taps cannot)
    check_kernels(DRIFT_FIXED, ("auto",), {}, only=("stream",))
    print(f"kernels checked: {time.time() - t_start:.1f} s")
    marks["3 kernels checked"] = time.time() - t_start

    # -- phase 4: each path end to end, its launches counted from 0
    float_requests = {"auto": "int8", "highest": "highest"}
    served = {FLAGSHIP: serve(FLAGSHIP, float_requests, want_digits=3),
              SLICE: serve(SLICE, {**float_requests, "split5": "split5"},
                           want_digits=4)}
    for path in (FIXED_FLAGSHIP, FIXED_SLICE, FIXED_DIRECT, VOIP_FIXED,
                 VOIP_FIXED_DIRECT, DRIFT_FIXED, STEEP_FIXED):
        served[path] = serve(path, {"auto": "fixed"})
    for path in (VOIP, DRIFT, STEEP):
        served[path] = serve(path, {"auto": "highest"})
    served[DECIMATE] = serve(DECIMATE, {"auto": "split5"})
    print(f"served: {time.time() - t_start:.1f} s")
    marks["4 paths served"] = time.time() - t_start

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
            (VOIP_FIXED, ("auto",), ()), (VOIP_FIXED_DIRECT, ("auto",), ()),
            (DRIFT, ("auto",), ()),
            (DRIFT_FIXED, ("auto",), ()), (STEEP, ("auto",), ()),
            (STEEP_FIXED, ("auto",), ())):
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
    t_fleet = time.time() - t_start
    # -- phase 6: the serving runtime (FleetResampler) at the flagship
    for fixed in (False, True):
        fleet_check(fixed)
    for fixed, depth in ((False, 1), (False, 2), (True, 2)):
        fleet_time(fixed, depth, smi)
    _, engines, frames = served[FLAGSHIP]
    big = np.concatenate(frames[:3], axis=1)     # 41000 frames a stream
    process_time(engines["int8"], big, smi, quanta=4)
    marks["5 paths timed"] = t_fleet
    print(f"fleet and process timed: {time.time() - t_start:.1f} s")
    marks["6 fleet"] = time.time() - t_start
    # -- phase 7: the single-stream layer (SpeexResampler, ResamplerCore)
    phase7 = single_stream_check()
    for entry in kernels:    # the rows kernel's f32-sample instance
        if entry["name"] == kernel_name("gather", "highest", form="rows",
                                        kO=8):
            entry["phase7_launches"] = phase7
    single_stream_time(smi)
    print(f"single-stream layer: {time.time() - t_start:.1f} s")
    marks["7 single stream"] = time.time() - t_start
    # -- phase 8: MultiFleet, 1024 stereo streams over four buckets
    mf_launches = {}
    for fixed in (False, True):
        mf_launches.update(multifleet_check(fixed, smi))
    print(f"multifleet launches by kernel: {json.dumps(mf_launches)}")
    print(f"multifleet: {time.time() - t_start:.1f} s")
    marks["8 multifleet"] = time.time() - t_start
    # -- phase 9: the functional step and mesh=, 1024 stereo streams
    fn_launches = {}
    for name, rates, target, fixed, kind in FN_CASES:
        rs, n = functional_check(name, rates, target, fixed, kind)
        fn_launches[kernel_name(*kind, 4 if fixed else 1)] = n
        functional_time(name, rs, smi)
    fn_launches.update(capture_geometries())
    array_check()
    mesh_check(smi)
    for entry in kernels:
        entry["phase9_launches"] = fn_launches.get(entry["name"], 0)
    print(f"phase 9 launches by kernel: {json.dumps(fn_launches)}")
    print(f"phase 9: {time.time() - t_start:.1f} s")
    marks["9 functional, mesh"] = time.time() - t_start
    # -- phase 10: the tensor-core probes, checked, then timed
    print(f"probe build: {probe_build.wait():.1f} s "
          f"({_build.probe_lib_path().name})")
    probe_report()
    kernels += probe_time(smi, probe_check())
    marks["10 probes"] = time.time() - t_start
    # -- phase 11: the fuzz campaign and the MultiFleet soak on the card
    fuzz_launches = fuzz_phase()
    rows = kernel_name("gather", "highest", form="rows", kO=8)
    for entry in kernels:    # the core's rows gathers beside phase 7's
        entry["phase11_launches"] = fuzz_launches.get(entry["name"], 0) + (
            fuzz_launches.get(CORE_GATHER, 0) if entry["name"] == rows
            else 0)
    soak_phase(smi)
    print(f"phase 11: {time.time() - t_start:.1f} s")
    marks["11 fuzz, soak"] = time.time() - t_start
    print(f"total: {time.time() - t_start:.1f} s")
    ends = list(marks.values())
    print(f"phase seconds on {smi}: " + json.dumps(
        {k: round(v - (ends[i - 1] if i else 0.0), 1)
         for i, (k, v) in enumerate(marks.items())}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
