"""Differential fuzz campaign of the PyTorch port, on the card.

    python3 tools/fuzz_torch.py [--budget-s 900] [--seed 0] [--draws N]
        [--replay I] [--device cuda|cpu] [--max-lanes 2100]

The port of ``experiments/fuzz_campaign.py``.  Its independent reference is
the port's own host route: ``ResamplerCore(engine="host")``, the native
C++ loops of ``ops/fir_exact.py`` and ``ops/fir_fixed.py``, which share no
code with the kernels.  Draw modes:

- **batch**: ``BatchedResampler(streams, channels, ir, orr, q,
  device=...)`` at 1-2100 lanes (weighted toward 1-3, 63-65, 127-130 and
  2047-2049, odd counts included), over standard rate pairs, the ir ->
  ir +- 1 clock-drift family at q0-q2 (the gather's band form) and steep
  decimations to a few hundred Hz (its stream form), quality 0-10, every
  scheme the universe allows, a ``max_latency_ms`` cap on about one draw
  in five (the dense geometry), full-scale PCM (noise or square waves;
  fixed draws also windows that drive an int32 accumulator past 2^31).
  Ragged ``process`` calls (1-frame calls included), ``skip_zeros``
  before a random call, ``flush``, one more ``process``.  Up to 16
  streams (the first, the last, random ones) are held against host cores
  fed the same frames: float within 1 LSB under the tie bound (int8, and
  any float draw of square waves, whose ties repeat every period: within
  1 LSB, the tie rate reported), fixed with 0 mismatches.  On the card, an
  engine of at most 256 lanes is also held call by call against the same
  engine on ``device="cpu"`` (int8 and fixed bit for bit; "highest" and
  split5, f32 sums in another order, within the tie bound, or within 1
  LSB on square waves).
- **chunks**, **caps**, **setrate** (float cores): ``ResamplerCore(...,
  engine="device")`` with ragged chunk schedules and ``skip_zeros``,
  tight output capacities (per-call consumed and produced counts exact),
  and mid-stream ``set_rate`` + ``set_quality``, against the same calls on
  ``engine="host"``.  Fixed-point cores take the host route by design, so
  they have no device route to fuzz here (``tests/test_torch_fuzz.py``
  holds them against the JAX package).

Draw ``i`` is a pure function of ``(seed, i)`` (``np.random.default_rng``).
The first ``len(CLASSES)`` draws are the stratified round: draw ``i``
rejection-samples a config of class ``CLASSES[i]``, a kernel by name (or a
core route), predicted from the config through
``parallel/batch._launch_geometry`` and ``fm.gather_plan`` without building
weights.  :data:`PINNED` draws (configs of faults found, kept as
regressions) follow, then free draws.  No draw may hide a fault: an
exception fails the draw, an engine that ends it degraded fails it, and a
clean ``ResamplerError`` refusal passes only where the same config on
``device="cpu"`` refuses with the same code at the same call.  Every draw
counts kernel launches by kernel name.

Writes ``build/fuzz_torch.json`` (each failing draw's full config, so it
replays with ``--replay``), prints one summary line and exits 1 on any
failure.  ``--device cpu`` runs the plain versions (the CPU tests).
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
import traceback
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from speex_resampler_tpu_torch import BatchedResampler  # noqa: E402
from speex_resampler_tpu_torch.core import resampler as core_resampler  # noqa: E402
from speex_resampler_tpu_torch.core.resampler import ResamplerCore  # noqa: E402
from speex_resampler_tpu_torch.ops import filter_design as fd  # noqa: E402
from speex_resampler_tpu_torch.ops.convert import lsb_tie_limit  # noqa: E402
from speex_resampler_tpu_torch.parallel import batch as tb  # noqa: E402
from speex_resampler_tpu_torch.utils.errors import ResamplerError  # noqa: E402
from speex_resampler_tpu_torch.utils.launches import (  # noqa: E402
    CORE_GATHER, count_launches, kernel_name, reset_launches, step_kernel)

OUT = REPO / "build" / "fuzz_torch.json"

STD_RATES = (8000, 11025, 16000, 22050, 24000, 32000, 44100, 48000, 88200,
             96000, 176400, 192000)
DRIFT_RATES = (8000, 16000, 24000, 44100, 48000)
STEEP_IN = (48000, 88200, 96000, 176400, 192000)
FLOAT_SCHEMES = ("auto", "highest", "int8", "split5")
LANE_SPOTS = ((1, 3), (63, 65), (127, 130), (2047, 2049))
MAX_LANES = 2100
CHECKED_STREAMS = 16
CPU_TWIN_MAX_LANES = 256
# lanes x frames a batch draw feeds (the host stages and transposes them)
LANE_FRAMES = 4e7

# the stratified round: one draw of each kernel the batched engine serves
# (by name, as utils.launches.kernel_name gives it) and of each core route
CLASSES = (
    "tiled_fir_int8_kernel", "tiled_fir_f32_kernel",
    "tiled_fir_split5_kernel", "tiled_fir_fixed_kernel<4>",
    "tiled_fir_fixed_kernel<1>",
    "streamed_fir_int8_kernel", "streamed_fir_f32_kernel",
    "streamed_fir_split5_kernel", "streamed_fir_fixed_kernel<4>",
    "dense_fir_f32_kernel", "dense_fir_fixed_kernel<4>",
    "dense_fir_fixed_kernel<1>",
    "gather_fir_f64mma_kernel<short>", "gather_fir_fixed_band_kernel<4>",
    "gather_fir_f64mma_stream_kernel<short>",
    "gather_fir_fixed_stream_kernel<4>",
    "core matmul", "core gather")

# draws of faults the campaign found, kept as regressions (full configs,
# run after the stratified round)
PINNED: list = []


# -- draws --------------------------------------------------------------------

def _rate(rng) -> int:
    if rng.random() < 0.5:
        return int(rng.choice(STD_RATES))
    return int(rng.integers(4000, 192001))


def _lanes(rng, max_lanes: int) -> int:
    if rng.random() < 0.65:
        lo, hi = LANE_SPOTS[int(rng.integers(len(LANE_SPOTS)))]
        B = int(rng.integers(lo, hi + 1))
    else:
        B = int(rng.integers(1, MAX_LANES + 1))
    return 1 + (B - 1) % max_lanes


@lru_cache(maxsize=512)
def _spec(num: int, den: int, q: int, fixed: bool) -> fd.FilterSpec:
    return fd.design_filter(num, den, q, fixed_point=fixed)


def _reduced(ir: int, orr: int) -> tuple:
    g = math.gcd(ir, orr)
    return ir // g, orr // g


@lru_cache(maxsize=512)
def _geometry(ir, orr, q, fixed, target, max_in):
    """(BatchSpec, FilterSpec) of a batch config at f0 0, or (None, None)
    where the engine refuses it."""
    try:
        spec = _spec(*_reduced(ir, orr), q, fixed)
        bspec = tb._launch_geometry(spec, target, max_in_frames=max_in)
    except (ResamplerError, fd.OverflowArgError):
        return None, None
    return bspec, spec


def predict(cfg: dict) -> str:
    """The draw's class: the kernel its engine launches at f0 0 (a float
    tiled or streamed "auto" request resolves only when its weights are
    built: "<geometry> auto"), or the core route; "refused" where the
    engine refuses the config.  No weights are built."""
    if cfg["mode"] != "batch":
        ir, orr, q = cfg["rates"][0]
        spec = _spec(*_reduced(ir, orr), q, False)
        return ("core gather" if core_resampler._device_route_gathers(spec)
                else "core matmul")
    bspec, spec = _geometry(cfg["ir"], cfg["orr"], cfg["q"], cfg["fixed"],
                            cfg["target"], _max_in(cfg))
    if bspec is None:
        return "refused"
    n_accum = tb._n_cols(spec)
    if bspec.kernel == "gather":
        plan = tb._gather_plan(spec, tb._gather_starts(spec, bspec)[0])
        return kernel_name("gather", "fixed" if cfg["fixed"] else "highest",
                           n_accum, plan.form, plan.outputs // 8)
    if cfg["fixed"]:
        return kernel_name(bspec.kernel, "fixed", n_accum)
    if bspec.kernel == "dense":
        return kernel_name("dense", "highest")
    if cfg["scheme"] == "auto":
        return f"{bspec.kernel} auto"
    return kernel_name(bspec.kernel, cfg["scheme"])


def _max_in(cfg: dict):
    ms = cfg.get("max_latency_ms")
    return None if ms is None else int(ms * cfg["ir"] / 1000)


def _schedule(rng, quantum: int, lanes: int) -> tuple:
    """Ragged process() calls over 1.3-3.2 quanta (at least one launch;
    1-frame calls included), the call skip_zeros precedes, and the frames
    of the process() call after the flush."""
    total = int(quantum * rng.uniform(1.3, 3.2))
    total = max(quantum + 1, min(total, int(LANE_FRAMES / lanes)))
    n_calls = int(rng.integers(2, 6))
    cuts = np.sort(rng.choice(np.arange(1, total), n_calls - 1,
                              replace=False)) if total > n_calls else []
    calls = np.diff(np.concatenate([[0], cuts, [total]])).astype(int)
    calls = [int(c) for c in calls]
    if rng.random() < 0.4:                         # a 1- or 7-frame call
        calls.insert(int(rng.integers(0, len(calls) + 1)),
                     int(rng.choice([1, 7])))
    skip_at = int(rng.integers(0, len(calls) + 1))
    after = int(rng.integers(1, quantum + 1))
    return calls, skip_at, after


def draw_batch(rng, max_lanes: int, family: str | None = None,
               fixed: bool | None = None, scheme: str | None = None,
               capped: bool | None = None) -> dict:
    """One batch draw (the arguments pin a family, universe, scheme or
    latency cap; None draws it)."""
    if family is None:
        family = str(rng.choice(["std"] * 8 + ["drift", "steep"]))
    if fixed is None:
        fixed = bool(rng.random() < 0.5)
    if family == "std":
        ir = int(rng.choice(STD_RATES))
        orr = int(rng.choice([r for r in STD_RATES if r != ir]))
        q = int(rng.integers(0, 11))
    elif family == "drift":
        ir = int(rng.choice(DRIFT_RATES))
        orr = ir + int(rng.choice([-1, 1]))
        q = int(rng.integers(0, 3))
    else:
        ir = int(rng.choice(STEEP_IN))
        orr = int(rng.integers(200, 901))
        q = int(rng.integers(0, 4))
    if scheme is None:
        scheme = ("auto" if fixed or rng.random() < 0.5
                  else str(rng.choice(FLOAT_SCHEMES)))
    if capped is None:
        capped = bool(rng.random() < 0.2)
    B = _lanes(rng, max_lanes)
    ch = 2 if B % 2 == 0 and rng.random() < 0.6 else 1
    cfg = dict(mode="batch", family=family, fixed=fixed, ir=ir, orr=orr,
               q=q, scheme=scheme, streams=B // ch, channels=ch,
               target=int(rng.choice([1024, 2048, 4096, 9408, 20480])),
               max_latency_ms=(round(float(np.exp(rng.uniform(
                   np.log(1.0), np.log(80.0)))), 3) if capped else None),
               data_seed=int(rng.integers(2 ** 31)),
               pcm=str(rng.choice(["noise", "square"])))
    bspec, _ = _geometry(ir, orr, q, fixed, cfg["target"], _max_in(cfg))
    quantum = bspec.in_per_launch if bspec is not None else 4096
    cfg["calls"], cfg["skip_at"], cfg["after"] = _schedule(rng, quantum, B)
    return cfg


def _core_frames(n: int, rates) -> int:
    """Bound a core draw's input by its MAC cost, as the JAX campaign's
    ``_cap_frames`` does (huge reduced den: the gather route)."""
    for ir, orr, q in rates:
        num, den = _reduced(ir, orr)
        taps = fd.QUALITY_MAP[q].base_length * max(1.0, ir / orr)
        per_in = taps * orr / ir
        budget = 2e5 if den > 8000 else 3e7
        n = min(n, int(max(400, budget / max(per_in, 1e-9))))
    return n


def draw_core(rng, mode: str | None = None, fixed: bool = False,
              wild: bool | None = None) -> dict:
    """One chunks / caps / setrate draw (``wild`` forces a huge-den pair,
    the gather route)."""
    if mode is None:
        mode = str(rng.choice(["chunks", "chunks", "caps", "setrate",
                               "setrate"]))

    def rate_pair():
        if wild:
            ir = int(rng.integers(4000, 192001))
            orr = ir + int(rng.integers(1, 40))
            return ir, orr
        ir, orr = _rate(rng), _rate(rng)
        if ir == orr:
            orr = ir + 1 if rng.random() < 0.5 else _rate(rng)
        return ir, orr

    ch = int(rng.integers(1, 3))
    ir, orr = rate_pair()
    rates = [(ir, orr, int(rng.integers(0, 11)))]
    cfg = dict(mode=mode, fixed=fixed, channels=ch,
               data_seed=int(rng.integers(2 ** 31)))
    if mode == "chunks":
        cfg["sched"] = [int(rng.choice([1, 7, 160, 733, 1024, 4001,
                                        int(rng.integers(1, 3000))]))
                        for _ in range(int(rng.integers(1, 8)))]
        cfg["skip_at"] = (int(rng.integers(0, 12)) if rng.random() < 0.3
                          else -1)
        n = int(min(0.4 * ir, 22000, 60000 * ir // orr + 1000))
    elif mode == "caps":
        sched = []
        for _ in range(int(rng.integers(2, 7))):
            f = int(rng.choice([1, 37, 159, 160, 161, 320, 1023, 1024,
                                int(rng.integers(1, 2500))]))
            expect = f * orr // ir
            cap = int(rng.choice([0, 1, max(0, expect - 50), expect,
                                  expect + 7, 10 ** 6]))
            sched.append((max(f, 1), cap))
        cfg["sched"] = sched
        cfg["use_float"] = bool(rng.random() < 0.5)
        cfg["switch_at"] = (int(rng.integers(1, 8)) if rng.random() < 0.5
                            else -1)
        if cfg["switch_at"] >= 0:
            rates.append((*rate_pair(), int(rng.integers(0, 11))))
        n = int(min(0.4 * ir, 16000, 50000 * ir // orr + 800))
    else:
        rates.append((*rate_pair(), int(rng.integers(0, 11))))
        cfg["chunk_frames"] = int(rng.integers(100, 2000))
        max_up = max(o / i for i, o, _ in rates)
        n = int(min(0.4 * ir, 20000, 60000 / max_up + 1000))
        cfg["switch_at"] = int(rng.integers(1, 20))
    cfg["rates"] = rates
    cfg["n"] = n = _core_frames(n, rates)
    if mode == "setrate":   # the switch happens inside the stream
        cfg["switch_at"] = min(cfg["switch_at"],
                               max(1, n // cfg["chunk_frames"] - 1))
    return cfg


def _class_draw(rng, klass: str, max_lanes: int) -> dict:
    """A draw of one class, rejection-sampled."""
    if klass.startswith("core"):
        wild = klass == "core gather"
        for _ in range(400):
            cfg = draw_core(rng, wild=wild)
            if predict(cfg) == klass:
                return cfg
        raise RuntimeError(f"no draw of class {klass}")
    fixed = "fixed" in klass
    family = ("steep" if "stream_kernel" in klass else
              "drift" if klass.startswith("gather") else "std")
    scheme = None
    if not fixed and klass.split("_")[0] in ("tiled", "streamed"):
        scheme = {"int8": "int8", "f32": "highest",
                  "split5": "split5"}[klass.split("_")[2]]
    for _ in range(400):
        cfg = draw_batch(rng, max_lanes, family=family, fixed=fixed,
                         scheme=scheme, capped=klass.startswith("dense"))
        if predict(cfg) == klass and not (scheme == "int8"
                                          and _int8_refused(cfg)):
            return cfg
    raise RuntimeError(f"no draw of class {klass}")


def _int8_refused(cfg: dict) -> bool:
    """Whether the engine refuses an explicit "int8" request of this
    config at f0 0 (its certificate past the hard cap), computed on the
    host weights as ``parallel/batch._resolve_scheme`` does: the
    stratified round's int8 draws must launch their kernel."""
    bspec, spec = _geometry(cfg["ir"], cfg["orr"], cfg["q"], False,
                            cfg["target"], _max_in(cfg))
    w = tb._tiled_weights(spec, 0).w
    if bspec.kernel == "streamed":
        w = np.pad(w, ((0, 0), (0, -w.shape[1] % 128), (0, 0)))
    try:
        tb._resolve_scheme(w, "int8")
    except ResamplerError:
        return True
    return False


def make_draw(seed: int, index: int, max_lanes: int = MAX_LANES) -> dict:
    """Draw ``index`` of the campaign of ``seed``."""
    rng = np.random.default_rng([seed, index])
    if index < len(CLASSES):
        cfg = _class_draw(rng, CLASSES[index], max_lanes)
    elif rng.random() < 0.6:
        cfg = draw_batch(rng, max_lanes)
    else:
        cfg = draw_core(rng)
    cfg["seed"], cfg["index"] = seed, index
    return cfg


# -- inputs -------------------------------------------------------------------

def batch_frames(cfg: dict) -> np.ndarray:
    """int16 [streams, n, channels] full-scale PCM of a batch draw: noise,
    or a full-scale square wave of a random period a lane; fixed draws
    also write, on every third lane, 32767 * sign(taps) over the window of
    one output (the tap column with the largest sum |w|), whose int32
    accumulator then passes 2^31 where the filter allows."""
    S, C = cfg["streams"], cfg["channels"]
    n = sum(cfg["calls"]) + cfg["after"]
    rng = np.random.default_rng(cfg["data_seed"])
    if cfg["pcm"] == "noise":
        x = rng.integers(-32768, 32768, (S, n, C), dtype=np.int16)
    else:
        period = rng.integers(2, 65, (S, 1, C))
        phase = rng.integers(0, 64, (S, 1, C))
        x = np.where(((np.arange(n)[None, :, None] + phase) // period) % 2,
                     np.int16(32767), np.int16(-32768)).astype(np.int16)
    if cfg["fixed"]:
        row0, taps = wrap_window(cfg)
        if row0 is not None:
            lanes = x.reshape(S, n, C).transpose(1, 0, 2).reshape(n, -1)
            sign = (32767 * np.sign(taps)).astype(np.int16)
            lanes[row0:row0 + len(taps), ::3] = sign[:, None]
            x = lanes.reshape(n, S, C).transpose(1, 0, 2).copy()
    return x


def wrap_window(cfg: dict) -> tuple:
    """(first input frame, taps) of the window of a fixed draw's first
    output wholly inside the input and before its skip_zeros call (or
    after it, when that comes first), the tap column with the largest
    sum |w|; (None, None) where none fits."""
    spec = _spec(*_reduced(cfg["ir"], cfg["orr"]), cfg["q"], True)
    N, num, den = spec.filt_len, spec.num, spec.den
    skip = cfg["skip_at"]
    lead = N // 2 if skip == 0 else 0
    j = -(-(N - 1 - lead) * den // num) if N - 1 > lead else 0
    t = j * num
    first = t // den + lead - (N - 1)
    limit = (sum(cfg["calls"]) if skip == 0 else
             sum(cfg["calls"][:skip]))
    if first < 0 or first + N > limit:
        return None, None
    p = np.array([t % den])
    taps = (spec.interp_rows(p)[0][0] if tb._n_cols(spec) == 4
            else spec.phase_rows(p))                 # [c, N]
    taps = taps.reshape(-1, N).astype(np.int64)
    return int(first), taps[int(np.abs(taps).sum(axis=1).argmax())]


def wrap_sum(cfg: dict) -> int:
    """The wrap window's exact accumulator, sum |taps| * 32767 (0 where
    the draw has none)."""
    if not cfg["fixed"] or cfg["mode"] != "batch":
        return 0
    row0, taps = wrap_window(cfg)
    return 0 if row0 is None else int(np.abs(taps).sum()) * 32767


def core_frames(cfg: dict) -> np.ndarray:
    rng = np.random.default_rng(cfg["data_seed"])
    return rng.integers(-32768, 32768, (cfg["n"], cfg["channels"]),
                        dtype=np.int16)


# -- call sequences (on any engine or core, so the tests drive the JAX
# package's classes with them too) ---------------------------------------------

def drive_engine(eng, frames: np.ndarray, cfg: dict) -> list:
    """The batch draw's calls on an engine: process() calls with
    skip_zeros before call ``skip_at``, flush, one more process().
    Returns each call's output, int16 [streams, m, channels]."""
    outs, pos = [], 0
    for k, f in enumerate(cfg["calls"]):
        if k == cfg["skip_at"]:
            eng.skip_zeros()
        outs.append(eng.process(frames[:, pos:pos + f]))
        pos += f
    if cfg["skip_at"] == len(cfg["calls"]):
        eng.skip_zeros()
    outs.append(eng.flush())
    outs.append(eng.process(frames[:, pos:pos + cfg["after"]]))
    return outs


def drive_core_stream(core, frames: np.ndarray, cfg: dict) -> tuple:
    """The same calls on one stream's core (int16 [n, channels]; no
    flush: a core emits every producible output a call).  Returns (output
    [m, channels], outputs up to the flush)."""
    outs, pos = [], 0
    orr, ir = cfg["orr"], cfg["ir"]
    for k, f in enumerate(cfg["calls"] + [cfg["after"]]):
        if k == cfg["skip_at"]:
            core.skip_zeros()
        if k == len(cfg["calls"]):
            at_flush = sum(o.shape[0] for o in outs)
        outs.append(core.process_interleaved(frames[pos:pos + f],
                                             f * orr // ir + 1024))
        pos += f
    return np.concatenate(outs), at_flush


def drive_chunks(core, frames: np.ndarray, cfg: dict) -> list:
    """Ragged schedule cycling, monotone output capacity,
    skip_zeros before schedule slot ``skip_at`` (the JAX campaign's
    ``_ours_chunks``)."""
    ir, orr, _ = cfg["rates"][0]
    ch, sched = cfg["channels"], cfg["sched"]
    outs, cap_bytes, si, pos = [], 0, 0, 0
    while pos < frames.shape[0]:
        if si == cfg["skip_at"]:
            core.skip_zeros()
        f = min(sched[si % len(sched)], frames.shape[0] - pos)
        si += 1
        cap_bytes = max(cap_bytes, (f * ch * 2 * orr + ir - 1) // ir)
        outs.append(core.process_interleaved(frames[pos:pos + f],
                                             cap_bytes // ch // 2))
        pos += f
    return outs


def drive_caps(core, frames: np.ndarray, cfg: dict) -> list:
    """Per call (consumed, produced, samples) under tight capacities, a
    rate and quality switch before call ``switch_at`` (the JAX tests'
    ``_ours_caps``)."""
    recs, pos, si = [], 0, 0
    while pos < frames.shape[0]:
        if si == cfg["switch_at"]:
            ir, orr, q = cfg["rates"][1]
            core.set_rate(ir, orr)
            core.set_quality(q)
        f, cap = cfg["sched"][si % len(cfg["sched"])]
        si += 1
        chunk = frames[pos:pos + min(f, frames.shape[0] - pos)]
        y = (core.process_interleaved_float(chunk.astype(np.float32), cap)
             if cfg["use_float"] else core.process_interleaved(chunk, cap))
        recs.append((core.last_accounting.fresh_consumed, y.shape[0],
                     y.reshape(-1)))
        pos += chunk.shape[0]
    return recs


def drive_setrate(core, frames: np.ndarray, cfg: dict) -> list:
    """Fixed chunks, set_rate + set_quality before chunk ``switch_at``
    (the JAX campaign's ``_ours_setrate``)."""
    (ir, orr, _), (ir1, orr1, q1) = cfg["rates"]
    ch, cf = cfg["channels"], cfg["chunk_frames"]
    outs = []
    for ci, pos in enumerate(range(0, frames.shape[0], cf)):
        if ci == cfg["switch_at"]:
            core.set_rate(ir1, orr1)
            core.set_quality(q1)
            ir, orr = ir1, orr1
        fr = frames[pos:pos + cf]
        cap = ((fr.shape[0] * ch * 2 * orr + ir - 1) // ir) // ch // 2
        outs.append(core.process_interleaved(fr, cap + 64))
    return outs


CORE_CALLS = {"chunks": drive_chunks, "caps": drive_caps,
                "setrate": drive_setrate}


def port_core(cfg: dict, engine: str, device: str) -> ResamplerCore:
    """The port's core of a chunks / caps / setrate draw."""
    ir, orr, q = cfg["rates"][0]
    return ResamplerCore(cfg["channels"], ir, orr, ir, orr, q,
                         fixed_point=cfg["fixed"], engine=engine,
                         device=device)


def port_engine(cfg: dict, device: str, streams: int | None = None):
    return BatchedResampler(streams or cfg["streams"], cfg["channels"],
                            cfg["ir"], cfg["orr"], cfg["q"],
                            target_chunk_frames=cfg["target"], device=device,
                            scheme=cfg["scheme"], fixed_point=cfg["fixed"],
                            max_latency_ms=cfg["max_latency_ms"])


# -- checks -------------------------------------------------------------------

class Failed(Exception):
    """A draw's check failed (the message says which)."""


def check_samples(got: np.ndarray, want: np.ndarray, exact: bool,
                  what: str, max_ties: float | None = -1.0) -> int:
    """exact: 0 mismatches; else max |err| <= 1 LSB with at most
    ``max_ties`` outputs off (-1: the tie bound of their count; None: no
    bound).  Returns the mismatch count."""
    if got.shape != want.shape:
        raise Failed(f"{what}: shape {got.shape} != {want.shape}")
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    mism = int((d > 0).sum())
    if exact and mism:
        raise Failed(f"{what}: {mism} mismatches of {d.size}")
    if max_ties == -1.0:
        max_ties = lsb_tie_limit(d.size)
    if d.size and (int(d.max()) > 1 or (max_ties is not None
                                        and mism > max_ties)):
        raise Failed(f"{what}: max|err| {int(d.max())}, {mism} ties of "
                     f"{d.size} (tie limit {max_ties})")
    return mism


def _attempt(fn):
    """fn() -> ("ok", result), or ("refused", (call, code)) on a clean
    ResamplerError (the call that raised it, :class:`_Calls`)."""
    try:
        return "ok", fn()
    except ResamplerError as e:
        return "refused", (getattr(e, "call", None), int(e.code))


class _Calls:
    """An engine or core whose method calls are numbered, so that a
    ResamplerError carries the call that raised it (``call``)."""

    def __init__(self, obj):
        self._obj, self._n = obj, 0

    def __getattr__(self, name):
        attr = getattr(self._obj, name)
        if not callable(attr):
            return attr

        def call(*args, **kw):
            self._n += 1
            try:
                return attr(*args, **kw)
            except ResamplerError as e:
                e.call = self._n
                raise
        return call


# -- running a draw -----------------------------------------------------------

def _checked_streams(cfg: dict) -> list:
    """The first, the last and random streams, at most CHECKED_STREAMS."""
    S = cfg["streams"]
    rng = np.random.default_rng(cfg["data_seed"] + 1)
    rest = rng.permutation(np.arange(1, max(S - 1, 1)))
    return sorted({0, S - 1, *rest[:CHECKED_STREAMS - 2].tolist()})


def run_batch(cfg: dict, device: str) -> dict:
    """A batch draw on ``device``: its launches by kernel name; the
    engine against the same engine on ``device="cpu"`` (every stream up
    to CPU_TWIN_MAX_LANES lanes, else the checked ones); the checked
    streams against host cores."""
    frames = batch_frames(cfg)
    # the tie bound counts independent rounding events; a periodic input
    # repeats its ties every period, so a float draw of square waves is
    # held within 1 LSB and its ties are reported, not bounded
    periodic = cfg["pcm"] == "square"
    reset_launches()

    def serve(dev, rows=None):
        eng = port_engine(cfg, dev, None if rows is None else len(rows))
        x = frames if rows is None else frames[rows]
        return eng, drive_engine(_Calls(eng), x, cfg)

    status, res = _attempt(lambda: serve(device))
    if status == "refused":
        twin, twin_res = _attempt(lambda: serve("cpu", [0]))
        if twin != "refused" or twin_res != res:
            raise Failed(f"{device} refused {res} (call, code); cpu: {twin}"
                         f" {twin_res if twin == 'refused' else ''}")
        return dict(refused=res, launches={}, kernel="refused")
    eng, outs = res
    if eng.degraded:
        raise Failed(f"engine degraded: {eng.degraded_cause!r}")
    launches = count_launches(dict(
        step_kernel(step) for _, step, _ in eng._step_cache.values()))
    step = eng._step
    exact = step.scheme in ("int8", "fixed")
    picks = _checked_streams(cfg)
    if device != "cpu":
        rows = (list(range(cfg["streams"])) if eng.B <= CPU_TWIN_MAX_LANES
                else picks)
        _, twin = serve("cpu", rows)
        for i, (g, w) in enumerate(zip(outs, twin)):
            check_samples(g[rows], w, exact, f"call {i}, streams {rows[:4]}"
                          f".. vs device=cpu",
                          max_ties=None if periodic else -1.0)
    got_all = np.concatenate(outs, axis=1)
    flushed = sum(o.shape[1] for o in outs[:-1])
    gots, wants = [], []
    for s in picks:
        core = ResamplerCore(cfg["channels"], cfg["ir"], cfg["orr"],
                             cfg["ir"], cfg["orr"], cfg["q"],
                             fixed_point=cfg["fixed"], engine="host",
                             device="cpu")
        want, at_flush = drive_core_stream(core, frames[s], cfg)
        if at_flush != flushed:
            raise Failed(f"stream {s}: {flushed} outputs by the flush, the "
                         f"host core {at_flush}")
        m = min(got_all.shape[1], want.shape[0])
        gots.append(got_all[s, :m])
        wants.append(want[:m])
    got, want = np.concatenate(gots), np.concatenate(wants)
    ties = check_samples(got, want, cfg["fixed"],
                         f"streams {picks} vs host cores",
                         max_ties=None if step.scheme == "int8" or periodic
                         else lsb_tie_limit(got.size))
    return dict(kernel=step_kernel(step)[1], launches=launches,
                mismatches=ties, compared=int(got.size), lanes=eng.B,
                checked=len(picks), scheme=step.scheme, periodic=periodic)


def run_core(cfg: dict, device: str) -> dict:
    frames = core_frames(cfg)
    drive = CORE_CALLS[cfg["mode"]]
    reset_launches()

    def serve(engine, dev):
        core = port_core(cfg, engine, dev)
        return core, drive(_Calls(core), frames, cfg)

    status, res = _attempt(lambda: serve("device", device))
    launches = count_launches({("gather", "highest"): CORE_GATHER})
    host_status, host = _attempt(lambda: serve("host", "cpu"))
    if status == "refused":
        twin_status, twin = _attempt(lambda: serve("device", "cpu"))
        if twin_status != "refused" or twin != res or host != res:
            raise Failed(f"{device} refused {res} (call, code); cpu: "
                         f"{twin_status} {twin if twin_status == 'refused' else ''}"
                         f", host route: {host_status}")
        return dict(refused=res, launches=launches, kernel=predict(cfg))
    if host_status == "refused":
        raise Failed(f"the host route refused {host}, the device route not")
    (core, got), (_, want) = res, host
    if core.degraded:
        raise Failed(f"core degraded: {core.degraded_cause!r}")
    if cfg["mode"] == "caps":
        if [r[:2] for r in got] != [r[:2] for r in want]:
            raise Failed(f"(consumed, produced) a call "
                         f"{[r[:2] for r in got]} vs the host's "
                         f"{[r[:2] for r in want]}")
        g = np.concatenate([r[2] for r in got])
        w = np.concatenate([r[2] for r in want])
        if cfg["use_float"]:
            if g.size and np.abs(g - w).max() > 0.1:
                raise Failed(f"float samples off by {np.abs(g - w).max()}")
            return dict(kernel=predict(cfg), launches=launches, mismatches=0)
    else:
        if [o.shape for o in got] != [o.shape for o in want]:
            raise Failed("per-call output counts differ from the host's")
        g = np.concatenate([o.reshape(-1) for o in got])
        w = np.concatenate([o.reshape(-1) for o in want])
    mism = check_samples(g, w, cfg["fixed"], "device route vs host route")
    return dict(kernel=predict(cfg), launches=launches, mismatches=mism)


def run_draw(cfg: dict, device: str) -> dict:
    """One draw: {"ok", "detail", "kernel", "launches", ...}."""
    t0 = time.perf_counter()
    try:
        res = (run_batch if cfg["mode"] == "batch" else run_core)(cfg,
                                                                   device)
        res.update(ok=True, detail="")
    except Failed as e:
        res = dict(ok=False, detail=str(e), launches={})
    except Exception as e:  # noqa: BLE001 -- a draw's exception is its failure
        res = dict(ok=False, launches={}, detail=(
            f"EXCEPTION {type(e).__name__}: {e}\n"
            + "".join(traceback.format_exception(e)[-6:])))
    res["seconds"] = round(time.perf_counter() - t0, 3)
    res["wrap"] = wrap_sum(cfg) > 2 ** 31
    return res


def campaign(seed: int, draws: int, budget_s: float, device: str,
             max_lanes: int = MAX_LANES, log=print) -> dict:
    """The stratified round, the pinned draws, then free draws while
    ``draws`` and ``budget_s`` allow (the stratified round and the pinned
    draws run whole)."""
    t0 = time.perf_counter()
    todo = [(i, None) for i in range(min(draws, len(CLASSES)))]
    todo += [("pinned", c) for c in PINNED]
    i = len(CLASSES)
    by_mode, by_class, launches, failures, tie_rates = {}, {}, {}, [], {}
    done = refused = wraps = 0
    while todo or (i < draws and time.perf_counter() - t0 < budget_s):
        if todo:
            index, cfg = todo.pop(0)
        else:
            index, cfg, i = i, None, i + 1
        if cfg is None:
            cfg = make_draw(seed, index, max_lanes)
        res = run_draw(cfg, device)
        done += 1
        klass = res.get("kernel") or predict(cfg)
        by_mode[cfg["mode"]] = by_mode.get(cfg["mode"], 0) + 1
        universe = "fixed" if cfg["fixed"] else "float"
        key = f"{klass} ({universe})" if klass.startswith("core") else klass
        by_class[key] = by_class.get(key, 0) + 1
        for name, n in res["launches"].items():
            launches[name] = launches.get(name, 0) + n
        refused += "refused" in res
        if res.get("compared"):      # batch draws: ties against the host
            rate = res["mismatches"] / res["compared"]
            scheme = res["scheme"] + (" square" if res["periodic"] else "")
            tie_rates[scheme] = max(tie_rates.get(scheme, 0.0), rate)
        wraps += bool(res.get("wrap")) and res["ok"]
        tag = "ok" if res["ok"] else "FAIL"
        log(f"fuzz draw {index}: {tag} {key} {cfg['mode']} "
            f"{_summary(cfg)} {res['seconds']:.2f} s"
            + (f" refused {res['refused']}" if "refused" in res else "")
            + ("" if res["ok"] else f" -> {res['detail']}"))
        if not res["ok"]:
            failures.append({"index": index, "cfg": cfg,
                             "detail": res["detail"]})
    return {"seed": seed, "device": device, "draws": done,
            "elapsed_s": round(time.perf_counter() - t0, 1),
            "by_mode": by_mode, "by_class": by_class, "launches": launches,
            "refused": refused, "fixed_wrap_draws": wraps,
            "max_tie_rate_vs_host": tie_rates,
            "failures": failures}


def _summary(cfg: dict) -> str:
    if cfg["mode"] == "batch":
        return (f"{cfg['ir']}->{cfg['orr']} q{cfg['q']} "
                f"{'fixed' if cfg['fixed'] else cfg['scheme']} "
                f"B={cfg['streams'] * cfg['channels']} "
                f"cap={cfg['max_latency_ms']} frames={sum(cfg['calls'])}")
    return " ".join(f"{i}->{o} q{q}" for i, o, q in cfg["rates"]) + \
        f" ch={cfg['channels']} n={cfg['n']}"


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--budget-s", type=float, default=900.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--draws", type=int, default=10 ** 9,
                    help="stop after this many draws (stratified included)")
    ap.add_argument("--replay", type=int, default=None,
                    help="run draw I of the seed alone")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--max-lanes", type=int, default=MAX_LANES)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("fuzz_torch: no CUDA device")
    smi = card() if args.device == "cuda" else "cpu"
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.replay is not None:
        cfg = make_draw(args.seed, args.replay, args.max_lanes)
        res = run_draw(cfg, args.device)
        print(json.dumps({"cfg": cfg, **res}, default=str))
        return 0 if res["ok"] else 1
    out = campaign(args.seed, args.draws, args.budget_s, args.device,
                   args.max_lanes)
    out.update(card=smi, budget_s=args.budget_s)
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text(json.dumps(out, indent=1, default=str))
    print(json.dumps({k: v for k, v in out.items() if k != "failures"}
                     | {"n_failures": len(out["failures"])}))
    return 1 if out["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
