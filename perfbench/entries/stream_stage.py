"""The entry ``stream_stage``: the port's device-resident stream step,
called on quanta already on the card, one after another with the
history carried.

A program has the contract of ``speex_resampler_tpu_torch.functional.
StreamFn``: ``init(lanes)`` gives a fresh history, ``step(hist, x)``
consumes ``in_frames`` frames of every lane and returns the next history
and ``out_frames`` output frames.  The program under test is the port's
step for the configuration; :func:`control` puts the plain reference in
its place in a lower precision, and :data:`FAULTS` break the port's step
on purpose.  Both are for ``perfbench/calibrate.py`` and the tests; a
benchmark run never builds them.

The harness (``perfbench/cell.py``) calls, in this order:
``setup`` (set-up: the program, the input pool from the seed, warm-up),
``window`` (the measured window), ``release`` (the program freed) and
``compare`` (the kept calls against the reference, after the window).
"""

from __future__ import annotations

import dataclasses
import time
import types

import torch
from torch.profiler import record_function

from perfbench import check, signals
from perfbench.roofline import CallWork, stage_call_work
from perfbench.tracing import CALL_SPAN, profiler


def port_program(config: dict, device):
    """The port's ``make_stream_fn`` step for a configuration."""
    from speex_resampler_tpu_torch.functional import make_stream_fn
    return make_stream_fn(
        config["in_rate"], config["out_rate"], config["quality"],
        target_in_frames=config["target_in_frames"],
        fixed_point=config["numeric"] == "fixed", device=device,
        scheme=config["scheme"])


def _frames(config: dict) -> tuple[int, int]:
    """(input, output) frames of a call: the configuration's quantum,
    which returns every call to phase 0."""
    n_in = int(config["target_in_frames"])
    return n_in, n_in * config["out_rate"] // config["in_rate"]


class ReferenceStep:
    """The plain reference with the program's step contract: its history
    is the previous call's input (None for a fresh stream)."""

    def __init__(self, config: dict, reference, device, dtype):
        self.in_frames, self.out_frames = _frames(config)
        self.ref = reference.call_reference(config, self.in_frames,
                                            self.out_frames, device, dtype)

    def init(self, lanes: int):
        return None

    def step(self, hist, x):
        return x, self.ref(hist, x)


def control(config: dict, reference, device):
    """The reference in bfloat16 in the program's place (the
    configurations state float32)."""
    return ReferenceStep(config, reference, device, torch.bfloat16)


def _broken(fault):
    def program(config, device):
        rs = port_program(config, device)

        def step(hist, x):
            h2, y = rs.step(hist, x)
            return fault(hist, h2, y)
        return types.SimpleNamespace(step=step, init=rs.init,
                                     in_frames=rs.in_frames,
                                     out_frames=rs.out_frames)
    return program


def _state_unchanged(hist, h2, y):
    return hist, y


def _half_batch(hist, h2, y):
    y = y.clone()
    y[:, y.shape[1] // 2:] = 0
    return h2, y


def _answer_altered(hist, h2, y):
    y = y.clone()
    y[y.shape[0] // 3, 1] += 3
    return h2, y


#: faults of the port's step, applied where it returns: the history it
#: returns is the one it was given; the second half of the lanes' outputs
#: left out (zeros); one output sample of each call moved by 3.  A
#: one-chip cell has no exchange between chips to leave out.
FAULTS = {"state_unchanged": _broken(_state_unchanged),
          "half_batch": _broken(_half_batch),
          "answer_altered": _broken(_answer_altered)}


@dataclasses.dataclass
class Stage:
    """A stream stage set up for its window."""
    config: dict
    program: object
    pool: torch.Tensor      # int16 [P, in_frames, lanes]
    walk: list              # call k reads pool[walk[k % P]]
    xs: list
    lanes: int
    work: CallWork          # of one call
    device: torch.device


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def setup(config: dict, mix: dict, seed: int, device: torch.device,
          program, reference, parts: dict) -> Stage:
    """The program (``program(config, device)``, by default the port's
    step), the input pool made on ``device`` from the seed, and
    ``mix["warmup_calls"]`` calls of the step; the seconds of each go to
    ``parts``."""
    lanes = mix["streams"] * config["channels"]
    t = time.perf_counter()
    prog = (program or port_program)(config, device)
    if (prog.in_frames, prog.out_frames) != _frames(config):
        raise ValueError(f"the program's call is {prog.in_frames} -> "
                         f"{prog.out_frames} frames, the configuration's "
                         f"{_frames(config)}")
    parts["program_s"] = time.perf_counter() - t
    t = time.perf_counter()
    pool, walk = signals.make_pool(mix, prog.in_frames, lanes,
                                   config["in_rate"], seed, device)
    xs = [pool[w] for w in walk]
    sync(device)
    parts["inputs_s"] = time.perf_counter() - t
    t = time.perf_counter()
    hist = prog.init(lanes)
    for i in range(int(mix["warmup_calls"])):
        hist, _ = prog.step(hist, xs[i % len(xs)])
    del hist, _
    sync(device)
    parts["warmup_s"] = time.perf_counter() - t
    taps, table_bytes = reference.filter_size(config)
    work = stage_call_work(taps, table_bytes, prog.in_frames,
                           prog.out_frames, lanes)
    return Stage(config=config, program=prog, pool=pool, walk=walk, xs=xs,
                 lanes=lanes, work=work, device=device)


def window(stage: Stage, seconds: float, sample: check.CallSample,
           trace_seconds: float = 0.0) -> dict:
    """Calls the step on the quanta in turn, the history carried, for
    ``seconds`` of host time, with nothing waited for inside; then waits
    for the device.  Call i's output goes to ``sample.offer``.  With
    ``trace_seconds``, the calls of that much host time from the window's
    middle on run under the profiler, between two synchronizes.  Returns
    the calls made, the window's seconds, the end-to-end values
    (``out_rate``: every output sample of the window's calls over its
    whole time, in Msamples/s) and, traced, the profiler and the calls it
    saw."""
    step, xs, device = stage.program.step, stage.xs, stage.device
    P = len(xs)
    hist = stage.program.init(stage.lanes)
    prof, traced = None, 0
    sync(device)
    t0 = time.perf_counter()
    deadline = t0 + seconds
    trace_at = t0 + seconds / 2 if trace_seconds > 0 else float("inf")
    i = 0
    while True:
        hist, y = step(hist, xs[i % P])
        sample.offer(i, y)
        i += 1
        now = time.perf_counter()
        if now >= trace_at:
            trace_at = float("inf")
            first = i
            sync(device)
            with profiler(device) as prof:
                end = time.perf_counter() + trace_seconds
                while time.perf_counter() < end:
                    with record_function(CALL_SPAN):
                        hist, y = step(hist, xs[i % P])
                    sample.offer(i, y)
                    i += 1
                sync(device)
            traced = i - first
            now = time.perf_counter()
        if now >= deadline:
            break
    sync(device)
    window_s = time.perf_counter() - t0
    return {"calls": i, "window_s": window_s,
            "values": {"out_rate": i * stage.work.out_samples
                       / window_s / 1e6},
            "prof": prof, "traced_calls": traced}


def release(stage: Stage) -> None:
    """Frees the program and its quanta; the pool stays for the check."""
    stage.program = None
    stage.xs = None


def compare(stage: Stage, kept: list, reference, limits: dict
            ) -> tuple[dict, int]:
    """Each kept call (index, output) worked out again by the reference
    from the pool alone, on every lane.  Returns the readings over all of
    them (``max_err_lsb``: the largest |program - reference| in int16
    steps; ``off_share``: the share of outputs that differ at all; and the
    outputs and calls compared) and the number of kept calls whose own
    readings break a limit."""
    pool, walk = stage.pool, stage.walk
    n_in, n_out = _frames(stage.config)
    ref = reference.call_reference(stage.config, n_in, n_out, stage.device)
    P = len(walk)
    max_err, off, n, failed = 0, 0, 0, 0
    for i, y in kept:
        prev = pool[walk[(i - 1) % P]] if i else None
        want = ref(prev, pool[walk[i % P]])
        err = (y.to(want.device, torch.int32) - want.to(torch.int32)).abs()
        own = {"max_err_lsb": int(err.max()),
               "off_share": int((err != 0).sum()) / err.numel()}
        failed += not check.judge(own, limits)[0]
        max_err = max(max_err, own["max_err_lsb"])
        off += int((err != 0).sum())
        n += err.numel()
    return {"max_err_lsb": max_err, "off_share": off / max(n, 1),
            "outputs": n, "calls": len(kept)}, failed
