"""What the port's spans cost, and where a stream step's host time goes,
on one GPU machine.

    python3 tools/trace_spans.py [--cells stage.q7 stage.q10] [--seed 7]
        [--seconds 4] [--gc-off] [--out chiprun_out/trace_spans.json]

Prints, and writes as JSON to ``--out``:

- the host microseconds of one empty ``span`` with no profiler and with a
  ``torch.profiler`` recording the CPU and the card, and of one empty
  ``record_function`` under the profiler (the best of 5 loops of 20,000
  each, the empty loop's time taken off);
- for each cell's step at 64 lanes, where the host paces the card: the
  host microseconds a call with no profiler (wall over 3,000 calls) and
  each span's mean from ``span_totals``;
- for each benchmark cell (``perfbench``'s own set-up and window, with its
  0.5 s traced sub-window from the window's middle): the set-up's span
  totals beside its ``program_s``; the count of each ``speex.step*`` span
  over the window's calls (``speex.step.pad``: the quanta the step had to
  copy); the traced calls, the device ms a call
  (busy and sub-window); ``step.host_ms`` and its parts a call, each
  span's host time less the CUDA runtime calls inside it (pad, kernel
  wrapper, next history, and the rest of ``speex.step``: the pad only
  where a quantum was copied); the runtime
  calls inside the kernel wrapper by name; the device operations by name,
  with their seconds and their count beside the calls' (a count short of
  the calls' means the profiler lost records, and their time reads as
  idle); and the ten longest idle gaps of the device, each with the innermost
  host operation and the innermost ``speex.*`` span running at its middle.

``--gc-off`` runs each window with the interpreter's cyclic garbage
collector off, to tell its pauses from the rest of the host's stalls.
Needs a CUDA device; prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import collections
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from perfbench import check, manifest, tracing  # noqa: E402
from perfbench.roofline import peaks_of  # noqa: E402
from speex_resampler_tpu_torch.utils.profiling import (  # noqa: E402
    reset_spans, span, span_totals)

#: the spans inside ``speex.step``, in the order a call opens them
STEP_PARTS = ("speex.step.pad", "speex.kernel.streamed", "speex.step.hist")


def _loop_seconds(body, n: int) -> float:
    t = time.perf_counter()
    body(n)
    return time.perf_counter() - t


def _empty(n: int) -> None:
    for _ in range(n):
        pass


def _spans(n: int) -> None:
    for _ in range(n):
        with span("speex.cost"):
            pass


def _record_functions(n: int) -> None:
    for _ in range(n):
        with torch.profiler.record_function("speex.cost"):
            pass


def span_cost_us(n: int = 20000, reps: int = 5) -> dict:
    """Host us of one empty span, with no profiler and under one, and of
    one ``record_function`` under the profiler."""
    def best(body) -> float:
        return min(_loop_seconds(body, n) - _loop_seconds(_empty, n)
                   for _ in range(reps)) / n * 1e6
    off = best(_spans)
    with tracing.profiler(torch.device("cuda")):
        on = best(_spans)
        rf = best(_record_functions)
    return {"no_profiler": off, "profiler": on,
            "record_function_profiler": rf}


def host_a_call_us(name: str, lanes: int = 64, calls: int = 3000) -> dict:
    """The cell's step at ``lanes`` lanes, where the host paces the card:
    host us a call (wall over ``calls``, ended by a synchronize) and each
    span's mean us, with no profiler."""
    from perfbench.entries.stream_stage import port_program
    cfg = manifest.cell(name).config
    prog = port_program(cfg, torch.device("cuda"))
    x = torch.zeros((prog.in_frames, lanes), dtype=torch.int16,
                    device="cuda")
    hist = prog.init(lanes)
    for _ in range(50):
        hist, _ = prog.step(hist, x)
    torch.cuda.synchronize()
    reset_spans()
    t = time.perf_counter()
    for _ in range(calls):
        hist, _ = prog.step(hist, x)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    out = {"lanes": lanes, "wall_us_a_call": 1e6 * wall / calls}
    out.update({k: 1e6 * s / n for k, (n, s) in span_totals().items()})
    return out


def _innermost(host, t, prefix=""):
    inner = [h for h in host if h[1] <= t <= h[2] and h[0].startswith(prefix)]
    return max(inner, key=lambda h: h[1])[0] if inner else None


def cell_report(name: str, seed: int, seconds: float,
                gc_off: bool = False) -> dict:
    cell = manifest.cell(name)
    entry = manifest.entry(cell.traffic["entry"])
    reference = manifest.reference(cell.config)
    device = torch.device("cuda")
    reset_spans()
    parts: dict = {}
    stage = entry.setup(cell.config, cell.traffic, seed, device, None,
                        reference, parts)
    setup = {k: v for k, v in span_totals().items()
             if k.startswith("speex.setup.")}
    reset_spans()
    if gc_off:
        gc.disable()
    try:
        win = entry.window(stage, seconds, check.CallSample(seed, 0),
                           trace_seconds=float(cell.traffic["trace_seconds"]))
    finally:
        gc.enable()
    step_spans = {k: n for k, (n, _) in span_totals().items()
                  if k.startswith("speex.step")}
    entry.release(stage)
    view = tracing.view(win["prof"], win["traced_calls"], stage.work,
                        peaks_of(torch.cuda.get_device_name(device)))
    host_ms = manifest._module(manifest.reader_file("step.host_ms"),
                               "perfbench.layer_metrics.step.host_ms")
    calls = view.calls
    own = {}
    for part in ("speex.step", *STEP_PARTS):
        n, s = host_ms.own_seconds(view, part)
        if n:
            own[part] = 1e3 * s / calls
    own["rest"] = own["speex.step"] - sum(v for k, v in own.items()
                                          if k != "speex.step")
    kernels = [h for h in view.host if h[0].startswith("speex.kernel.")]
    in_kernel: dict = {}
    for n, s, e in view.host:
        if host_ms.is_runtime(n) and any(k[1] <= s and e <= k[2]
                                         for k in kernels):
            in_kernel[n] = in_kernel.get(n, 0) + 1
    spans_ = tracing._merged(view.device)
    gaps = sorted(((b[0] - a[1], a[1], b[0])
                   for a, b in zip(spans_, spans_[1:]) if b[0] > a[1]),
                  reverse=True)[:tracing.TOP]
    ends = {e: n for n, _, e in view.device}
    begins = {s: n for n, s, _ in view.device}
    return {
        "cell": name, "seed": seed, "gc_off": gc_off, "setup_parts": parts,
        "setup_spans": setup, "calls": calls,
        "window_step_span_counts": {"speex.step.pad": 0, **step_spans},
        "device_busy_ms_a_call": 1e3 * view.busy_s / calls,
        "window_ms_a_call": 1e3 * view.window_s / calls,
        "idle_share": 1 - view.busy_s / view.window_s,
        "step_host_ms": host_ms.read(view),
        "own_host_ms_a_call": own,
        "runtime_calls_in_kernel_spans": in_kernel,
        "device_ops": tracing.breakdown(view)["device_ops"],
        "device_op_counts": dict(collections.Counter(
            n for n, _, _ in view.device)),
        "idle_gaps": [{"ms": 1e3 * g,
                       "host": _innermost(view.host, (s + e) / 2),
                       "span": _innermost(view.host, (s + e) / 2, "speex."),
                       "after_op": tracing.kernel_function(ends[s]),
                       "before_op": tracing.kernel_function(begins[e])}
                      for g, s, e in gaps],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cells", nargs="+", default=["stage.q7", "stage.q10"])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--gc-off", action="store_true")
    ap.add_argument("--out", default="chiprun_out/trace_spans.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_spans: needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    out = {"card": card.strip(), "torch": torch.__version__,
           "cuda": torch.version.cuda}
    print(f"card {out['card']}; torch {out['torch']}, CUDA {out['cuda']}")
    out["cells"] = []
    for name in args.cells:
        r = cell_report(name, args.seed, args.seconds, args.gc_off)
        out["cells"].append(r)
        print(json.dumps(r, indent=1))
    out["host_a_call_us"] = [host_a_call_us(n) for n in args.cells]
    print(f"host us a call: {out['host_a_call_us']}")
    out["span_cost_us"] = span_cost_us()
    print(f"span cost us: {out['span_cost_us']}")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
