"""One run of one cell: set-up, the measured window, the check of its
outputs, and the numbers the result line carries.

What the run drives is the entry that the cell's traffic mix names
(``entries/<entry>.py``), held against the plain reference that its
configuration names; both are found by name (``manifest.py``)."""

from __future__ import annotations

import time

import torch

from . import check, manifest, tracing
from .roofline import peaks_of


def run_cell(cell: manifest.Cell, seed: int, seconds: float, trace: bool,
             *, device="cuda", program=None, setup_clock=None) -> dict:
    """Runs ``cell`` once and returns its result (``run.py`` prints it).

    ``program(config, device)`` builds the program in place of the
    port's (a fault, or the control, in the tests and the calibration);
    ``setup_clock()`` gives the seconds since set-up began (by default,
    since this call)."""
    t_start = time.perf_counter()
    setup_clock = setup_clock or (lambda: time.perf_counter() - t_start)
    device = torch.device(device)
    cfg, mix = cell.config, cell.traffic
    parts = {"before_cell_s": setup_clock()}
    entry = manifest.entry(mix["entry"], cell.root)
    reference = manifest.reference(cfg, cell.root)
    stage = entry.setup(cfg, mix, seed, device, program, reference, parts)
    setup_s = setup_clock()

    sample = check.CallSample(seed, int(mix["sample_calls"]))
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    win = entry.window(stage, seconds, sample,
                       trace_seconds=float(mix["trace_seconds"]) if trace
                       else 0.0)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    kept = sample.kept()
    del sample
    entry.release(stage)
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    readings, failed = entry.compare(stage, kept, reference, cfg["limits"])
    del kept
    correct, checks = check.judge(readings, cfg["limits"])
    parts["check_s"] = time.perf_counter() - t

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": win["calls"],
              "failed": failed}
    if trace:
        view = tracing.view(win["prof"], win["traced_calls"], stage.work,
                            peaks_of(dev["kind"]))
        metrics = {}
        for m in cell.per_layer:
            value = manifest.reader(m["name"], cell.root)(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev.update(busy_s=view.busy_s, window_s=view.window_s)
        result.update(metrics=metrics, device=dev,
                      breakdown=tracing.breakdown(view))
    else:
        values = {**win["values"], "setup_s": setup_s}
        result.update(metrics={m["name"]: {"value": values[m["name"]],
                                           "unit": m["unit"]}
                               for m in cell.end_to_end},
                      device=dev)
    result.update(window={"seconds": win["window_s"], "calls": win["calls"],
                          "setup_parts": parts,
                          "compared": {k: readings[k]
                                       for k in ("outputs", "calls")}},
                  checks=checks)
    return result
