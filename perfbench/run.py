"""Run one cell of the benchmark once and print its result.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cell's chips.  Prints
one JSON object as the last line of standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (``--trace 0``: the cell's
end-to-end metrics; ``--trace 1``: its per-layer metrics), ``device``
(and, traced, ``breakdown``), and last ``checks``, each number compared
with its limit, which also end standard error.  Exits with a code other
than 0 and prints no result where the card or the cell's chips are
missing, or where JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

_T0 = time.perf_counter()
ROOT = Path(__file__).resolve().parent.parent
#: top-level modules that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "speex_resampler_tpu")


def process_age_s() -> float:
    """Seconds since this process started (its start time in
    ``/proc/self/stat``, at clock-tick resolution); since this module
    was loaded where that is unreadable."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        age = (time.clock_gettime(time.CLOCK_BOOTTIME)
               - int(fields[19]) / os.sysconf("SC_CLK_TCK"))
        if 0.0 <= age < 3600.0:
            return age
    except (OSError, ValueError, IndexError, AttributeError):
        pass
    return time.perf_counter() - _T0


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _caches_in_checkout() -> None:
    """Every build and kernel cache at a fixed path in the checkout."""
    cache = ROOT / "build" / "cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    _caches_in_checkout()
    # set-up is timed from here: the interpreter and ``import torch`` are
    # the environment's, which no change to the program moves; their
    # seconds since the process started are recorded beside it
    marks = {"interpreter_s": process_age_s()}
    import torch
    t_setup = time.perf_counter()
    marks["import_torch_s"] = process_age_s()

    def setup_clock() -> float:
        return time.perf_counter() - t_setup

    from perfbench.manifest import cell as find_cell
    cell = find_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    marks["device_count_s"] = setup_clock()
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    from perfbench.cell import run_cell
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      device="cuda", setup_clock=setup_clock)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    result["window"]["setup_parts"].update(marks)
    result["window"]["power_limit"] = _power_limit()
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def _power_limit() -> str | None:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i",
             os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None


if __name__ == "__main__":
    sys.exit(main())
