"""The readings that the correctness limits are set from, on the card.

    python3 perfbench/calibrate.py --workload <name> [--seeds 12]
        [--control-seeds 3] [--seconds 2] [--out FILE]

In one process, with the cell's own traffic and sizes and a short
window each: the program's readings on ``--seeds`` seeds (the lower
readings are their largest), the control's (the plain reference in a
lower precision in the program's place) and each fault's, both of the
cell's entry (``entries/<entry>.py``: ``control``, ``FAULTS``), on
``--control-seeds`` seeds (the upper readings are the control's
smallest).  Prints one JSON line a run and a summary
line last; with ``--out``, writes them there too.  The benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FIRST_SEED = 3_100_000_000


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench import manifest
    from perfbench.cell import run_cell
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    cell = manifest.cell(args.workload, ROOT)
    entry = manifest.entry(cell.traffic["entry"], ROOT)
    reference = manifest.reference(cell.config, ROOT)

    def control(config, device):
        return entry.control(config, reference, device)
    lines = []

    def run(kind, seed, program=None):
        r = run_cell(cell, seed, args.seconds, False, device="cuda",
                     program=program)
        line = {"workload": cell.name, "kind": kind, "seed": seed,
                "correct": r["correct"], "calls": r["attempted"],
                "readings": {k: c["value"] for k, c in r["checks"].items()},
                "limits": {k: c["limit"] for k, c in r["checks"].items()},
                "metrics": {k: m["value"] for k, m in r["metrics"].items()}}
        print(json.dumps(line), flush=True)
        lines.append(line)

    seeds = [FIRST_SEED + 7919 * i for i in range(args.seeds)]
    for seed in seeds:
        run("program", seed)
    for seed in seeds[:args.control_seeds]:
        run("control", seed, control)
        for name, fault in entry.FAULTS.items():
            run(name, seed, fault)

    summary = {"workload": cell.name, "summary": {}}
    for name in lines[0]["readings"]:
        prog = [x["readings"][name] for x in lines if x["kind"] == "program"]
        ctrl = [x["readings"][name] for x in lines if x["kind"] == "control"]
        summary["summary"][name] = {"lower": max(prog), "upper": min(ctrl),
                                    "program": prog, "control": ctrl}
    summary["faults_correct"] = {
        k: [x["correct"] for x in lines if x["kind"] == k]
        for k in entry.FAULTS}
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(
            "".join(json.dumps(x) + "\n" for x in lines + [summary]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
