"""``chip_smoke.py``'s phase 9 alone, or parts of it, on the visible cards.

    python3 tools/phase9.py [--fn] [--capture] [--array] [--mesh]

Builds the kernels from this checkout, then runs the parts named (all of
them when none is): ``--fn`` the functional step at the flagship (float
and fixed) and 48 kHz -> 44.1 kHz q10, eager against the CUDA engine and a
CPU step and in one CUDA graph against the eager stage, with its eager
and graph ms a quantum; ``--capture`` the dense and gather steps in a CUDA
graph; ``--array`` ``resample_array`` on the card against the CPU;
``--mesh`` the flagship engine on two shards of cuda:0 and on a mesh of
every visible card against the unmeshed engine, with ms a ``process()``
call (run it with four cards to split the lanes over four).  Each part
raises on a failed check.  Prints the cards' names and power limits.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from speex_resampler_tpu_torch.ops import _build  # noqa: E402

PARTS = ("fn", "capture", "array", "mesh")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    for part in PARTS:
        ap.add_argument(f"--{part}", action="store_true")
    args = ap.parse_args()
    parts = [p for p in PARTS if getattr(args, p)] or list(PARTS)
    if not torch.cuda.is_available():
        sys.exit("phase9: no CUDA device")
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    smi = cards[0]
    print(f"cards: {cards}; torch {torch.__version__}")
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    _build.load()
    print(f"build: {time.time() - t0:.1f} s")
    if "fn" in parts:
        for name, rates, target, fixed, kind in cs.FN_CASES:
            rs, _ = cs.functional_check(name, rates, target, fixed, kind)
            cs.functional_time(name, rs, smi)
    if "capture" in parts:
        cs.capture_geometries()
    if "array" in parts:
        cs.array_check()
    if "mesh" in parts:
        cs.mesh_check(smi)
    print(f"phase 9 parts {parts}: {time.time() - t0:.1f} s")


if __name__ == "__main__":
    main()
