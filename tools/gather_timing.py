"""The gather and fixed dense kernels alone: ``chip_smoke.py``'s phases 3
and 5 for the voip fixed, drift and drift fixed paths, on one GPU.

    python3 tools/gather_timing.py

Builds the kernels from this checkout, prints the ``-Xptxas -v`` lines of
``csrc/gather_fir.cu`` and of the fixed dense kernels and the SASS check,
holds ``dense_fir_fixed_kernel<4>``, ``gather_fir_f32_kernel`` and
``gather_fir_fixed_kernel<4>`` against their plain versions at their
paths' launches (``chip_smoke.check_kernels``: fixed 0 mismatches with
the wrap lanes, the float gather within the tie bound), then times each
(``chip_smoke.time_launch``: back to back, in a CUDA graph, one launch at
a time, the plain version, the library call where there is one, the
bound).  Raises on a failed check.  Prints the card's name and power
limit.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from speex_resampler_tpu_torch.ops import _build  # noqa: E402
from speex_resampler_tpu_torch.parallel import batch as tb  # noqa: E402


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("gather_timing: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load()
    for log in sorted(_build.build_dir().glob("*.log")):
        for name, lines in cs.ptxas_props(log).items():
            if name.startswith(("gather_fir", "dense_fir_fixed")):
                print(f"  ptxas {log.stem} {name}: {'; '.join(lines)}")
    cs.sass_check()
    max_err: dict = {}
    for path in (cs.VOIP_FIXED, cs.DRIFT, cs.DRIFT_FIXED):
        cs.check_kernels(path, ("auto",), max_err)
        bspec = path.geometry()
        step = tb.make_batched_step(path.spec, bspec, device="cuda")
        cs.time_launch(path.name, path.spec, step, bspec, smi, reps=20)


if __name__ == "__main__":
    main()
