"""The gather kernels' forms side by side, and the fixed dense kernel:
``chip_smoke.py``'s phases 3 and 5 for the voip fixed, drift, drift fixed,
steep and steep fixed paths, then a sweep of ratios and lane counts, on
one GPU.

    python3 tools/gather_timing.py [--sweep-only]

Builds the kernels from this checkout, prints the ``-Xptxas -v`` lines of
``csrc/gather_fir.cu`` and of the fixed dense kernels and the SASS check,
holds ``dense_fir_fixed_kernel<4>`` and the forms of the float and fixed
gathers (rows, float only: ``gather_fir_f32_kernel``; band:
``gather_fir_f64mma_kernel``, ``gather_fir_fixed_band_kernel<4>``;
stream: ``gather_fir_f64mma_stream_kernel``,
``gather_fir_fixed_stream_kernel<4>``) against their plain versions at
their paths' launches
(``chip_smoke.check_kernels``: fixed 0 mismatches with the wrap lanes, the
float gather within the tie bound), then times each
(``chip_smoke.time_launch``: back to back, in a CUDA graph, one launch at
a time, the plain version, the library call where there is one, the
bound).

The sweep, the measurement behind ``fir_matmul.gather_plan``'s choice
(the band form wherever it fits, else the stream form): 44.1k -> 44.101k
q7, q1 and q0 (the drift's sparsest bands: N 16 and 8), 48000 -> 44101
q7, and 96000 -> 401 q3, q1 and q0 (a steep decimation, whose band is
too wide to be resident: the stream form, its sparsest band at q0), float
and fixed, at B = 2048, 130, 64 and 2, the band form where it fits, else
the stream form, and the float rows form (each forced through an explicit
plan) checked against the plain version (fixed bit for bit, with the wrap
input where the filter can pass 2^31; float within the tie bound) and
timed back to back; printed with the band's density (N over its K taps
an output), the walked multiply-adds and ms per G needed multiply-adds,
and the float rows / band or rows / stream ratio.  Raises on a failed check.
Prints the card's name and power limit.
"""

from __future__ import annotations

import math
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from speex_resampler_tpu_torch.ops import _build  # noqa: E402
from speex_resampler_tpu_torch.ops import filter_design as fd  # noqa: E402
from speex_resampler_tpu_torch.parallel import batch as tb  # noqa: E402

RATIOS = ((44100, 44101, 7), (44100, 44101, 1), (44100, 44101, 0),
          (48000, 44101, 7), (96000, 401, 3), (96000, 401, 1),
          (96000, 401, 0))
LANE_COUNTS = (2048, 130, 64, 2)


def sweep(smi: str) -> None:
    """The forms across RATIOS x {float, fixed} x LANE_COUNTS."""
    print(f"sweep on {smi}: ratio universe B form | ms back to back | "
          "density N/K | walked G MACs | ms per needed G MACs")
    for (i, o, q) in RATIOS:
        g = math.gcd(i, o)
        for fixed in (False, True):
            spec = fd.design_filter(i // g, o // g, q, fixed_point=fixed)
            bspec = tb._launch_geometry(spec, 44100)
            step = tb.make_batched_step(spec, bspec, device="cuda")
            scheme = "fixed" if fixed else "highest"
            N = spec.filt_len
            forms = cs.gather_forms(step)
            wraps = fixed and cs.fixed_inputs.wrap_input(
                step, np.zeros((step.chunk_rows, 1), np.int16), [0]) > 2 ** 31
            for B in LANE_COUNTS:
                # the wrap input where the filter can drive a sum past
                # 2^31 (not the steep decimation's small direct taps, nor
                # q0 and q1's short filters)
                hist, x = cs.card_inputs(step, bspec.in_per_launch, B,
                                         seed=B, wrap=fixed and wraps)
                want = cs.plain(hist, x, step).cpu().numpy()
                ms = {}
                for form in forms:
                    got = cs.launch(hist, x, step, form).cpu().numpy()
                    cs.compare(got, want, scheme,
                               f"{i}->{o} q{q} {scheme} {form} B={B}")
                    ms[form] = cs.cuda_ms(
                        cs.kernel_call(hist, x, step, form=form), 20)
                    _, _, _, _, macs, walked = cs.launch_bound(
                        spec, step, bspec, B, form)
                    plan = cs.gather_kw(step, form)["plan"]
                    density = (f"{N / plan.taps:.3f}" if form != "rows"
                               else "-")
                    print(f"  {i}->{o} q{q} {scheme:7s} B={B:4d} {form:4s} "
                          f"| {ms[form]:.4f} | {density} | "
                          f"{walked / 1e9:.3f} | "
                          f"{ms[form] / (macs / 1e9):.5f}")
                if "rows" in ms:
                    print(f"  {i}->{o} q{q} {scheme:7s} B={B:4d} rows / "
                          f"{forms[0]} = {ms['rows'] / ms[forms[0]]:.3f}")


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
    if "--sweep-only" not in sys.argv:
        max_err: dict = {}
        for path in (cs.VOIP_FIXED, cs.DRIFT, cs.DRIFT_FIXED, cs.STEEP,
                     cs.STEEP_FIXED):
            cs.check_kernels(path, ("auto",), max_err)
            bspec = path.geometry()
            step = tb.make_batched_step(path.spec, bspec, device="cuda")
            forms = (cs.gather_forms(step) if step.kernel == "gather"
                     else (None,))
            for form in forms:
                cs.time_launch(f"{path.name} {form or ''}", path.spec, step,
                               bspec, smi, reps=20, form=form)
    sweep(smi)


if __name__ == "__main__":
    main()
