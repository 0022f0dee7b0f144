"""Variants of the band gather kernels, timed and checked on one GPU.

    python3 tools/gather_ablate.py

Builds the port's kernel library once per variant of
``speex_resampler_tpu_torch/csrc/gather_fir.cu`` (a copy of ``csrc/`` with
the variant's text edits, under ``build/gather_variants/<name>/``,
``tools/_variants.py``), then for each variant prints the band kernels'
times at the drift launches (44.1 kHz -> 44.101 kHz q7, float and fixed,
B = 2048: ``gather_fir_f64mma_kernel<short>`` and
``gather_fir_fixed_band_kernel<4>``), back to back and from a CUDA graph
(``chip_smoke.cuda_ms``), and, for the variants that compute the
function, the mismatches against the plain version at B = 2048 and 130
(fixed: 0; float: within the tie bound).  The variants:

- ``as built``: the source as it stands (a fixed CTA walks 16 lane
  tiles with its band resident, a float one 8);
- ``fixed: lane tiles 8`` / ``32``, ``float: lane tiles 16`` / ``32``:
  another count (32: one CTA a group at B = 2048);
- ``float: B bits, no conversion``: the float kernel's B fragments are
  the staged samples' bits, sign-extended, taken as doubles: the shared
  loads stay, the int16 -> f64 conversions go (wrong output);
- ``float: no B loads``: constant B fragments: neither the loads nor the
  conversions (wrong output).

Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from speex_resampler_tpu_torch.parallel import batch as tb  # noqa: E402
from tools import _variants  # noqa: E402

HEADER = "gather_fir.cu"
FIXED_TILES = "constexpr int kFixedLaneTiles = 16;"
F64_TILES = "constexpr int kF64LaneTiles = 8;"
B_FRAGMENT = """\
        const double b[2] = {static_cast<double>(xb[k * kF64Pitch + 8 * s]),
                             static_cast<double>(
                                 xb[(k + 4) * kF64Pitch + 8 * s])};
"""
#: name -> (text edits of the source, computes the function)
VARIANTS = {
    "as built": ({}, True),
    "fixed: lane tiles 8": ({FIXED_TILES: FIXED_TILES.replace("16", "8")},
                            True),
    "fixed: lane tiles 32": ({FIXED_TILES: FIXED_TILES.replace("16", "32")},
                             True),
    "float: lane tiles 16": ({F64_TILES: F64_TILES.replace("8", "16")},
                             True),
    "float: lane tiles 32": ({F64_TILES: F64_TILES.replace("8", "32")},
                             True),
    "float: B bits, no conversion": ({B_FRAGMENT: """\
        const double b[2] = {
            __longlong_as_double((long long)xb[k * kF64Pitch + 8 * s]),
            __longlong_as_double((long long)xb[(k + 4) * kF64Pitch + 8 * s])};
"""}, False),
    "float: no B loads": ({B_FRAGMENT: """\
        const double b[2] = {1.0, 0.5};
"""}, False),
}


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("gather_ablate: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    cases = []
    for path in (cs.DRIFT, cs.DRIFT_FIXED):
        bspec = path.geometry()
        step = tb.make_batched_step(path.spec, bspec, device="cuda")
        inputs = [cs.card_inputs(step, bspec.in_per_launch, B, seed=B,
                                 wrap=path.fixed) for B in (cs.LANES, 130)]
        want = [cs.plain(h, x, step).cpu().numpy() for h, x in inputs]
        cases.append((path.name, step, inputs, want))
    for name, (edits, exact) in VARIANTS.items():
        print(f"== {name}: " + _variants.build(
            "gather_variants", name, HEADER, edits,
            lambda kernel: "band" in kernel or "f64mma" in kernel))
        for label, step, inputs, want in cases:
            line = []
            if exact:
                for (h, x), w in zip(inputs, want):
                    got = cs.launch(h, x, step).cpu().numpy()
                    err, mism = cs.compare(got, w, step.scheme,
                                           f"{name} {label}")
                    line.append(f"B={h.shape[1]} max|err|={err} "
                                f"mismatches={mism}")
            h, x = inputs[0]
            run = cs.kernel_call(h, x, step)
            line.append(f"{cs.cuda_ms(run, 20):.4f} ms back to back, "
                        f"{cs.cuda_ms(run, 20, mode='graph'):.4f} in a graph")
            print(f"   {name}, {label} ({smi}): " + "; ".join(line))


if __name__ == "__main__":
    main()
