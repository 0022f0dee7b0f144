"""Variants of the split5 tensor-core kernel, timed and checked on one GPU.

    python3 tools/split5_ablate.py

Builds the port's kernel library once per variant of
``speex_resampler_tpu_torch/csrc/split5_wgmma.cuh`` (a copy of ``csrc/``
with the variant's text edits, under ``build/split5_variants/<name>/``),
then for each variant and each split5 launch the port serves (96 kHz ->
8 kHz q10 tiled; 48 kHz -> 44.1 kHz q10 and 44.1 kHz -> 16 kHz q7
streamed; B = 2048) prints the kernel's median time and its band rate
(10 FLOP per band multiply-add), and for the variants that compute the
function, the max |err| and mismatch rate against the plain version at
B = 2048 and 130.  The variants:

- ``as built``: the source as it stands;
- ``no promotion``: d_1 kept in one wgmma accumulator over the whole band;
- ``promotion every stage``: every 32 taps instead of every 64;
- ``lead 2`` / ``lead 4``: copies 2 or 4 stages ahead instead of 3;
- ``no copies``: no copies inside the stage loop (the wgmma loop's own
  time, x fragments and barriers included; wrong output);
- ``staging only``: no wgmma (the copies', x fragments' and barriers' own
  time; wrong output).

Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from speex_resampler_tpu_torch.ops import filter_design as fd  # noqa: E402
from speex_resampler_tpu_torch.parallel import batch as tb  # noqa: E402
from tools import _variants  # noqa: E402

HEADER = "split5_wgmma.cuh"
MMAS = ("      mma(acc[0], x_hi[j % 2], w_hi, !restart);\n",
        "      mma(acc[1], x_lo[j % 2], w_hi, 1);\n",
        "      mma(acc[2], x_hi[j % 2], w_mid, 1);\n",
        "      mma(acc[3], x_lo[j % 2], w_mid, 1);\n",
        "      mma(acc[4], x_hi[j % 2], w_lo, 1);\n")
#: name -> (text edits of the header, computes the function)
VARIANTS = {
    "as built": ({}, True),
    "no promotion": ({
        "      const bool restart = j == 0 && s % kPromote == 0;\n":
        "      const bool restart = false;\n",
        "    if ((s + 1) % kPromote == 0 || s + 1 == n_stages) {\n":
        "    if (s + 1 == n_stages) {\n"}, True),
    "promotion every stage": ({"kPromote = 2;": "kPromote = 1;"}, True),
    "lead 2": ({"kLead = 3;": "kLead = 2;"}, True),
    "lead 4": ({"kLead = 3;": "kLead = 4;"}, True),
    "no copies": ({"      if (j == 0) copy_stage(s + kLead);\n": ""}, False),
    "staging only": (dict.fromkeys(MMAS, ""), False),
}
#: (in, out, quality, target frames, scheme)
LAUNCHES = [(96000, 8000, 10, 30720, "auto"),
            (48000, 44100, 10, 20480, "split5"),
            (44100, 16000, 7, 7056, "split5")]


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("split5_ablate: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    cases = []
    for i, o, q, target, scheme in LAUNCHES:
        g = math.gcd(i, o)
        spec = fd.design_filter(i // g, o // g, q)
        bspec = tb._launch_geometry(spec, target)
        step = tb.make_batched_step(spec, bspec, device="cuda", scheme=scheme)
        inputs = [cs.card_inputs(step, bspec.in_per_launch, B, seed=B)
                  for B in (cs.LANES, 130)]
        want = [cs.plain(h, x, step).cpu().numpy() for h, x in inputs]
        band = cs.launch_bound(spec, step, bspec, cs.LANES)[5]
        cases.append((f"{i // 1000}k->{o / 1000:g}k q{q}", step, inputs,
                      want, band))
    for name, (edits, exact) in VARIANTS.items():
        print(f"== {name}: " + _variants.build(
            "split5_variants", name, HEADER, edits,
            lambda kernel: "split5" in kernel))
        for label, step, inputs, want, band in cases:
            line = []
            if exact:
                for (h, x), w in zip(inputs, want):
                    got = cs.launch(h, x, step).cpu().numpy()
                    d = np.abs(got.astype(np.int32) - w.astype(np.int32))
                    line.append(f"B={h.shape[1]} max|err|={d.max()} "
                                f"mismatches {(d > 0).mean():.3e}")
            h, x = inputs[0]
            ms = cs.cuda_ms(lambda: cs.launch(h, x, step), 20)
            line.append(f"{ms:.4f} ms ({10 * band / ms / 1e9:.0f} TFLOP/s "
                        f"of band products)")
            print(f"   {name}, {label}: " + "; ".join(line))


if __name__ == "__main__":
    main()
