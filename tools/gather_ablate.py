"""Variants of the gather kernels, timed and checked on one GPU.

    python3 tools/gather_ablate.py [--only rows,stream,band]

Builds the port's kernel library once per variant of
``speex_resampler_tpu_torch/csrc/gather_fir.cu`` (a copy of ``csrc/`` with
the variant's text edits, under ``build/gather_variants/<name>/``,
``tools/_variants.py``), then for each variant prints the times of the
kernels it changes, back to back and from a CUDA graph
(``chip_smoke.cuda_ms``), and, for the variants that compute the
function, the mismatches against the plain version at B = 2048 and 130
(fixed: 0; float: within the tie bound).  The kernels, B = 2048: the band
form at the drift launches (44.1 kHz -> 44.101 kHz q7, float and fixed:
``gather_fir_f64mma_kernel<short>``, ``gather_fir_fixed_band_kernel<4>``);
the stream forms at the steep decimation (96 kHz -> 401 Hz q3:
``gather_fir_f64mma_stream_kernel<short>``,
``gather_fir_fixed_stream_kernel<4>``), and there the float rows form
(``gather_fir_f32_kernel<short, 1>``, forced).  A variant named "rows:
..." times the rows kernel, "stream: ..." the stream kernels, any other
the band kernels; "as built" all of them.  The variants:

- ``as built``: the source as it stands (a fixed band CTA walks 16 lane
  tiles with its band resident, a float one 8; a streamed CTA's ring of 4
  stages (float) or 6 (fixed), two 64-lane tiles a fixed streamed CTA, K
  split over up to 8 CTAs a tile where the CTAs do not fill a wave);
- ``fixed: lane tiles 8`` / ``32``, ``float: lane tiles 16`` / ``32``:
  another count (32: one CTA a group at B = 2048);
- ``float: B bits, no conversion``: the float band kernel's B fragments
  are the staged samples' bits, sign-extended, taken as doubles: the
  shared loads stay, the int16 -> f64 conversions go (wrong output);
- ``float: no B loads``: constant B fragments: neither the loads nor the
  conversions (wrong output);
- ``rows: staging alone``: the rows kernel stages every piece of rows and
  every tap chunk but walks no row (wrong output): the staging's time;
- ``rows: dots alone``: it stages only a CTA's first piece and first tap
  chunk, then walk every piece's rows over it (wrong output): the dots'
  time, with the barriers;
- ``stream: float ring 3`` / ``6``, ``stream: fixed ring 4`` / ``8``:
  another ring (the float copies run the ring less one stage ahead, the
  fixed ones the ring less two);
- ``stream: fixed lane tiles 1``: one warpgroup a fixed streamed CTA, so
  a staged band slice serves one 64-lane tile;
- ``stream: split off``: no K split (one CTA a tile and lane chunk).

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
ROWS_WALKED = ("const int lo = max(d_min, r0), "
               "hi = min(d_max + kc, r0 + n_rows);")
ROWS_TAPS = "if (r0 == 0) stage_taps(ts, t0, kc);"
ROWS_X = "stage_x<XT>(g, base + t0 + r0, n_rows, lane0, xs);"
F64_RING = "constexpr int kF64StreamRing = 4;"
FIXED_RING = "constexpr int kFixedStreamRing = 6;"
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
    "rows: staging alone": ({ROWS_WALKED: "const int lo = 0, hi = 0;"},
                            False),
    "rows: dots alone": ({
        ROWS_TAPS: "if (t0 == 0 && r0 == 0) stage_taps(ts, t0, kc);",
        ROWS_X: f"if (t0 == 0 && r0 == 0) {ROWS_X}"}, False),
    "stream: float ring 3": ({F64_RING: F64_RING.replace("= 4", "= 3")},
                             True),
    "stream: float ring 6": ({F64_RING: F64_RING.replace("= 4", "= 6")},
                             True),
    "stream: fixed ring 4": ({FIXED_RING: FIXED_RING.replace("= 6", "= 4")},
                             True),
    "stream: fixed ring 8": ({FIXED_RING: FIXED_RING.replace("= 6", "= 8")},
                             True),
    "stream: fixed lane tiles 1": ({"constexpr int kStreamWgs = 2;":
                                    "constexpr int kStreamWgs = 1;"}, True),
    "stream: split off": ({"constexpr int kStreamMaxSplit = 8;":
                           "constexpr int kStreamMaxSplit = 1;"}, True),
}


def form_of(variant: str) -> str | None:
    """The form whose kernels a variant changes (None: every form)."""
    head = variant.split(":")[0]
    return None if variant == "as built" else (
        head if head in ("rows", "stream") else "band")


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("gather_ablate: no CUDA device")
    only = None
    if "--only" in sys.argv:
        only = sys.argv[sys.argv.index("--only") + 1].split(",")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    cases = []
    for path, forms in ((cs.DRIFT, ("band",)), (cs.DRIFT_FIXED, ("band",)),
                        (cs.STEEP, ("rows", "stream")),
                        (cs.STEEP_FIXED, ("stream",))):
        forms = [f for f in forms if only is None or f in only]
        if not forms:
            continue
        bspec = path.geometry()
        step = tb.make_batched_step(path.spec, bspec, device="cuda")
        inputs = [cs.card_inputs(step, bspec.in_per_launch, B, seed=B,
                                 wrap=path.wrap) for B in (cs.LANES, 130)]
        want = [cs.plain(h, x, step).cpu().numpy() for h, x in inputs]
        cases += [(f"{path.name} {form}", form, step, inputs, want)
                  for form in forms]
    for name, (edits, exact) in VARIANTS.items():
        target = form_of(name)
        if only is not None and target is not None and target not in only:
            continue
        print(f"== {name}: " + _variants.build(
            "gather_variants", name, HEADER, edits,
            lambda kernel: "gather" in kernel))
        for label, form, step, inputs, want in cases:
            if target not in (None, form):
                continue
            line = []
            if exact:
                for (h, x), w in zip(inputs, want):
                    got = cs.launch(h, x, step, form).cpu().numpy()
                    err, mism = cs.compare(got, w, step.scheme,
                                           f"{name} {label}")
                    line.append(f"B={h.shape[1]} max|err|={err} "
                                f"mismatches={mism}")
            h, x = inputs[0]
            run = cs.kernel_call(h, x, step, form=form)
            line.append(f"{cs.cuda_ms(run, 20):.4f} ms back to back, "
                        f"{cs.cuda_ms(run, 20, mode='graph'):.4f} in a graph")
            print(f"   {name}, {label} ({smi}): " + "; ".join(line))


if __name__ == "__main__":
    main()
