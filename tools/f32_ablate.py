"""Variants of the f32 ("highest") kernels, timed and checked on one GPU.

    python3 tools/f32_ablate.py [--parent CSRC_DIR] [--only NAME ...]
                                [--repeat N]

Builds the port's kernel library once per variant of
``speex_resampler_tpu_torch/csrc/f32_fir.cuh`` (a copy of ``csrc/`` with
the variant's text edits under ``build/f32_variants/<name>/``, made by
``tools/_variants.py``), then for each variant and each "highest" launch
(44.1 kHz -> 48 kHz q7 tiled, 48 kHz -> 44.1 kHz q10 streamed, 96 kHz ->
8 kHz q10 tiled; B = 2048) prints the kernel's median time and its FMA rate over the
multiply-adds the function needs, and the max |err| and mismatch rate
against the plain version at B = 2048, 130, 129 (2-byte x loads) and 64.
The variants are the design's steps, in order, alternatives and parts:

- ``step 1``: the cp.async ring of 16-tap stages; the first f32 kernel's
  8-row x 4-lane thread tile (256 threads a CTA), x converted from int16
  inside the FMA loop, every warp walking the 64-row band;
- ``step 2``: = 1, x converted to f32 once a stage;
- ``step 3``: = 2, an 8 x 8 thread tile (128 threads) and 32-tap stages;
- ``step 4``: = 3, each warp skipping the 8-tap slices outside its 16-row
  sub-band;
- ``step 5``: = 4 with 16-tap stages (the source as it stands);
- ``no sub-bands``: = 5 without the skip;
- ``16-tap slices``: = 5, a warp skipping whole stages only;
- ``8-tap stages``: = 5 with 8-tap stages;
- ``lead 3``: = 5 with copies 3 stages ahead (a ring of 4);
- ``exact taps``: = 5, each warp running exactly its sub-band's taps (a
  loop of dynamic length) instead of whole 8-tap slices;
- ``8 x 4 tile``: = 5 with 8 rows x 4 lanes a thread (256 threads);
- ``8 x 16 tile``: = 5 with 8 rows x 16 lanes a thread (a warp 16 rows x
  256 lanes, 256 lanes a CTA): 6 shared loads per 128 FFMAs, not 4 per 64;
- ``min 3 CTAs``: = 5 with registers capped for 3 CTAs an SM;
- ``multiply only``: = 5 (or the 8 x 16 tile) with no copies (the product
  loop, conversion and barriers alone; wrong output);
- ``staging only``: = 5 with no multiply-adds (copies, conversion and
  barriers alone; wrong output).

With ``--parent``, a ``csrc/`` directory of an earlier checkout is built
too, its streamed f32 entry point (both geometries at their closed-form
origins, called with its own 64-row tap table) is timed on the same
launches, and each variant is held against them bit for
bit: every variant computes each output's FMA chain in the same order, so
0 outputs may differ.

Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from speex_resampler_tpu_torch.ops import _build  # noqa: E402
from speex_resampler_tpu_torch.ops import filter_design as fd  # noqa: E402
from speex_resampler_tpu_torch.ops import tiled_fir as tf  # noqa: E402
from speex_resampler_tpu_torch.parallel import batch as tb  # noqa: E402
from tools import _variants  # noqa: E402

HEADER = "f32_fir.cuh"
NO_SKIP = {"      if (!(st + j * kSlice < sb_hi && "
           "st + (j + 1) * kSlice > sb_lo))\n        continue;\n": ""}
STAGE32 = {"kStageTaps = 16;": "kStageTaps = 32;"}
TILE84 = {"kTN = 8;": "kTN = 4;", "kTN == 8,": "kTN == 4,"}
TILE816 = {"kTN = 8;": "kTN = 16;", "kLanes = 128;": "kLanes = 256;",
           "kTN == 8,": "kTN == 16,"}
# x converted from int16 inside the FMA loop, no f32 buffers
IN_LOOP = {"kXfBytes = kStageTaps * kLanes * 4;": "kXfBytes = 0;",
           "    const float* xs = xf(s);\n":
           "    const int16_t* raw =\n"
           "        reinterpret_cast<const int16_t*>(slot(s) + kWBytes);\n",
           "load4(xr + 4 * c, xs + t": "load4_i16(xr + 4 * c, raw + t",
           "wait<kLead - 2>();": "wait<kLead - 1>();",
           "    convert(0);\n    __syncthreads();\n": "",
           "    if (s + 1 < n) convert(s + 1);\n": ""}
NO_COPIES = {"    if (s < n) {\n      uint8_t* buf = slot(s);":
             "    if (false) {\n      uint8_t* buf = slot(s);"}
SLICES = """#pragma unroll
    for (int j = 0; j < kStageTaps / kSlice; ++j) {
      if (!(st + j * kSlice < sb_hi && st + (j + 1) * kSlice > sb_lo))
        continue;
#pragma unroll
      for (int kk = 0; kk < kSlice; ++kk) {
        const int t = j * kSlice + kk;
"""
TAPS = """    {
      const int t_a = max(sb_lo - st, 0), t_b = min(sb_hi - st, kStageTaps);
#pragma unroll 4
      for (int t = t_a; t < t_b; ++t) {
"""
#: name -> (edits of the header, computes the function)
VARIANTS = {
    "step 1": ({**TILE84, **NO_SKIP, **IN_LOOP}, True),
    "step 2": ({**TILE84, **NO_SKIP}, True),
    "step 3": ({**NO_SKIP, **STAGE32}, True),
    "step 4": (STAGE32, True),
    "step 5": ({}, True),
    "no sub-bands": (NO_SKIP, True),
    "16-tap slices": ({"kSlice = 8;": "kSlice = 16;"}, True),
    "8-tap stages": ({"kStageTaps = 16;": "kStageTaps = 8;"}, True),
    "lead 3": ({"kLead = 2;": "kLead = 3;"}, True),
    "exact taps": ({SLICES: TAPS}, True),
    "8 x 4 tile": (TILE84, True),
    "8 x 16 tile": (TILE816, True),
    "min 3 CTAs": ({"kMinBlocks = 2;": "kMinBlocks = 3;"}, True),
    "multiply only": (NO_COPIES, False),
    "8 x 16 tile, multiply only": ({**TILE816, **NO_COPIES}, False),
    "staging only": ({"            acc[a][b] = __fmaf_rn(wr[a], xr[b], "
                      "acc[a][b]);\n": "            (void)0;\n"}, False),
}
#: (in, out, quality, target frames)
LAUNCHES = [(44100, 48000, 7, 9408), (48000, 44100, 10, 20480),
            (96000, 8000, 10, 30720)]
CHECK_LANES = (cs.LANES, 130, 129, 64)
FMA_PER_S = cs.FP32_FLOPS / 2


def _f32(kernel: str) -> bool:
    return "f32" in kernel and "dense" not in kernel


def parent_library(csrc: Path):
    """The library of another checkout's ``csrc/``, with the argument
    types of its streamed f32 entry point."""
    out = ROOT / "build" / "f32_variants" / "parent" / "libfir.so"
    shutil.rmtree(out.parent, ignore_errors=True)
    _build.use_csrc(csrc)
    _build.compile_library(out)
    lib = _build.declare(ctypes.CDLL(str(out)), ("streamed_fir_f32",))
    print(f"parent {csrc}: " + _variants.ptxas(out.parent, _f32))
    return lib


def parent_launch(lib, hist, x, step):
    """The earlier kernel on one launch (its own 64-row tap table): a
    function that launches it without synchronising, and its output."""
    w = step.w[0]
    P, K, R = w.shape
    taps = torch.from_numpy(tf.tap_ranges((w != 0).cpu().numpy())).cuda()
    kw = step.kernel_kw
    H, B = hist.shape
    y = torch.empty((kw["n_blocks"] * R, B), dtype=torch.int16,
                    device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    args = (hist.data_ptr(), x.data_ptr(), y.data_ptr(), taps.data_ptr(),
            w.data_ptr(), H, x.shape[0], B, R, K, P, kw["n_blocks"],
            kw["shift"], kw["num"], kw["den"], kw["f0"], stream)
    fn = lib.streamed_fir_f32

    def run(_keep=(taps, y)):        # the pointers' tensors stay alive
        if fn(*args):
            raise RuntimeError("parent kernel launch failed")
    return run, y


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--only", nargs="*", default=None)
    ap.add_argument("--repeat", type=int, default=1,
                    help="run the variants this many times, in turn")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("f32_ablate: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    cases = []
    for i, o, q, target in LAUNCHES:
        g = math.gcd(i, o)
        spec = fd.design_filter(i // g, o // g, q)
        bspec = tb._launch_geometry(spec, target)
        step = tb.make_batched_step(spec, bspec, device="cuda",
                                    scheme="highest")
        inputs = [cs.card_inputs(step, bspec.in_per_launch, B, seed=B)
                  for B in CHECK_LANES]
        want = [cs.plain(h, x, step).cpu().numpy() for h, x in inputs]
        bound = cs.launch_bound(spec, step, bspec, cs.LANES)
        cases.append((f"{i / 1000:g}k->{o / 1000:g}k q{q} {step.kernel}",
                      step, inputs, want, bound))
    parent = None
    if args.parent is not None:
        lib = parent_library(args.parent)
        parent = []
        for label, step, inputs, _, _ in cases:
            outs = []
            for h, x in inputs:
                run, y = parent_launch(lib, h, x, step)
                run()
                torch.cuda.synchronize()
                outs.append(y.cpu().numpy())
            parent.append(outs)
            run, _ = parent_launch(lib, *inputs[0], step)
            print(f"   parent, {label}: "
                  f"{cs.cuda_ms(run, 20):.4f} ms at B = {cs.LANES}")
    for name, (edits, exact) in list(VARIANTS.items()) * args.repeat:
        if args.only and name not in args.only:
            continue
        print(f"== {name}: " + _variants.build("f32_variants", name, HEADER,
                                               edits, _f32))
        for c, (label, step, inputs, want, bound) in enumerate(cases):
            line = []
            for b, ((h, x), w) in enumerate(zip(inputs, want)):
                if not exact:
                    break
                got = cs.launch(h, x, step).cpu().numpy()
                d = np.abs(got.astype(np.int32) - w.astype(np.int32))
                line.append(f"B={h.shape[1]} max|err|={d.max()} "
                            f"mismatches {int((d > 0).sum())} "
                            f"({(d > 0).mean():.3e})")
                if parent is not None:
                    line[-1] += (f", vs parent "
                                 f"{int((got != parent[c][b]).sum())} differ")
            h, x = inputs[0]
            ms = cs.cuda_ms(lambda: cs.launch(h, x, step), 20)
            bound_ms, _, _, _, macs, walked = bound
            line.append(f"{ms:.4f} ms, {bound_ms / ms:.3f} of the bound "
                        f"{bound_ms:.4f} ms, {macs / ms / 1e9:.2f} T "
                        f"needed FMA/s ({macs / ms * 1e3 / FMA_PER_S:.3f} of "
                        f"peak), sub-band walk {walked / 1e9:.2f} G")
            print(f"   {name}, {label}: " + "; ".join(line))


if __name__ == "__main__":
    main()
