"""Runs the tensor-core probes on the card and writes their results.

    python3 tools/tc_probes.py [--out build/torch_probes]
        [--only rate,shape,v4,fixed,v3,intdot,anatomy,prec]

The Hopper counterparts of the TPU measurement probes that bound the
served kernels (``speex_resampler_tpu_torch.probes``), each kernel held
against its plain version first (a mismatch raises):

- ``rate`` (``experiments/mxu_peak.py``): the int8 and bf16 multiply-add
  rate with resident operands at every ``SHAPES`` block (LB 128), at the
  served wgmma N-tiles 32, 64 and 128 of the flagship block with one and
  two CTAs an SM, and plain torch GEMM chains in float32 (TF32 off) and
  bf16; -> ``mxu_peaks.json``;
- ``shape`` (``experiments/mxu_shape_probe.py``): every ``CASES`` entry
  -> ``mxu_shape_probe.json``;
- ``v4`` (``experiments/v4_overhead_anatomy.py``): µs per [128, 512] .
  [512, 1024] block of mxu_only, extract_i32+2 and full at N = 32 and 64,
  beside K2b's own µs per [R, 1024] block at the 48 kHz -> 44.1 kHz q10
  launch -> ``v4_overhead_anatomy.json``;
- ``fixed`` (``experiments/fixed_interp_anatomy.py``): µs per block of the
  four rungs and their deltas, beside K1e's (fixed flagship) and K2d's
  (fixed 48 kHz -> 44.1 kHz q10) µs per [R, 128] block ->
  ``fixed_interp_anatomy.json``;
- ``v3`` (``experiments/v3_overhead_anatomy.py``): ms a flagship launch
  of full, hoist, no_assemble, no_epilogue and dots_only beside the served
  K1b's, hoist's pre-pass alone and its walk, and the ladder (full
  against K1b, each variant against full) -> ``v3_overhead_anatomy.json``;
- ``intdot`` (``experiments/mosaic_int_dot_bench.py``): µs a [512, 264] .
  [264, 128] x 8 body of i8.i8, i16.i16, i16.i8, i32.i32 and bf16.bf16,
  all on the rate kernel (i8.i8 and bf16 are ``rate``'s cases at C 512)
  -> ``mosaic_int_dot_bench.json``;
- ``anatomy`` (``experiments/kernel_anatomy.py``): ms a launch of the f32
  block's full, nodot, noslice and nocvt -> ``kernel_anatomy.json``;
- ``prec`` (``experiments/prec_bench.py``): each precision's max |d| and
  mismatch rate against the float64 gold (kernel and plain version) and
  ms a launch -> ``prec_bench.json``.

Every file carries the card's name and power limit (``nvidia-smi``).  The
served kernels' times come from ``chip_smoke.py``'s launches (B = 2048,
``cuda_ms``); this builds both libraries, in parallel.  About three
minutes on one H100 with the builds and every part.  Exits non-zero
without a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from speex_resampler_tpu_torch.ops import _build  # noqa: E402
from speex_resampler_tpu_torch.parallel import batch as tb  # noqa: E402
from speex_resampler_tpu_torch.probes import (  # noqa: E402
    fixed_interp_anatomy as fa, kernel_anatomy, mosaic_int_dot_bench,
    mxu_peak, mxu_shape_probe, prec_bench, v3_overhead_anatomy,
    v4_overhead_anatomy as v4)

PARTS = ("rate", "shape", "v4", "fixed", "v3", "intdot", "anatomy", "prec")


def served_per_block(path, lanes: int) -> dict:
    """One served kernel's launch at its path's steady geometry (B = 2048,
    ``chip_smoke.cuda_ms``, back to back) and its µs per block of
    ``lanes`` lanes: launch ms / (n_blocks * B / lanes)."""
    bspec = path.geometry()
    step = tb.make_batched_step(path.spec, bspec, device="cuda")
    hist, x = cs.card_inputs(step, bspec.in_per_launch, cs.LANES, seed=7)
    ms = cs.cuda_ms(lambda: cs.launch(hist, x, step), 20)
    n_accum = step.kernel_kw.get("n_accum", 1)
    blocks = bspec.n_blocks * cs.LANES / lanes
    return {"kernel": cs.kernel_name(step.kernel, step.scheme, n_accum),
            "path": path.name, "ms": ms, "R": bspec.R,
            "K_pad": int(step.w[0].shape[-1]), "n_blocks": bspec.n_blocks,
            "B": cs.LANES, "block_lanes": lanes,
            "us_per_block": ms * 1e3 / blocks}


def write(out: Path, name: str, smi: str, results: dict) -> None:
    path = out / name
    path.write_text(json.dumps({
        "card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
        "script": "tools/tc_probes.py", "results": results}, indent=1))
    print(f"wrote {path}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(REPO / "build" / "torch_probes"))
    ap.add_argument("--only", default=",".join(PARTS))
    args = ap.parse_args()
    parts = [p for p in args.only.split(",") if p]
    if not set(parts) <= set(PARTS):
        sys.exit(f"tc_probes: parts must be among {PARTS}")
    if not torch.cuda.is_available():
        sys.exit("tc_probes: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    served = {"v4", "fixed", "v3"} & set(parts)
    errors: list = []
    fir = threading.Thread(target=lambda: _guard(_build.load, errors))
    if served:
        fir.start()
    _build.load_probes()
    print(f"libprobes built: {time.time() - t0:.1f} s")

    if "rate" in parts:
        write(out, "mxu_peaks.json", smi, mxu_peak.run())
    if "shape" in parts:
        write(out, "mxu_shape_probe.json", smi, mxu_shape_probe.run())
    if served:
        fir.join()
        if errors:
            raise errors[0]
        print(f"libfir built: {time.time() - t0:.1f} s")
    if "v4" in parts:
        res = v4.run()
        k2b = served_per_block(cs.SLICE, 1024)
        res["served_K2b"] = k2b
        full = res["full_n32"]["us_per_block"]
        print(f"K2b {k2b['kernel']} at {k2b['path']} on {smi}: "
              f"{k2b['ms']:.4f} ms a launch, R {k2b['R']}, K_pad "
              f"{k2b['K_pad']}, {k2b['n_blocks']} blocks: "
              f"{k2b['us_per_block']:.3f} us per [R, 1024] block; probe "
              f"full (R 128, K 512, N 32) {full:.3f} us")
        write(out, "v4_overhead_anatomy.json", smi, res)
    if "fixed" in parts:
        res = fa.run()
        for key, path in (("served_K1e", cs.FIXED_FLAGSHIP),
                          ("served_K2d", cs.FIXED_SLICE)):
            k = served_per_block(path, 128)
            res[key] = k
            print(f"{key[7:]} {k['kernel']} at {k['path']} on {smi}: "
                  f"{k['ms']:.4f} ms a launch, R {k['R']}, K_pad "
                  f"{k['K_pad']}, {k['n_blocks']} blocks: "
                  f"{k['us_per_block']:.3f} us per [R, 128] block; probe "
                  f"full {res['full']['us_per_block']:.3f} us")
        write(out, "fixed_interp_anatomy.json", smi, res)
    for part, module, name in (
            ("v3", v3_overhead_anatomy, "v3_overhead_anatomy.json"),
            ("intdot", mosaic_int_dot_bench, "mosaic_int_dot_bench.json"),
            ("anatomy", kernel_anatomy, "kernel_anatomy.json"),
            ("prec", prec_bench, "prec_bench.json")):
        if part in parts:
            write(out, name, smi, module.run())
    print(f"tc_probes {parts}: {time.time() - t0:.1f} s")


def _guard(fn, errors: list) -> None:
    try:
        fn()
    except Exception as e:  # re-raised by the main thread
        errors.append(e)


if __name__ == "__main__":
    main()
