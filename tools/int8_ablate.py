"""Variants of the streamed int8 tensor-core kernel (K2b,
``streamed_fir_int8_kernel``), timed and checked on one GPU.

    python3 tools/int8_ablate.py [--parent CSRC_DIR] [--only NAME ...]

Builds the port's kernel library once per variant of
``speex_resampler_tpu_torch/csrc/int8_wgmma.cuh`` (a copy of ``csrc/``
with the variant's text edits under ``build/int8_variants/<name>/``,
``tools/_variants.py``), then for each variant and each streamed int8
launch (48 kHz -> 44.1 kHz q10: "auto", D = 4, and explicit "int8", D =
3; B = 2048) prints the kernel's time, launches queued back to back and
replayed from a CUDA graph (``chip_smoke.cuda_ms``), its share of the
bound, and the mismatch count against the plain version at f0 = 0 and
after a flush (f0 = 40), B = 2048, 130, 129 (2-byte x loads) and 64, with
x = -32768 and 32767 rows in every launch.  The variants:

- ``as built``: one walk of the band for all D digits, 32 rows a
  warpgroup (2*D x 16 accumulator registers), 64-lane CTAs, copies 3
  stages ahead (a ring of 5);
- ``lead 2``: = as built, copies 2 stages ahead (a ring of 4).

The header has one code path.  The designs that lost to it (a walk of the
band a digit, with 64 or 32 rows a warpgroup) were measured by an earlier
version of this tool; PERF.md section 6 keeps their times.

With ``--parent``, a ``csrc/`` directory of an earlier checkout is built
too; its int8 entry point (the CUDA-core kernel, planes int8[D, P, K, R]
in tap order) is timed at the same launches and every variant is held
against it: both take exact integer sums and the same f32 epilogue, so 0
outputs may differ.

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

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from speex_resampler_tpu_torch.ops import _build  # noqa: E402
from speex_resampler_tpu_torch.ops import filter_design as fd  # noqa: E402
from speex_resampler_tpu_torch.ops import streamed_fir as sf  # noqa: E402
from speex_resampler_tpu_torch.parallel import batch as tb  # noqa: E402
from tools import _variants  # noqa: E402

HEADER = "int8_wgmma.cuh"
#: name -> (edits of the header, computes the function)
VARIANTS = {
    "as built": ({}, True),
    "lead 2": ({"kLead = 3;": "kLead = 2;"}, True),
}
#: (in, out, quality, target frames, scheme)
LAUNCHES = [(48000, 44100, 10, 20480, "auto"),
            (48000, 44100, 10, 20480, "int8")]
CHECK_LANES = (cs.LANES, 130, 129, 64)


def _int8(kernel: str) -> bool:
    return "int8" in kernel and "streamed" in kernel


def edge_inputs(step, n_in: int, B: int, seed: int):
    """Random launch inputs (``chip_smoke.card_inputs``) with one chunk
    row of -32768 and one of 32767 in every block's window."""
    hist, x = cs.card_inputs(step, n_in, B, seed)
    x[0:n_in:97] = -32768
    x[1:n_in:89] = 32767
    return hist, x


def parent_library(csrc: Path):
    """The library of another checkout's ``csrc/``, with the argument
    types of its streamed int8 entry point (unchanged since)."""
    out = ROOT / "build" / "int8_variants" / "parent" / "libfir.so"
    shutil.rmtree(out.parent, ignore_errors=True)
    _build.use_csrc(csrc)
    _build.compile_library(out)
    lib = _build.declare(ctypes.CDLL(str(out)), ("streamed_fir_int8",))
    print(f"parent {csrc}: " + _variants.ptxas(out.parent, _int8))
    return lib


def parent_launch(lib, hist, x, step):
    """The CUDA-core kernel on one launch (planes back in tap order,
    [D, P, K, R]): a function that launches it on the current stream, and
    its output."""
    planes = sf.int8_n_major(step.w[0])
    bias, taps = step.w[1], step.w[2]
    D, P, K, R = planes.shape
    kw = step.kernel_kw
    s = tuple(kw["scales"]) + (0.0,) * (4 - D)
    H, B = hist.shape
    y = torch.empty((kw["n_blocks"] * R, B), dtype=torch.int16,
                    device="cuda")

    def run():
        if lib.streamed_fir_int8(
                hist.data_ptr(), x.data_ptr(), y.data_ptr(), taps.data_ptr(),
                planes.data_ptr(), bias.data_ptr(), D, *s, H, x.shape[0], B,
                R, K, P, kw["n_blocks"], kw["shift"], kw["num"], kw["den"],
                kw["f0"], torch.cuda.current_stream().cuda_stream):
            raise RuntimeError("parent kernel launch failed")
    return run, y


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--only", nargs="*", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("int8_ablate: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    cases = []
    for i, o, q, target, scheme in LAUNCHES:
        g = math.gcd(i, o)
        spec = fd.design_filter(i // g, o // g, q)
        for f0 in (0, 40):
            bspec = tb._launch_geometry(spec, target, f0=f0)
            step = tb.make_batched_step(spec, bspec, device="cuda",
                                        scheme=scheme)
            assert (step.kernel, step.scheme) == ("streamed", "int8")
            inputs = [edge_inputs(step, bspec.in_per_launch, B, seed=B + f0)
                      for B in CHECK_LANES]
            want = [cs.plain(h, x, step).cpu().numpy() for h, x in inputs]
            bound = cs.launch_bound(spec, step, bspec, cs.LANES)
            cases.append((f"{i}->{o} q{q} {scheme} D={step.w[0].shape[0]} "
                          f"f0 {f0}", step, inputs, want, bound))
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
            print(f"   parent, {label}: {cs.cuda_ms(run, 20):.4f} ms back "
                  f"to back, graph {cs.cuda_ms(run, 20, mode='graph'):.4f} "
                  f"ms at B = {cs.LANES}")
    for name, (edits, exact) in VARIANTS.items():
        if args.only and name not in args.only:
            continue
        print(f"== {name}: " + _variants.build("int8_variants", name, HEADER,
                                               edits, _int8))
        for c, (label, step, inputs, want, bound) in enumerate(cases):
            line = []
            for b, ((h, x), w) in enumerate(zip(inputs, want)):
                if not exact:
                    break
                got = cs.launch(h, x, step).cpu().numpy()
                line.append(f"B={h.shape[1]} mismatches "
                            f"{int((got != w).sum())}")
                if parent is not None:
                    line[-1] += (f", vs parent "
                                 f"{int((got != parent[c][b]).sum())} differ")
            h, x = inputs[0]
            fn = lambda: cs.launch(h, x, step)  # noqa: E731
            ms, graph_ms = cs.cuda_ms(fn, 20), cs.cuda_ms(fn, 20, mode="graph")
            line.append(f"{ms:.4f} ms back to back, graph {graph_ms:.4f} ms,"
                        f" {bound[0] / ms:.3f} of the bound {bound[0]:.4f} ms")
            print(f"   {name}, {label}: " + "; ".join(line))


if __name__ == "__main__":
    main()
