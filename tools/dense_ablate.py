"""Variants of the dense kernel (K3, ``dense_fir_f32_kernel``), timed and
checked on one GPU.

    python3 tools/dense_ablate.py [--parent CSRC_DIR] [--only NAME ...]

The dense kernel runs the "highest" product of
``speex_resampler_tpu_torch/csrc/f32_fir.cuh``.  For each variant of that
header (a copy of ``csrc/`` with the variant's text edits under
``build/dense_variants/<name>/``, ``tools/_variants.py``) and each dense
launch of ``tests/test_torch_gpu.py``'s ``DENSE`` list (the voip 20 ms
shapes, R 160, 96 and 129; R 32; a 32 MB weight matrix, R 2000), it prints
the kernel's time at B = 2048, launches queued back to back and replayed
from a CUDA graph (``chip_smoke.cuda_ms``), and, for the variants that
compute the function, the max |err| and mismatch count against the plain
version at f0 = 0 and 1, B = 2048, 130, 129 and 64.  At the voip launch
it also times the library matmul both ways, and the host time of one
``resample_dense`` call, of the same call before its per-call trim and of
its stream lookup.  A dense launch's CTAs walk
~7 stages each, so the variants cut the pipeline's fill:

- ``as built``: the sources as they stand (16-tap stages, 8 x 4 thread
  tiles, 64-lane CTAs of 128 threads; 576 CTAs at voip);
- ``128-lane CTAs``: the tiled and streamed kernels' CTAs, 8 x 8 thread
  tiles (288 CTAs at voip);
- ``128-lane CTAs, 8-tap stages``: = 128-lane CTAs with 8-tap stages
  (64-lane CTAs of 128 threads cannot split 8-tap stages' copies evenly);
- ``min 3 CTAs``: = as built, registers capped for 3 CTAs an SM.

With ``--parent``, a ``csrc/`` directory of an earlier checkout is built
too; its dense entry point (unpadded weights and its own 64-row tap table)
is timed the same two ways at every launch, and every variant is held
against it bit for bit: each output is one FMA chain from 0 in tap order
in both, so 0 outputs may differ.

Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from speex_resampler_tpu_torch.ops import _build  # noqa: E402
from speex_resampler_tpu_torch.ops import dense_fir as df  # noqa: E402
from speex_resampler_tpu_torch.ops import filter_design as fd  # noqa: E402
from speex_resampler_tpu_torch.ops import tiled_fir as tf  # noqa: E402
from speex_resampler_tpu_torch.parallel import batch as tb  # noqa: E402
from tools import _variants  # noqa: E402

HEADER = "f32_fir.cuh"
LANES128 = {"dense_fir.cu": {
    "constexpr int kLanes = 64;": "constexpr int kLanes = 128;",
    "constexpr int kTN = 4;": "constexpr int kTN = 8;"}}
#: name -> (edits of the header, edits of other sources, computes the
#: function)
VARIANTS = {
    "as built": ({}, {}, True),
    "128-lane CTAs": ({}, LANES128, True),
    "128-lane CTAs, 8-tap stages": ({"kStageTaps = 16;": "kStageTaps = 8;"},
                                    LANES128, True),
    "min 3 CTAs": ({"kMinBlocks = 2;": "kMinBlocks = 3;"}, {}, True),
}
#: (in, out, quality, max_in_frames): tests/test_torch_gpu.py DENSE
LAUNCHES = [(44100, 48000, 3, 882), (48000, 16000, 3, 960),
            (16000, 48000, 3, 320), (48000, 16000, 3, 96),
            (19990, 20000, 10, 2998)]
CHECK_LANES = (cs.LANES, 130, 129, 64)
_P, _I = ctypes.c_void_p, ctypes.c_int


def _dense(kernel: str) -> bool:
    return "dense" in kernel


def parent_library(csrc: Path):
    """The library of another checkout's ``csrc/``, with the argument
    types of its dense entry point (weights [L_pad, R], no R_pad)."""
    out = ROOT / "build" / "dense_variants" / "parent" / "libfir.so"
    shutil.rmtree(out.parent, ignore_errors=True)
    _build.use_csrc(csrc)
    _build.compile_library(out)
    lib = ctypes.CDLL(str(out))
    lib.dense_fir_f32.restype = _I
    lib.dense_fir_f32.argtypes = [_P] * 5 + [_I] * 7 + [_P]
    print(f"parent {csrc}: " + _variants.ptxas(out.parent, _dense))
    return lib


def parent_launch(lib, hist, x, step):
    """The earlier kernel on one launch (its own 64-row tap table over the
    unpadded weights): a function that launches it on the current stream
    without synchronising, and its output."""
    R, kw = step.kernel_kw["R"], step.kernel_kw
    w = step.w[0][:, :R].contiguous()
    L = w.shape[0]
    nonzero = np.zeros((1, L, -(-R // tf.ROW_TILE) * tf.ROW_TILE), bool)
    nonzero[0, :, :R] = (w != 0).cpu().numpy()
    taps = torch.from_numpy(tf.tap_ranges(nonzero)).cuda()
    H, B = hist.shape
    y = torch.empty((kw["n_blocks"] * R, B), dtype=torch.int16,
                    device="cuda")

    def run():
        if lib.dense_fir_f32(hist.data_ptr(), x.data_ptr(), y.data_ptr(),
                             taps.data_ptr(), w.data_ptr(), H, x.shape[0], B,
                             R, L, kw["stride"], kw["n_blocks"],
                             torch.cuda.current_stream().cuda_stream):
            raise RuntimeError("parent kernel launch failed")
    return run, y


def untrimmed(hist, x, w, *, stride, n_blocks, R):
    """``resample_dense`` as it was before its per-call trim: the same
    checks and launch, but the library's tile sizes queried on every call
    and the stream read through a ``torch.cuda.Stream``."""
    L, R_pad = df._check(hist, x, w, stride, n_blocks, R)
    lib = _build.load()
    if lib.dense_fir_row_tile() != tf.ROW_TILE \
            or lib.f32_fir_sub_rows() != tf.SUB_ROWS:
        raise RuntimeError("tile sizes disagree")
    H, B = hist.shape
    y = torch.empty((n_blocks * R, B), dtype=torch.int16, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dense_fir_f32(hist.data_ptr(), x.data_ptr(), y.data_ptr(),
                                w[1].data_ptr(), w[0].data_ptr(), H,
                                x.shape[0], B, R_pad, L, stride, n_blocks, R,
                                stream)
    if err:
        raise RuntimeError("dense FIR kernel launch failed")
    return y


def host_cost(step, hist, x, n: int = 3000) -> None:
    """Host time of one ``resample_dense`` call, of the call before its
    trim (:func:`untrimmed`) and of the two stream lookups, by the host
    clock over ``n`` calls each (the launches queue on the card), in one
    process, so the trim's share is read within one run."""
    def per_call(fn):
        for _ in range(200):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
        return t
    kw = step.kernel_kw
    assert torch.equal(df.resample_dense(hist, x, step.w, **kw),
                       untrimmed(hist, x, step.w, **kw))
    rounds = [(per_call(lambda: df.resample_dense(hist, x, step.w, **kw)),
               per_call(lambda: untrimmed(hist, x, step.w, **kw)))
              for _ in range(3)]
    raw = per_call(lambda: _build.stream_handle(x.device))
    obj = per_call(lambda: torch.cuda.current_stream().cuda_stream)
    print("   host time a call: resample_dense "
          + " / ".join(f"{a:.2f}" for a, _ in rounds)
          + " us; before its trim "
          + " / ".join(f"{b:.2f}" for _, b in rounds)
          + f" us (3 rounds, alternating); its stream handle {raw:.2f} us "
          f"(torch.cuda.current_stream().cuda_stream {obj:.2f} us)")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--only", nargs="*", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("dense_ablate: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    cases = []
    for i, o, q, cap in LAUNCHES:
        g = math.gcd(i, o)
        spec = fd.design_filter(i // g, o // g, q)
        for f0 in sorted({0, 1 % spec.den}):
            bspec = tb._launch_geometry(spec, 4096, f0=f0, max_in_frames=cap)
            step = tb.make_batched_step(spec, bspec, device="cuda")
            assert step.kernel == "dense", step.kernel
            inputs = [cs.card_inputs(step, bspec.in_per_launch, B,
                                     seed=B + f0) for B in CHECK_LANES]
            want = [cs.plain(h, x, step).cpu().numpy() for h, x in inputs]
            bound = cs.launch_bound(spec, step, bspec, cs.LANES)
            cases.append((f"{i}->{o} q{q} cap {cap} f0 {f0} R "
                          f"{step.kernel_kw['R']}", step, bspec, inputs,
                          want, bound))
    voip = cases[0]
    lib_fn = cs.library_call(voip[1], voip[2], *voip[3][0], 20)
    print(f"   library matmul, {voip[0]}: {cs.cuda_ms(lib_fn, 20):.4f} ms "
          f"back to back, graph {cs.cuda_ms(lib_fn, 20, mode='graph'):.4f}"
          f" ms")
    host_cost(voip[1], *voip[3][0])
    parent = None
    if args.parent is not None:
        lib = parent_library(args.parent)
        parent = []
        for label, step, _, inputs, _, _ in cases:
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
    for name, (edits, also, exact) in VARIANTS.items():
        if args.only and name not in args.only:
            continue
        print(f"== {name}: " + _variants.build("dense_variants", name, HEADER,
                                               edits, _dense, also))
        for c, (label, step, _, inputs, want, bound) in enumerate(cases):
            line = []
            for b, ((h, x), w) in enumerate(zip(inputs, want)):
                if not exact:
                    break
                got = cs.launch(h, x, step).cpu().numpy()
                d = np.abs(got.astype(np.int32) - w.astype(np.int32))
                line.append(f"B={h.shape[1]} max|err|={d.max()} "
                            f"mismatches {int((d > 0).sum())}")
                if parent is not None:
                    line[-1] += (f", vs parent "
                                 f"{int((got != parent[c][b]).sum())} differ")
            h, x = inputs[0]
            fn = lambda: cs.launch(h, x, step)  # noqa: E731
            ms, graph_ms = cs.cuda_ms(fn, 20), cs.cuda_ms(fn, 20, mode="graph")
            line.append(f"{ms:.4f} ms back to back, graph {graph_ms:.4f} ms,"
                        f" bound {bound[0]:.4f} ms ({bound[0] / graph_ms:.3f}"
                        f" of it)")
            print(f"   {name}, {label}: " + "; ".join(line))


if __name__ == "__main__":
    main()
