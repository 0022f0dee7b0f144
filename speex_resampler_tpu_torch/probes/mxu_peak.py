"""Sustained tensor-core rates at the serving kernels' block shapes (P3).

Counterpart of ``experiments/mxu_peak.py``: its ``SHAPES`` (the [C, K]
blocks the TPU's serving kernels contract) at LB = 128 lanes, int8 and bf16
through the resident-operand kernel (:mod:`.tc_rate`), plus the wgmma
shapes the served Hopper kernels issue (:data:`SERVED`: N = 32 and 64 at
K = 288, M = 64 lanes: K1b, K2b, K1e and K2d's m64n32k32 / m64n64k32); and
``measure_xla_gemm``'s rates, which on the TPU priced the XLA GEMM of the
dense family, as plain torch matmuls (a chain of dependent [2048, 512] .
[512, 512] products, float32 with TF32 off and bf16, in a CUDA graph).  ``tools/tc_probes.py``
writes the results to ``build/torch_probes/mxu_peaks.json``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import tc_rate as tr
from ..ops.tiled_fir import _no_tf32

__all__ = ["SHAPES", "SERVED", "LB", "measure", "measure_xla_gemm", "run"]

LB = 128
#: [C, K] blocks of the TPU's serving kernels (experiments/mxu_peak.py:52):
#: tiled flagship, fixed interpolate, short filter, long filter (q10
#: streamed), widened short span, decimate tiled
SHAPES = [(128, 264), (512, 264), (128, 136), (256, 520),
          (256, 208), (128, 400)]
#: the wgmma N-tiles of the served Hopper kernels at the flagship block (K
#: 264 -> 288), with one and with two warpgroups (CTAs) an SM, as the
#: served kernels run two: (C, K, N, CTAs an SM)
SERVED = [(128, 264, n, per_sm) for n in (32, 64, 128) for per_sm in (1, 2)]


def measure(dtype: str, C: int, K: int, n: int | None = None,
            seed: int = 0, per_sm: int = 1) -> dict:
    """One block shape at LB = 128 lanes (:func:`tc_rate.measure`)."""
    return tr.measure(dtype, C, K, LB, n=n, seed=seed, per_sm=per_sm)


def measure_xla_gemm(dtype: str, M: int = 2048, K: int = 512,
                     N: int = 512, seed: int = 0) -> dict:
    """Sustained multiply-adds a second of a chain of dependent
    ``torch.matmul`` products y = (y @ w)[:, :K] ([M, K] . [K, N], K == N),
    float32 with TF32 off ("f32") or bf16 (plain torch; the TPU probe's
    ``measure_xla_gemm``, which chained them in one ``lax.scan``).  Each
    chain length is captured in one CUDA graph, so the device's time is
    read without the host's launches; the rate is the slope between two
    lengths."""
    t = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    rng = np.random.default_rng(seed)
    x0 = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)
                          * 0.1).to("cuda", t)
    w = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32)
                         * 0.1).to("cuda", t)
    lengths = (16, 128)
    graphs = []
    with _no_tf32():
        for n in lengths:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                torch.matmul(x0, w)          # the library's warm-up
            torch.cuda.current_stream().wait_stream(side)
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                y = x0
                for _ in range(n):
                    y = torch.matmul(y, w)[:, :K]
            graphs.append(g)
    ms = [tr.events_ms(g.replay) for g in graphs]
    slope = (ms[1] - ms[0]) / (lengths[1] - lengths[0])
    return {"dtype": dtype, "M": M, "K": K, "N": N, "lengths": lengths,
            "ms": ms, "slope_ms": slope,
            "tmacs": M * K * N / (slope * 1e-3) / 1e12}


def run(log=print) -> dict:
    """Every SHAPES entry and SERVED tile, int8 and bf16, and the plain
    GEMM chains; the peak of each type is its best case."""
    out = {"shapes": {}, "served": {}, "peak_tmacs": {}, "xla_gemm": {}}
    for dtype in tr.DTYPES:
        best = 0.0
        for C, K in SHAPES:
            r = measure(dtype, C, K)
            out["shapes"][f"{dtype}_{C}x{K}"] = r
            best = max(best, r["tmacs_needed"])
            log(_line(r))
        for C, K, n, per_sm in SERVED:
            r = measure(dtype, C, K, n=n, per_sm=per_sm)
            out["served"][f"{dtype}_{C}x{K}_n{n}_sm{per_sm}"] = r
            log(_line(r))
        out["peak_tmacs"][dtype] = best
    for dtype in ("f32", "bf16"):
        r = measure_xla_gemm(dtype)
        out["xla_gemm"][dtype] = r
        log(f"torch.matmul chain {dtype:5s} [2048, 512] . [512, 512]  "
            f"{r['tmacs']:7.2f} T MAC/s")
    return out


def _line(r: dict) -> str:
    lib = r["library"]
    lib_s = (f"library {lib['tmacs']:7.2f} T MAC/s ({lib['ms']:.4f} ms)"
             if "tmacs" in lib else f"library: {lib.get('error')}")
    return (f"{r['dtype']:5s} [{r['C']:4d},{r['K']:4d}] x LB={r['LB']:4d} "
            f"N={r['n']:3d} rs={r['rs']} ctas={r['n_ctas']} "
            f"(aim {r['per_sm']}/SM)  "
            f"{r['tmacs_needed']:7.2f} T MAC/s needed, "
            f"{r['tmacs_walked']:7.2f} walked (K_pad {r['K_pad']}), "
            f"{r['share_of_datasheet']:.3f} of the datasheet; {lib_s}")
