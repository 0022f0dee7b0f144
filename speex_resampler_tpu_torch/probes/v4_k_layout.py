"""What the contraction depth and the weights' layout cost (probe P10).

Counterpart of ``experiments/v4_k_layout.py`` (``make_fn`` :34, its
``pallas_call`` :51): at the streamed block shape, W int8 [R, K] ("rk")
or [K, R] ("kr"), R = 128, and x int8 [16, K, LB], LB = 1024, a grid step
i writes

    out[i % 16] = sum_{r < 16} W . x[r]      ("kr": W^T . x[r])

int32 sums, for K in 512, 448 and 440 (q10's 440, padded to 512 on the
TPU).  :func:`k_layout` returns the function, int32 [16, R, LB]: for CUDA
tensors the rate kernel of :mod:`.tc_rate` with 16 x blocks
(``csrc/probes/tc_rate.cu``; a "kr" W is transposed into the kernel's
K-major, K_PERM-ordered tile while it is staged, since 8-bit wgmma reads
its shared-memory operand only K-major; K = 440 runs as 448, the 32-byte
K-slice's multiple, with zero weights), for CPU tensors the plain version
:func:`k_layout_reference`.  :func:`measure` times a case as the TPU
probe does: the slope between two iteration counts (the per-step rate)
and, for the staging a launch does once, the intercept.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import tc_rate as tr

__all__ = ["R", "LB", "N_REPS", "KS", "FORMS", "G", "operands",
           "k_layout_reference", "k_layout_launch", "k_layout",
           "library_call", "measure", "run"]

R, LB = 128, 1024
N_REPS = 16
KS = (512, 448, 440)
FORMS = ("rk", "kr")
#: the TPU probe's two grid lengths (steps a launch)
G = (512, 8192)


def operands(K: int, form: str, seed: int = 0, device="cpu", *,
             R: int = R, LB: int = LB, reps: int = N_REPS):
    """The experiment's operands from one ``np.random.default_rng(seed)``:
    W [R, K] ("rk") or [K, R] ("kr"), then x [reps, K, LB], int8 values in
    [-128, 128) (as int16 tensors, the rate kernel's inputs)."""
    rng = np.random.default_rng(seed)
    w = rng.integers(-128, 128, size=(R, K) if form == "rk" else (K, R))
    x = rng.integers(-128, 128, size=(reps, K, LB))
    return (torch.from_numpy(w.astype(np.int16)).to(device),
            torch.from_numpy(x.astype(np.int16)).to(device))


def _kr(form: str) -> bool:
    if form not in FORMS:
        raise ValueError(f"form {form!r} not in {FORMS}")
    return form == "kr"


def k_layout_reference(w: torch.Tensor, x: torch.Tensor,
                       form: str) -> torch.Tensor:
    """The plain version: int32 [16, R, LB], the body in every slot, exact
    (mod 2^32): :func:`.tc_rate.rate_reference`, W transposed for "kr"."""
    return tr.rate_reference(w, x, "int8", _kr(form))


def k_layout_launch(w: torch.Tensor, x: torch.Tensor, form: str,
                    fill: bool = True) -> tr.RateLaunch:
    """A case's launches on CUDA tensors (:class:`.tc_rate.RateLaunch`
    with x's 16 blocks and, for "kr", the [K, R] W): ``run(iters)``
    launches on the current stream."""
    return tr.RateLaunch(w, x, "int8", fill=fill, kr=_kr(form))


def k_layout(w: torch.Tensor, x: torch.Tensor, form: str, *,
             iters: int = tr.SLOTS) -> torch.Tensor:
    """The probe's function, int32 [16, R, LB]: the rate kernel for CUDA
    tensors (one launch of ``iters`` >= 16 iterations, one copy of each
    tile), the plain version for CPU tensors."""
    return tr.tc_rate(w, x, "int8", iters=iters, kr=_kr(form))


def library_call(w: torch.Tensor, x: torch.Tensor, form: str):
    """The yardstick, as a function: the rate probe's ``torch._int_mm`` of
    one body (W, as [R, K], repeated 16 times along K against the 16 x
    blocks stacked).  The port never calls it."""
    return tr.library_call(w.t() if _kr(form) else w, x, "int8")


def measure(K: int, form: str, seed: int = 0,
            iters: tuple = G) -> dict:
    """One (K, form) on the card: held against the plain version (a
    mismatch raises), then the launch time at the two iteration counts
    (median of 5, every SM busy), the slope (µs a body, T multiply-adds a
    second over the true K) and the intercept (the launch's fixed cost:
    its staging, "kr"'s transpose included)."""
    t0 = time.perf_counter()
    w, x = operands(K, form, seed, device="cuda")
    rl = k_layout_launch(w, x, form)
    got = rl.run(tr.SLOTS).clone()
    mism = int((got != k_layout_reference(w, x, form)).sum())
    if mism:
        raise AssertionError(f"k_layout K {K} {form}: {mism} mismatches")
    it1, it2 = iters
    ms1 = tr.events_ms(lambda: rl.run(it1))
    ms2 = tr.events_ms(lambda: rl.run(it2))
    slope = (ms2 - ms1) / (it2 - it1)              # ms an iteration
    per_iter = rl.bodies_per_iter
    macs = N_REPS * R * K * LB
    us = slope * 1e3 / per_iter
    return {"K": K, "form": form, "K_pad": rl.plan.K_pad, "n": rl.plan.n,
            "rs": rl.plan.rs, "n_ctas": rl.n_ctas, "mismatches": mism,
            "it1": it1, "it2": it2, "ms1": ms1, "ms2": ms2,
            "us_per_body": us, "intercept_ms": ms1 - it1 * slope,
            "tmacs": macs / (us * 1e-6) / 1e12,
            "bound_us": macs / tr.DATASHEET_MACS["int8"] * 1e6,
            "seconds": time.perf_counter() - t0}


def run(log=print) -> dict:
    """Every (K, form), as the experiment prints them: µs a step (body)
    and T multiply-adds a second, beside the intercept and the bound."""
    out = {}
    for K in KS:
        for form in FORMS:
            r = measure(K, form)
            out[f"K{K}_{form}"] = r
            log(f"K={K} {form}   {r['us_per_body']:8.3f} us/step   "
                f"{r['tmacs']:7.1f} T MAC/s (bound {r['bound_us']:.3f} us; "
                f"intercept {r['intercept_ms']:.4f} ms)")
    return out
