"""What an exact integer dot costs by operand width (probe P7).

Counterpart of ``experiments/mosaic_int_dot_bench.py`` (``make_fn`` :31,
``pallas_call`` :44): at the fixed interpolated block shape, W [C, K] =
[512, 264] and x [8, K, LB] with LB = 128, cast to a form's operand types
(``w.astype(wdt)``, ``x.astype(xdt)``: integer casts wrap), a grid step
writes ``out[i % 16] = sum_r W . x[r]``: int32 sums exact mod 2^32 for the
integer forms, f32 sums cast to int32 for bf16.  :func:`int_dot` returns
the function, int32 [16, C, LB]: for CUDA tensors the rate kernel of
:mod:`.tc_rate` (``csrc/probes/tc_rate.cu``; for the wider integer forms
each operand's bytes as int8 digit planes, the ``a + b < 4`` digit products
on the int8 tensor cores; i8.i8 and bf16 are P3's int8 and bf16 cases),
for CPU tensors the plain version :func:`int_dot_reference`.  :func:`measure` times a form as the rate
kernel is timed: every SM busy, operands resident, the slope between two
iteration counts.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ops import _build
from ..ops.tiled_fir import full_perm, wrap_int32
from . import tc_rate as tr

__all__ = ["C", "K", "LB", "N_REPS", "FORMS", "BYTES", "N_TILE",
           "products", "inputs", "cast", "dot_mod32", "int_dot_reference",
           "pack", "plan", "int_dot_launch", "int_dot", "library_call",
           "measure", "run"]

C, K, LB = 512, 264, 128
N_REPS = tr.N_REPS
SLOTS = tr.SLOTS
LANES = tr.LANES
#: form -> (W's type, x's type), the experiment's order
FORMS = {"i8i8": (torch.int8, torch.int8),
         "i16i16": (torch.int16, torch.int16),
         "i16i8": (torch.int16, torch.int8),
         "i32i32": (torch.int32, torch.int32),
         "bf16bf16": (torch.bfloat16, torch.bfloat16)}
#: bytes of W and of x in an integer form's digit planes
BYTES = {torch.int8: 1, torch.int16: 2, torch.int32: 4}
#: an integer form's N-tile: the widest whose accumulators fit beside the
#: fragments (i8.i8: P3's int8 case at its widest)
N_TILE = {"i8i8": 256, "i16i8": 128, "i16i16": 128, "i32i32": 64}


def products(form: str) -> int:
    """int8 tensor-core products a multiply-add of an integer form takes:
    the byte pairs (a, b) with a + b < 4 (the rest vanish mod 2^32)."""
    na, nb = (BYTES[t] for t in FORMS[form])
    return sum(a + b < 4 for a in range(na) for b in range(nb))


def inputs(C: int = C, K: int = K, LB: int = LB, seed: int = 0,
           device="cpu"):
    """The experiment's operands: W [C, K] and x [8, K, LB], int16 values
    in [-128, 128) from ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    w = rng.integers(-128, 128, size=(C, K)).astype(np.int16)
    x = rng.integers(-128, 128, size=(N_REPS, K, LB)).astype(np.int16)
    return torch.from_numpy(w).to(device), torch.from_numpy(x).to(device)


def cast(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``astype``: integer casts keep the low bytes (two's complement)."""
    if dtype == torch.bfloat16:
        return t.to(torch.bfloat16)
    return t.to(torch.int64).to(dtype) if t.dtype.is_floating_point \
        else t.to(dtype)


def dot_mod32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b mod 2^32 as int64, for int32-valued a [C, K] and b [K, LB]:
    the 16-bit halves' products (each exact below 2^53, the high x high
    term a multiple of 2^32)."""
    a, b = a.to(torch.int64), b.to(torch.int64)
    al, ah = a & 0xFFFF, a >> 16
    bl, bh = b & 0xFFFF, b >> 16
    mm = tr.exact_matmul
    return (mm(al, bl) + ((mm(ah, bl) + mm(al, bh)) << 16)) & 0xFFFFFFFF


def _check(w: torch.Tensor, x: torch.Tensor, form: str) -> None:
    if form not in FORMS:
        raise ValueError(f"form {form!r} not in {tuple(FORMS)}")
    if w.dim() != 2 or x.dim() != 3 or x.shape[0] != N_REPS \
            or x.shape[1] != w.shape[1]:
        raise ValueError(f"w [C, K] and x [{N_REPS}, K, LB]: got "
                         f"{tuple(w.shape)}, {tuple(x.shape)}")
    if w.device != x.device:
        raise ValueError(f"w on {w.device}, x on {x.device}")


def int_dot_reference(w: torch.Tensor, x: torch.Tensor,
                      form: str) -> torch.Tensor:
    """The plain version, int32 [16, C, LB]: the operands cast to the
    form's types, then the body sum_r W . x[r] exactly mod 2^32 (integer
    forms) or as float32 sums of bf16 products with TF32 off, r in order,
    cast to int32 (bf16, the rate kernel's plain version)."""
    _check(w, x, form)
    wdt, xdt = FORMS[form]
    if form == "bf16bf16":
        return tr.rate_reference(w, x, "bf16")
    wq, xq = cast(w, wdt), cast(x, xdt)
    acc = sum(dot_mod32(wq, xq[r]) for r in range(N_REPS))
    return wrap_int32(acc).unsqueeze(0).repeat(SLOTS, 1, 1)


def _planes(t: torch.Tensor, n: int) -> torch.Tensor:
    """An integer tensor's n little-endian bytes as uint8 planes [n, ...]
    (the top byte read as signed by the kernel, the others unsigned)."""
    v = t.to(torch.int64)
    return torch.stack([((v >> (8 * i)) & 255).to(torch.uint8)
                        for i in range(n)])


def pack(w: torch.Tensor, x: torch.Tensor, form: str):
    """(W's planes uint8 [na, C, K_pad], each 32-tap group in K_PERM order;
    x's planes uint8 [nb, 8, K_pad, LB], tap order), K padded with zeros to
    a multiple of 32, on the inputs' device: the bytes of the cast
    operands, no arithmetic."""
    wdt, xdt = FORMS[form]
    Kk = w.shape[1]
    K_pad = tr.pad_k(Kk)
    wp = torch.nn.functional.pad(_planes(cast(w, wdt), BYTES[wdt]),
                                 (0, K_pad - Kk))
    xp = torch.nn.functional.pad(_planes(cast(x, xdt), BYTES[xdt]),
                                 (0, 0, 0, K_pad - Kk))
    perm = torch.from_numpy(full_perm(K_pad)).to(w.device)
    return wp[..., perm].contiguous(), xp.contiguous()


def plan(form: str, C: int, K: int, LB: int) -> tr.Plan:
    """An integer form's tiling on the rate kernel: its N-tile and the
    most x blocks a CTA that fit in shared memory."""
    if form not in N_TILE:
        raise ValueError(f"no integer form {form!r}")
    na, nb = (BYTES[t] for t in FORMS[form])
    return tr.plan("int8", C, K, LB, N_TILE[form], na=na, nb=nb)


def int_dot_launch(w: torch.Tensor, x: torch.Tensor, form: str,
                   fill: bool = True) -> tr.RateLaunch:
    """An integer form's launches on CUDA tensors (:class:`.tc_rate.
    RateLaunch` of its byte planes): ``run(iters)`` launches on the
    current stream."""
    _check(w, x, form)
    p = plan(form, w.shape[0], w.shape[1], x.shape[2])
    return tr.RateLaunch.of_planes(*pack(w, x, form), p, fill)


def int_dot(w: torch.Tensor, x: torch.Tensor, form: str, *,
            iters: int = SLOTS) -> torch.Tensor:
    """The probe's function, int32 [16, C, LB]: for CUDA tensors the rate
    kernel (one launch of ``iters`` >= 16 iterations, one copy of each
    tile), for CPU tensors the plain version."""
    if w.device.type == "cpu" and x.device.type == "cpu":
        return int_dot_reference(w, x, form)
    _check(w, x, form)
    if w.device.type != "cuda":
        raise ValueError(f"no kernel for device {w.device}")
    if iters < SLOTS:
        raise ValueError(f"iters {iters} < {SLOTS} leaves slots unwritten")
    if form == "bf16bf16":
        return tr.tc_rate(w, x, "bf16", iters=iters)
    return int_dot_launch(w, x, form, fill=False).run(iters).clone()


def library_call(w: torch.Tensor, x: torch.Tensor, form: str):
    """The yardstick, as a function, where PyTorch has one: the rate
    probe's ``torch._int_mm`` (i8.i8) or bf16 ``torch.mm`` (bf16); for
    i16.i16 and i16.i8 one float64 ``torch.mm`` of the same body, [W ... W]
    . [x[0]; ...; x[reps - 1]], exact (each product below 2^31, each sum
    below 2^53), whose wrap to int32 is the body; None for i32.i32 (its
    products reach 2^62: float64 is not exact, and PyTorch has no int64
    matmul on CUDA).  The port never calls it."""
    if form == "i8i8":
        return tr.library_call(w, x, "int8")
    if form == "bf16bf16":
        return tr.library_call(w, x, "bf16")
    if form in ("i16i16", "i16i8"):
        wdt, xdt = FORMS[form]
        K, reps = w.shape[1], x.shape[0]
        a = cast(w, wdt).double().repeat(1, reps).contiguous()
        b = cast(x, xdt).double().reshape(reps * K, -1).contiguous()
        return lambda: torch.mm(a, b)
    return None


def measure(form: str, seed: int = 0, target_ms: float = 20.0) -> dict:
    """One form on the card: held against the plain version (a mismatch
    raises), then µs a body from the slope with every SM busy, and T
    multiply-adds a second (the form's own and, times its int8 products,
    the tensor cores')."""
    t0 = time.perf_counter()
    w, x = inputs(device="cuda", seed=seed)
    want = int_dot_reference(w, x, form)
    if form == "bf16bf16":
        launch = tr.RateLaunch(w, x, "bf16")
        n_prod, peak = 1, tr.DATASHEET_MACS["bf16"]
    else:
        launch = int_dot_launch(w, x, form)
        n_prod, peak = products(form), tr.DATASHEET_MACS["int8"]
    per_iter = launch.bodies_per_iter
    got = launch.run(SLOTS).clone()
    mism = int((got != want).sum())
    if mism:
        raise AssertionError(f"int_dot {form}: {mism} mismatches")
    macs = N_REPS * C * K * LB
    s = tr.slope_ms(launch.run, per_iter * macs * n_prod, peak, target_ms)
    us = s["slope_ms"] * 1e3 / per_iter
    return {"form": form, "kernel": launch.plan.kernel, "products": n_prod,
            "n_ctas": launch.n_ctas, "rs": launch.plan.rs,
            "mismatches": mism, **s, "us_per_body": us,
            "tmacs": macs / (us * 1e-6) / 1e12,
            "tmacs_int8": n_prod * macs / (us * 1e-6) / 1e12,
            "seconds": time.perf_counter() - t0}


def run(log=print) -> dict:
    """Every form, as the experiment prints them: µs a grid step (body)
    and T multiply-adds a second."""
    out = {}
    for form in FORMS:
        r = measure(form)
        out[form] = r
        log(f"{form:10s} {r['us_per_body']:8.3f} us/step   "
            f"{r['tmacs']:7.1f} T MAC/s ({r['products']} int8 products, "
            f"{r['tmacs_int8']:7.1f} T int8 MAC/s)")
    return out
