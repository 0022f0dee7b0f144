"""The fixed interpolated block as a ladder of rungs (probe P2).

Counterpart of ``experiments/fixed_interp_anatomy.py`` (``run``,
``pallas_call`` :68; bodies ``k_mxu`` :105, ``k_comb`` :124 for both
``+combine`` and ``+extract``, ``k_full`` :140).  At R, K, LB = 128, 264,
128 with C = 4R = 512 accumulator-major plane rows (row c*R + r: column
set c), planes int8 [2, C, K] (wh, wl), bias int32 [C], coef int32 [4, R],
xh int8 [K, LB] and x16 int16 [K, LB], a grid step sums body(r) over r =
0..3 in int16 (wrapping) into slot i % 16 of int16 [16, R, LB].  Each body
salts x's element [0, 0] with +r in x's own type (wrapping):

- ``mxu_only``: xs = xh + salt, xs2 = xs + 1 (int8); acc = wh.xs + wh.xs2
  + wl.xs + wl.xs2; acc[:R] cast to int16
- ``+combine``: ``_dot_fixed(planes, bias, xh as int16 + salt)[:R]`` cast
  to int16
- ``+extract``: the same with x16 + salt
- ``full``: ``_fixed_mix_rows(_dot_fixed(planes, bias, x16 + salt), coef)``

``_dot_fixed`` (JAX ``ops/pallas_fir.py:149``) is 65536*<wh, xh'> +
256*(<wh, xl'> + <wl, xh'>) + <wl, xl'> + bias mod 2^32 with xh' = x >> 8,
xl' = (x & 255) - 128 (:func:`dot_fixed`); ``_fixed_mix_rows`` is
``ops/fixed_math.fixed_interp_mix_rows``.  :func:`ladder` returns a rung's
function: the kernel (``csrc/probes/fixed_anatomy.cu``, K1e's four-pass
tile, operands resident) for CUDA tensors, the plain version
:func:`ladder_reference` for CPU tensors.  :func:`measure` times a rung:
µs per block (4 bodies a grid step, as on the TPU) with every SM busy.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ops import _build
from ..ops.fixed_math import fixed_interp_mix_rows
from ..ops.tiled_fir import full_perm, wrap_int32
from . import tc_rate as tr

__all__ = ["R", "K", "LB", "C", "N_REPS", "RUNGS", "inputs", "rung_input",
           "dot_fixed", "ladder_reference", "pack", "ladder",
           "LadderLaunch", "measure", "run", "launches"]

R, K, LB = 128, 264, 128
C = 4 * R
N_REPS = 4
RUNGS = ("mxu_only", "+combine", "+extract", "full")
_KERNEL_RUNG = {"mxu_only": 0, "+combine": 1, "+extract": 1, "full": 2}
SLOTS = tr.SLOTS
LANES = tr.LANES
ROWS = 32              # a CTA's rows: two warpgroups of 16 x 4 column sets

launches = 0


def inputs(R: int = R, K: int = K, LB: int = LB, seed: int = 0,
           device="cpu"):
    """The TPU probe's arrays from ``np.random.default_rng(seed)``, drawn in
    its order: planes int8 [2, 4R, K], bias int32 [4R], coef int32 [4, R],
    xh int8 [K, LB], x16 int16 [K, LB]."""
    rng = np.random.default_rng(seed)
    planes = rng.integers(-128, 128, (2, 4 * R, K)).astype(np.int8)
    bias = rng.integers(-2 ** 20, 2 ** 20, (4 * R,)).astype(np.int32)
    coef = rng.integers(0, 32768, (4, R)).astype(np.int32)
    xh = rng.integers(-128, 128, (K, LB)).astype(np.int8)
    x16 = rng.integers(-32768, 32768, (K, LB)).astype(np.int16)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (planes, bias, coef, xh, x16))


def rung_input(rung: str, xh: torch.Tensor, x16: torch.Tensor):
    """The x a rung reads: xh (int8) for mxu_only, xh as int16 for
    +combine, x16 for +extract and full."""
    if rung not in RUNGS:
        raise ValueError(f"rung {rung!r} not in {RUNGS}")
    return {"mxu_only": xh, "+combine": xh.to(torch.int16)}.get(rung, x16)


def _wrap(v: torch.Tensor, bits: int) -> torch.Tensor:
    half = 1 << (bits - 1)
    return ((v.to(torch.int64) + half) & ((1 << bits) - 1)) - half


def dot_fixed(planes: torch.Tensor, bias: torch.Tensor,
              x16: torch.Tensor) -> torch.Tensor:
    """``_dot_fixed``: int32 [4R, LB], exact mod 2^32."""
    u = x16.to(torch.int32)
    xh, xl = u >> 8, (u & 255) - 128
    wh, wl = planes[0], planes[1]
    mm = tr.exact_matmul
    acc = (mm(wh, xh) * 65536 + (mm(wh, xl) + mm(wl, xh)) * 256
           + mm(wl, xl) + bias.to(torch.int64)[:, None])
    return wrap_int32(acc)


def _body(rung, planes, bias, coef, x, r):
    R = coef.shape[1]
    xs = x.to(torch.int64).clone()
    bits = 8 if rung == "mxu_only" else 16
    xs[0, 0] = _wrap(xs[0, 0] + r, bits)
    if rung == "mxu_only":
        xs2 = _wrap(xs + 1, 8)
        mm = tr.exact_matmul
        acc = (mm(planes[0], xs) + mm(planes[0], xs2) + mm(planes[1], xs)
               + mm(planes[1], xs2))
        return _wrap(acc[:R], 16)
    acc = dot_fixed(planes, bias, xs)
    if rung == "full":
        return fixed_interp_mix_rows(
            acc.reshape(4, R, -1), coef.to(torch.int32)).to(torch.int64)
    return _wrap(acc[:R], 16)


def ladder_reference(rung: str, planes: torch.Tensor, bias: torch.Tensor,
                     coef: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The plain version, int16 [16, R, LB]: the int16 sum of the rung's
    four salted bodies in every slot (``x`` from :func:`rung_input`)."""
    total = 0
    for r in range(N_REPS):
        total = _wrap(total + _body(rung, planes, bias, coef, x, r), 16)
    return total.to(torch.int16).unsqueeze(0).repeat(SLOTS, 1, 1)


def pack(planes: torch.Tensor, x: torch.Tensor):
    """(planes int8 [2, 4R, K_pad], x [K_pad, LB]) as the kernel reads them:
    K padded with zero taps to a multiple of 32 in both planes and zero x
    rows; each 32-tap group of the planes in K_PERM order."""
    Kk = planes.shape[-1]
    K_pad = tr.pad_k(Kk)
    wp = torch.zeros((*planes.shape[:-1], K_pad), dtype=torch.int8,
                     device=planes.device)
    wp[..., :Kk] = planes
    perm = torch.from_numpy(full_perm(K_pad)).to(planes.device)
    xp = torch.zeros((K_pad, x.shape[1]), dtype=x.dtype, device=x.device)
    xp[:Kk] = x
    return wp[..., perm].contiguous(), xp


def _check(rung, planes, bias, coef, x) -> None:
    if rung not in RUNGS:
        raise ValueError(f"rung {rung!r} not in {RUNGS}")
    Rr = coef.shape[-1]
    want_x = torch.int8 if rung == "mxu_only" else torch.int16
    if planes.dim() != 3 or planes.shape[:2] != (2, 4 * Rr) \
            or planes.dtype != torch.int8 or bias.shape != (4 * Rr,) \
            or bias.dtype != torch.int32 or coef.shape != (4, Rr) \
            or coef.dtype != torch.int32 or x.dim() != 2 \
            or x.shape[0] != planes.shape[2] or x.dtype != want_x:
        raise ValueError(
            f"{rung}: planes int8 [2, 4R, K], bias int32 [4R], coef int32 "
            f"[4, R], x {want_x} [K, LB]; got {tuple(planes.shape)}, "
            f"{tuple(bias.shape)}, {tuple(coef.shape)}, "
            f"{tuple(x.shape)} {x.dtype}")
    if Rr % ROWS or x.shape[1] % LANES:
        raise ValueError(f"R % {ROWS} and LB % {LANES} must be 0")
    if len({t.device for t in (planes, bias, coef, x)}) != 1:
        raise ValueError("planes, bias, coef and x on different devices")


class LadderLaunch:
    """A rung's kernel launches on CUDA tensors (out int16 [16, R, LB], the
    copies' scratch tiles); ``run(iters)`` launches on the current
    stream."""

    def __init__(self, rung: str, planes, bias, coef, x, fill: bool = True):
        _check(rung, planes, bias, coef, x)
        self.rung, self.kr = rung, _KERNEL_RUNG[rung]
        self.R, self.LB = coef.shape[1], x.shape[1]
        self.lib = lib = _build.load_probes()
        if lib.probe_fixed_anatomy_rows() != ROWS:
            raise RuntimeError("csrc/probes/fixed_anatomy.cu rows a CTA "
                               "disagree with fixed_interp_anatomy.ROWS")
        self.planes, self.x = pack(planes, x)
        self.K_pad = self.planes.shape[-1]
        self.bias, self.coef = bias.contiguous(), coef.contiguous()
        self.units = (self.R // ROWS) * (self.LB // LANES)
        dev = planes.device
        with torch.cuda.device(dev):
            n_ctas = (lib.probe_fixed_anatomy_fill(self.kr, self.R,
                                                   self.K_pad, self.LB)
                      if fill else self.units)
        if n_ctas < 0:
            raise RuntimeError("fixed_anatomy occupancy query failed: "
                               + lib.probe_error_string(n_ctas).decode())
        self.n_ctas = n_ctas
        self.out = torch.empty((SLOTS, self.R, self.LB), dtype=torch.int16,
                               device=dev)
        self.scratch = torch.empty((max(n_ctas - self.units, 1), ROWS,
                                    LANES), dtype=torch.int16, device=dev)

    @property
    def blocks_per_iter(self) -> float:
        """Blocks an iteration computes (every copy; N_REPS a grid step)."""
        return N_REPS * self.n_ctas / self.units

    def run(self, iters: int) -> torch.Tensor:
        global launches
        dev = self.planes.device
        with torch.cuda.device(dev):
            err = self.lib.probe_fixed_anatomy(
                self.planes.data_ptr(), self.bias.data_ptr(),
                self.coef.data_ptr(), self.x.data_ptr(), self.out.data_ptr(),
                self.scratch.data_ptr(), self.kr, self.R, self.K_pad,
                self.LB, self.n_ctas, iters, 0, _build.stream_handle(dev))
        if err:
            raise RuntimeError("fixed_anatomy kernel launch failed: "
                               + self.lib.probe_error_string(err).decode())
        launches += 1
        return self.out


def ladder(rung: str, planes: torch.Tensor, bias: torch.Tensor,
           coef: torch.Tensor, x: torch.Tensor, *,
           iters: int = SLOTS) -> torch.Tensor:
    """A rung's function, int16 [16, R, LB] (``x`` from
    :func:`rung_input`): the kernel for CUDA tensors (one copy of each
    tile), the plain version for CPU tensors."""
    if all(t.device.type == "cpu" for t in (planes, bias, coef, x)):
        _check(rung, planes, bias, coef, x)
        return ladder_reference(rung, planes, bias, coef, x)
    if planes.device.type != "cuda":
        raise ValueError(f"no kernel for device {planes.device}")
    if iters < SLOTS:
        raise ValueError(f"iters {iters} < {SLOTS} leaves slots unwritten")
    return LadderLaunch(rung, planes, bias, coef, x,
                        fill=False).run(iters).clone()


def measure(rung: str, seed: int = 0, target_ms: float = 20.0) -> dict:
    """One rung at the probe's shape on the card: the kernel held against
    its plain version (a mismatch raises), then µs a block from the slope
    with every SM busy, and the rate of its four int8 dots."""
    t0 = time.perf_counter()
    planes, bias, coef, xh, x16 = inputs(device="cuda")
    x = rung_input(rung, xh, x16)
    ll = LadderLaunch(rung, planes, bias, coef, x)
    got = ll.run(SLOTS).clone()
    mism = int((got != ladder_reference(rung, planes, bias, coef, x)).sum())
    if mism:
        raise AssertionError(f"fixed_anatomy {rung}: {mism} mismatches")
    macs = 4 * C * K * LB                                # the four dots
    s = tr.slope_ms(ll.run, ll.blocks_per_iter * macs,
                    tr.DATASHEET_MACS["int8"], target_ms)
    us = s["slope_ms"] * 1e3 / ll.blocks_per_iter
    return {"rung": rung, "n_ctas": ll.n_ctas, "units": ll.units,
            "mismatches": mism, **s, "us_per_block": us,
            "tmacs": macs / (us * 1e-6) / 1e12,
            "seconds": time.perf_counter() - t0}


def run(log=print) -> dict:
    """The four rungs and the deltas the TPU probe prints."""
    out = {}
    for rung in RUNGS:
        r = measure(rung)
        out[rung] = r
        log(f"{rung:12s} {r['us_per_block']:8.3f} us/block   "
            f"({r['tmacs']:7.2f} T MAC/s effective), ctas {r['n_ctas']}")
    t = [out[r]["us_per_block"] for r in RUNGS]
    out["attribution_us"] = {"dots": t[0], "combine_bias": t[1] - t[0],
                             "extract": t[2] - t[1], "mix_sat": t[3] - t[2]}
    log(f"per-block attribution (us): dots {t[0]:.3f}, combine+bias "
        f"+{t[1] - t[0]:.3f}, extract +{t[2] - t[1]:.3f}, mix+sat "
        f"+{t[3] - t[2]:.3f}")
    return out
