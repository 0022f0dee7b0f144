"""The FIR dot at each precision of the matrix unit (probe P8).

Counterpart of ``experiments/prec_bench.py`` (``kern`` :43, ``conv`` :53,
its ``pallas_call`` :55): the padded weights of 44.1 kHz -> 48 kHz q7
(``build_padded_weights(phase_table, 147, 160, 0, 1)`` padded to L = 2 *
147 = 294 rows; R 160), x int16 [T, B] (T = 66 * 147, B = 2048) and 64
blocks, block j = ``WORD2INT(w0 . x[j] + w1 . x[j + 1])`` over its two
147-row halves, the products at each precision as the TPU lowers it:

- ``HIGHEST``: float32 products (the dense kernel's FFMA chain)
- ``HIGH``: bf16_3x, ``a = a_hi + a_lo`` (``a_hi = bf16(a)``, ``a_lo =
  bf16(a - a_hi)``) for both operands, ``W_hi x_hi + W_hi x_lo + W_lo
  x_hi`` in float32
- ``DEFAULT``: ``bf16(W) . bf16(x)`` in float32
- ``TF32``: Hopper's own middle mode, ``tf32(W) . tf32(x)`` in float32,
  both rounded to nearest with ties away from zero (``cvt.rna.tf32.f32``,
  :func:`tf32_rna`)

and each mode's max |d| and mismatch rate against the experiment's
``gold``, the float64 product rounded half up and clipped.  :func:`prec`
returns a mode's int16 [64 * R, B]: the kernel (``csrc/probes/
prec_fir.cu``) for CUDA tensors, the plain version :func:`prec_reference`
(the operands rounded as the kernel rounds them, float32 sums with TF32
off) for CPU tensors.
"""

from __future__ import annotations

import dataclasses
import functools
import time

import numpy as np
import torch

from ..ops import _build
from ..ops import filter_design as fd
from ..ops import phase as ph
from ..ops import tiled_fir as tf
from ..ops.convert import lsb_tie_limit, word2int
from . import tc_rate as tr

__all__ = ["STRIDE", "A", "R", "N_BLOCKS", "B", "PRECISIONS", "Geometry",
           "geometry", "inputs", "bf16", "tf32_rna", "operands", "gold",
           "stats", "prec_reference", "device_weights", "PrecLaunch",
           "prec", "library_call", "measure", "run", "launches"]

STRIDE, A, R = 147, 2, 160
N_BLOCKS, B = 64, 2048
PRECISIONS = ("HIGHEST", "HIGH", "DEFAULT", "TF32")
_MODE = {"HIGHEST": 0, "DEFAULT": 1, "HIGH": 2, "TF32": 3}
_PERM8 = (0, 2, 4, 6, 1, 3, 5, 7)   # K position p of an 8-tap tf32 slice

launches = 0


@dataclasses.dataclass(frozen=True)
class Geometry:
    """W f32 [A * STRIDE, R] and x's rows T for n_blocks blocks."""

    w: np.ndarray
    n_blocks: int

    @property
    def T(self) -> int:
        return (self.n_blocks + A) * STRIDE


@functools.lru_cache(maxsize=4)
def geometry(n_blocks: int = N_BLOCKS) -> Geometry:
    spec = fd.design_filter(147, 160, 7)
    w = ph.build_padded_weights(spec.phase_table, 147, 160, 0, 1)
    w = np.pad(w, ((0, A * STRIDE - w.shape[0]), (0, 0)))
    return Geometry(w=np.asarray(w, dtype=np.float32), n_blocks=n_blocks)


def inputs(g: Geometry, B: int = B, seed: int = 0,
           device="cpu") -> torch.Tensor:
    """The experiment's x: ``rng.integers(-32768, 32768, (T, B)) // 2``."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(-32768, 32768, size=(g.T, B)) // 2).astype(np.int16)
    return torch.from_numpy(x).to(device)


def bf16(t: torch.Tensor) -> torch.Tensor:
    """float32 -> bf16 (nearest even) -> float32."""
    return t.float().to(torch.bfloat16).float()


def tf32_rna(t: torch.Tensor) -> torch.Tensor:
    """float32 -> tf32 as ``cvt.rna.tf32.f32`` rounds (10 mantissa bits,
    nearest, ties away from zero), as float32: half of the 13 dropped bits'
    weight added to the magnitude, then the bits cut."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def operands(mode: str, w: torch.Tensor, x: torch.Tensor) -> list:
    """[(W term, x term), ...] of a mode, float32 values, the terms' sums
    added in order: HIGHEST (W, x); DEFAULT (bf16 W, bf16 x); HIGH (W_hi,
    x_hi), (W_hi, x_lo), (W_lo, x_hi); TF32 (tf32 W, tf32 x)."""
    w, x = w.float(), x.float()
    if mode == "HIGHEST":
        return [(w, x)]
    if mode == "DEFAULT":
        return [(bf16(w), bf16(x))]
    if mode == "TF32":
        return [(tf32_rna(w), tf32_rna(x))]
    if mode == "HIGH":
        wh, xh = bf16(w), bf16(x)
        wl, xl = bf16(w - wh), bf16(x - xh)
        return [(wh, xh), (wh, xl), (wl, xh)]
    raise ValueError(f"precision {mode!r} not in {PRECISIONS}")


def _patches(x: torch.Tensor, L: int, n_blocks: int) -> torch.Tensor:
    """[n_blocks, L, B]: block j's rows j * STRIDE .. + L (past T: 0)."""
    idx = (torch.arange(n_blocks, device=x.device)[:, None] * STRIDE
           + torch.arange(L, device=x.device)[None, :])
    virt = torch.cat([x, x.new_zeros((L, x.shape[1]))])
    return virt[idx]


def gold(w: torch.Tensor, x: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """The experiment's gold, int32 [n_blocks * R, B]: the float64 product,
    ``floor(0.5 + y)`` clipped to int16's range."""
    p = _patches(x, w.shape[0], n_blocks).double()
    y = torch.matmul(w.double().t(), p)
    return torch.floor(0.5 + y).clamp(-32768, 32767).to(
        torch.int32).reshape(n_blocks * w.shape[1], -1)


def stats(y: torch.Tensor, g: torch.Tensor) -> dict:
    """max |y - gold| and the share of outputs that differ."""
    d = (y.to(torch.int32) - g).abs()
    return {"max_abs_d": int(d.max()), "rate": float((d > 0).double().mean())}


def _check(mode, w, x, n_blocks):
    if mode not in PRECISIONS:
        raise ValueError(f"precision {mode!r} not in {PRECISIONS}")
    if w.dim() != 2 or w.dtype != torch.float32 or x.dim() != 2 \
            or x.dtype != torch.int16:
        raise TypeError("w f32 [L, R] and x int16 [T, B]")
    if w.device != x.device:
        raise ValueError(f"w on {w.device}, x on {x.device}")
    if n_blocks <= 0:
        raise ValueError(f"n_blocks {n_blocks}")


def prec_reference(mode: str, w: torch.Tensor, x: torch.Tensor,
                   n_blocks: int) -> torch.Tensor:
    """The plain version, int16 [n_blocks * R, B]: the operands rounded as
    the mode takes them (:func:`operands`), each term one float32 matmul
    of W^T and the blocks' patches with TF32 off, the terms added in order,
    then WORD2INT."""
    _check(mode, w, x, n_blocks)
    y = None
    with tf._no_tf32():
        for wt, xt in operands(mode, w, _patches(x, w.shape[0], n_blocks)):
            d = torch.matmul(wt.t(), xt)
            y = d if y is None else y + d
    return word2int(y).reshape(n_blocks * w.shape[1], -1)


def device_weights(mode: str, w: torch.Tensor) -> tuple:
    """(weights, tap table) as a mode's kernel reads them, R padded to
    R_pad = a multiple of 64 with zero columns: HIGHEST f32 [1, L, R_pad]
    and the 16-row table; DEFAULT bf16 [1, L, R_pad] and HIGH bf16 [2, L,
    R_pad] (hi, lo), TF32 f32 [R_pad, L_pad] (tf32 values, L padded to a
    multiple of 8, each 8 taps in the fragment's order), with the 64-row
    table."""
    L, Rr = w.shape
    R_pad = -(-Rr // 64) * 64
    wp = torch.nn.functional.pad(w.float(), (0, R_pad - Rr))    # [L, R_pad]
    if mode == "HIGHEST":
        planes = wp[None].contiguous()
        rows = tf.SUB_ROWS
    elif mode in ("DEFAULT", "HIGH"):
        wh = wp.to(torch.bfloat16)
        planes = (wh[None] if mode == "DEFAULT" else torch.stack(
            [wh, (wp - wh.float()).to(torch.bfloat16)])).contiguous()
        rows = tf.ROW_TILE
    elif mode == "TF32":
        L8 = -(-L // 8) * 8
        wt = torch.nn.functional.pad(tf32_rna(wp).t(), (0, L8 - L))
        perm = (torch.arange(L8) // 8 * 8 + torch.tensor(_PERM8).repeat(
            L8 // 8)).to(w.device)
        planes = wt[:, perm].contiguous()
        rows = tf.ROW_TILE
    else:
        raise ValueError(f"precision {mode!r} not in {PRECISIONS}")
    nonzero = (wp != 0).cpu().numpy()[None]
    taps = torch.from_numpy(tf.tap_ranges(nonzero, rows)).to(w.device)
    return planes, taps


class PrecLaunch:
    """A mode's launches on CUDA tensors (y int16 [n_blocks * R, B]);
    ``run()`` launches on the current stream."""

    def __init__(self, mode: str, w: torch.Tensor, x: torch.Tensor,
                 n_blocks: int):
        _check(mode, w, x, n_blocks)
        if (x.data_ptr() | w.data_ptr()) % 16:
            raise ValueError("x and w must be 16-byte aligned")
        self.lib = _build.load_probes()
        self.mode, self.m = mode, _MODE[mode]
        self.planes, self.taps = device_weights(mode, w)
        self.L, self.R = w.shape
        self.R_pad = -(-self.R // 64) * 64
        self.K = self.planes.shape[-1] if mode == "TF32" else self.L
        self.x, self.n_blocks = x.contiguous(), n_blocks
        self.y = torch.empty((n_blocks * self.R, x.shape[1]),
                             dtype=torch.int16, device=x.device)

    def run(self) -> torch.Tensor:
        global launches
        dev = self.x.device
        with torch.cuda.device(dev):
            err = self.lib.probe_prec_fir(
                self.x.data_ptr(), self.y.data_ptr(), self.taps.data_ptr(),
                self.planes.data_ptr(), self.m, self.x.shape[0],
                self.x.shape[1], self.R, self.R_pad, self.K, STRIDE,
                self.n_blocks, _build.stream_handle(dev))
        if err:
            raise RuntimeError("prec_fir kernel launch failed: "
                               + self.lib.probe_error_string(err).decode())
        launches += 1
        return self.y


def prec(mode: str, w: torch.Tensor, x: torch.Tensor,
         n_blocks: int = N_BLOCKS) -> torch.Tensor:
    """The probe's function, int16 [n_blocks * R, B]: the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return prec_reference(mode, w, x, n_blocks)
    _check(mode, w, x, n_blocks)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return PrecLaunch(mode, w, x, n_blocks).run()


def library_call(mode: str, w: torch.Tensor, x: torch.Tensor,
                 n_blocks: int = N_BLOCKS):
    """The yardstick, as a function: one batched matmul of W^T and the
    gathered patches in the mode's type (float32 with TF32 off for
    HIGHEST, bf16 for DEFAULT, float32 with TF32 on for TF32; for HIGH,
    one bf16 bmm with a float32 result of the three products concatenated
    along K, [W_hi, W_hi, W_lo] . [x_hi, x_lo, x_hi], as split5's
    yardstick), operands in device memory.  The port never calls it."""
    p = _patches(x, w.shape[0], n_blocks).float()
    if mode == "HIGH":
        (wh, xh), (_, xl), (wl, _) = operands(mode, w.t(), p)
        a = torch.cat([wh, wh, wl], dim=1).to(torch.bfloat16).expand(
            n_blocks, -1, -1).contiguous()                  # [nb, R, 3L]
        b = torch.cat([xh, xl, xh], dim=1).to(torch.bfloat16).contiguous()
        return lambda: torch.bmm(a, b, out_dtype=torch.float32)
    wt = w.t().float().expand(n_blocks, -1, -1).contiguous()
    if mode == "DEFAULT":
        a, b = wt.to(torch.bfloat16), p.to(torch.bfloat16)
        return lambda: torch.bmm(a, b)

    def call():
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = mode == "TF32"
        try:
            return torch.bmm(wt, p)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
    return call


def measure(mode: str, seed: int = 0) -> dict:
    """One mode on the card: held against the plain version (max |err| <=
    1 LSB within the tie bound), its and the plain version's max |d| and
    mismatch rate against the gold, ms a launch (median of 5 groups of 20)."""
    t0 = time.perf_counter()
    g = geometry()
    w = torch.from_numpy(g.w).cuda()
    x = inputs(g, seed=seed, device="cuda")
    pl = PrecLaunch(mode, w, x, g.n_blocks)
    got = pl.run().clone()
    want = prec_reference(mode, w, x, g.n_blocks)
    d = (got.int() - want.int()).abs()
    err, mism = int(d.max()), int((d > 0).sum())
    if err > 1 or mism > lsb_tie_limit(d.numel()):
        raise AssertionError(f"prec_fir {mode}: max |err| {err}, {mism} "
                             f"mismatches")
    gd = gold(w, x, g.n_blocks)
    ms = tr.events_ms(lambda: [pl.run() for _ in range(20)]) / 20
    return {"mode": mode, "max_abs_err": err, "mismatches": mism,
            "kernel_vs_gold": stats(got, gd), "plain_vs_gold": stats(want, gd),
            "ms": ms, "seconds": time.perf_counter() - t0}


def run(log=print) -> dict:
    """Every mode: the experiment's line (max |d|, mismatch rate, ms a
    launch, G samples/s) for the kernel, the plain version's statistics
    beside."""
    out = {}
    for mode in PRECISIONS:
        r = measure(mode)
        out[mode] = r
        k, p = r["kernel_vs_gold"], r["plain_vs_gold"]
        log(f"{mode:8s} max|d|={k['max_abs_d']} rate={k['rate']:.2e} "
            f"(plain {p['max_abs_d']}, {p['rate']:.2e})  {r['ms']:.4f} "
            f"ms/launch  {N_BLOCKS * R * B / (r['ms'] * 1e-3) / 1e9:.1f} "
            f"Gsample/s")
    return out
