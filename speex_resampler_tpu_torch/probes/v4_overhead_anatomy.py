"""The streamed int8 block at D = 4 split into its parts (probe P1).

Counterpart of ``experiments/v4_overhead_anatomy.py`` (``bench``,
``pallas_call`` :53; bodies ``k_mxu`` :77, ``k_ex32`` :89, ``k_full`` :99).
At R, K, LB = 128, 512, 1024, with w8 int8 [8, R, K], x16 int16 [K, LB]
and x8 int8 [2, K, LB], a grid step writes int32 [R, LB] to slot i % 16:

- ``mxu_only``: sum_d w8[2d] . x8[0] + w8[2d+1] . x8[1] (pre-split planes)
- ``extract_i32+2``: w8[0] . xh + w8[1] . xl
- ``full``: sum_d w8[2d] . xh + w8[2d+1] . xl

with xh = x16 >> 8 (arithmetic) and xl = (x16 & 255) - 128, every sum
exact in int32.  :func:`anatomy` returns the function, int32 [16, R, LB]:
the kernel (``csrc/probes/int8_anatomy.cu``: K2b's planes, fragments and
wgmmas at N = 32 rows, or 64, operands resident) for CUDA tensors, the
plain version :func:`anatomy_reference` for CPU tensors.  :func:`measure`
times a variant: µs per [128, 512] . [512, 1024] block with every SM busy.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ops import _build
from ..ops.tiled_fir import full_perm, wrap_int32
from . import tc_rate as tr

__all__ = ["R", "K", "LB", "D", "VARIANTS", "inputs", "library_call",
           "pack_planes",
           "split", "anatomy_reference", "anatomy", "AnatomyLaunch",
           "groups_for", "measure", "run", "launches"]

R, K, LB = 128, 512, 1024
D = 4
VARIANTS = ("mxu_only", "extract_i32+2", "full")
N_TILES = (32, 64)
SLOTS = tr.SLOTS
LANES = tr.LANES
MAX_SMEM = tr.MAX_SMEM

launches = 0


def inputs(R: int = R, K: int = K, LB: int = LB, seed: int = 0,
           device="cpu"):
    """The TPU probe's arrays from ``np.random.default_rng(seed)``, drawn in
    its order: w8 int8 [2D, R, K], x16 int16 [K, LB], x8 int8 [2, K, LB]."""
    rng = np.random.default_rng(seed)
    w8 = rng.integers(-128, 128, (2 * D, R, K)).astype(np.int8)
    x16 = rng.integers(-32768, 32768, (K, LB)).astype(np.int16)
    x8 = rng.integers(-128, 128, (2, K, LB)).astype(np.int8)
    return tuple(torch.from_numpy(a).to(device) for a in (w8, x16, x8))


def split(x16: torch.Tensor):
    """(xh, xl) int8: the high byte, arithmetic, and the low byte - 128."""
    u = x16.to(torch.int32)
    return (u >> 8).to(torch.int8), ((u & 255) - 128).to(torch.int8)


def _planes_used(variant: str) -> int:
    return 2 if variant == "extract_i32+2" else 2 * D


def anatomy_reference(variant: str, w8: torch.Tensor,
                      x: torch.Tensor) -> torch.Tensor:
    """The plain version, int32 [16, R, LB]: ``x`` is x8 for mxu_only, else
    x16; exact int64 products, reduced mod 2^32."""
    if variant == "mxu_only":
        a, b = x[0], x[1]
    else:
        a, b = split(x)
    acc = 0
    for d in range(_planes_used(variant) // 2):
        acc = acc + tr.exact_matmul(w8[2 * d], a) \
            + tr.exact_matmul(w8[2 * d + 1], b)
    return wrap_int32(acc).unsqueeze(0).repeat(SLOTS, 1, 1)


def library_call(variant: str, w8: torch.Tensor, x: torch.Tensor):
    """The yardstick, as a function: one ``torch._int_mm`` computing a
    variant's block, its planes side by side along K against its x planes
    stacked ([w8[0] w8[1] ...] . [a; b; a; b; ...], a, b = x8[0], x8[1] or
    xh, xl), operands in device memory.  The port never calls it."""
    a, b = (x[0], x[1]) if variant == "mxu_only" else split(x)
    n = _planes_used(variant)
    wcat = torch.cat(list(w8[:n]), dim=1).contiguous()          # [R, nK]
    xcat = torch.cat([a, b] * (n // 2), dim=0)                  # [nK, LB]
    xcat = xcat.t().contiguous().t()                            # column-major
    return lambda: torch._int_mm(wcat, xcat)


def pack_planes(w8: torch.Tensor) -> torch.Tensor:
    """w8 [2D, R, K] with each 32-tap group in K_PERM order (K2b's
    layout, ``tiled_fir.int8_k_major``), contiguous, on w8's device."""
    perm = torch.from_numpy(full_perm(w8.shape[-1])).to(w8.device)
    return w8[..., perm].contiguous()


def smem_bytes(variant: str, n: int, kb: int) -> int:
    """A CTA's dynamic shared memory at kb taps (``smem_bytes`` in the
    source): its planes' rows, its x rows (two int8 planes for mxu_only,
    int16 else, 16-byte padded), alignment."""
    x = 2 * kb * (LANES + 16) if variant == "mxu_only" else kb * (2 * LANES
                                                                  + 16)
    return _planes_used(variant) * n * kb + x + 128


def groups_for(variant: str, n: int, K: int = K) -> int:
    """The fewest tap groups (K / groups taps a CTA, a power of two) whose
    CTA fits in shared memory."""
    g = 1
    while K % (32 * g) == 0:
        if smem_bytes(variant, n, K // g) <= MAX_SMEM:
            return g
        g *= 2
    raise ValueError(f"{variant} at N = {n}, K = {K} does not fit")


def _check(variant: str, w8: torch.Tensor, x: torch.Tensor, n: int) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} not in {VARIANTS}")
    if n not in N_TILES:
        raise ValueError(f"N-tile {n} not in {N_TILES}")
    want = (2, w8.shape[2], None) if variant == "mxu_only" else (
        w8.shape[2], None)
    if w8.dim() != 3 or w8.shape[0] != 2 * D or w8.dtype != torch.int8 \
            or x.dim() != len(want) or any(
                a is not None and a != b for a, b in zip(want, x.shape)) \
            or x.dtype != (torch.int8 if variant == "mxu_only"
                           else torch.int16):
        raise ValueError(f"{variant}: w8 int8 [{2 * D}, R, K] and x "
                         f"{'int8 [2, K, LB]' if variant == 'mxu_only' else 'int16 [K, LB]'}"
                         f"; got {tuple(w8.shape)} {w8.dtype}, "
                         f"{tuple(x.shape)} {x.dtype}")
    Rr, Kk, L = w8.shape[1], w8.shape[2], x.shape[-1]
    if Rr % n or L % LANES or Kk % 32:
        raise ValueError(f"R % {n}, LB % {LANES} and K % 32 must be 0")
    if w8.device != x.device:
        raise ValueError(f"w8 on {w8.device}, x on {x.device}")


class AnatomyLaunch:
    """The kernel's launches for one variant on CUDA tensors (out int32
    [16, R, LB], partial tiles where the taps are split, the copies'
    scratch tiles); ``run(iters)`` launches on the current stream."""

    def __init__(self, variant: str, w8: torch.Tensor, x: torch.Tensor,
                 n: int = 32, fill: bool = True):
        _check(variant, w8, x, n)
        self.variant, self.n = variant, n
        self.R, self.K, self.LB = w8.shape[1], w8.shape[2], x.shape[-1]
        self.groups = groups_for(variant, n, self.K)
        self.lib = lib = _build.load_probes()
        self.v = VARIANTS.index(variant)
        smem = smem_bytes(variant, n, self.K // self.groups)
        if lib.probe_int8_anatomy_smem(self.v, n, self.K,
                                       self.groups) != smem:
            raise RuntimeError("csrc/probes/int8_anatomy.cu shared memory "
                               "disagrees with v4_overhead_anatomy.smem_bytes")
        self.units = (self.R // n) * (self.LB // LANES) * self.groups
        dev = w8.device
        with torch.cuda.device(dev):
            n_ctas = (lib.probe_int8_anatomy_fill(self.v, n, self.R, self.K,
                                                  self.LB, self.groups)
                      if fill else self.units)
        if n_ctas < 0:
            raise RuntimeError("int8_anatomy occupancy query failed: "
                               + lib.probe_error_string(n_ctas).decode())
        self.n_ctas = n_ctas
        self.w = pack_planes(w8)
        self.x = x.contiguous()
        self.out = torch.empty((SLOTS, self.R, self.LB), dtype=torch.int32,
                               device=dev)
        self.partial = (torch.empty((self.groups, SLOTS, self.R, self.LB),
                                    dtype=torch.int32, device=dev)
                        if self.groups > 1 else None)
        self.scratch = torch.empty((max(n_ctas - self.units, 1), n, LANES),
                                   dtype=torch.int32, device=dev)

    @property
    def blocks_per_iter(self) -> float:
        """[R, LB] blocks an iteration computes (every copy)."""
        return self.n_ctas / self.units

    def run(self, iters: int) -> torch.Tensor:
        global launches
        dev = self.w.device
        with torch.cuda.device(dev):
            err = self.lib.probe_int8_anatomy(
                self.w.data_ptr(), self.x.data_ptr(), self.out.data_ptr(),
                None if self.partial is None else self.partial.data_ptr(),
                self.scratch.data_ptr(), self.v, self.n, self.R, self.K,
                self.LB, self.groups, self.n_ctas, iters, 0,
                _build.stream_handle(dev))
        if err:
            raise RuntimeError("int8_anatomy kernel launch failed: "
                               + self.lib.probe_error_string(err).decode())
        launches += 1
        return self.out


def anatomy(variant: str, w8: torch.Tensor, x: torch.Tensor, *,
            n: int = 32, iters: int = SLOTS) -> torch.Tensor:
    """The probe's function, int32 [16, R, LB] (``x``: x8 for mxu_only,
    else x16): the kernel for CUDA tensors (one copy of each tile), the
    plain version for CPU tensors."""
    if w8.device.type == "cpu" and x.device.type == "cpu":
        _check(variant, w8, x, n)
        return anatomy_reference(variant, w8, x)
    if w8.device.type != "cuda":
        raise ValueError(f"no kernel for device {w8.device}")
    if iters < SLOTS:
        raise ValueError(f"iters {iters} < {SLOTS} leaves slots unwritten")
    return AnatomyLaunch(variant, w8, x, n, fill=False).run(iters).clone()


def measure(variant: str, n: int = 32, seed: int = 0,
            target_ms: float = 20.0) -> dict:
    """One variant at the probe's shape on the card: the kernel held
    against its plain version (a mismatch raises), then µs a block from
    the slope with every SM busy, and the rate of its int8 dots."""
    t0 = time.perf_counter()
    w8, x16, x8 = inputs(device="cuda")
    x = x8 if variant == "mxu_only" else x16
    al = AnatomyLaunch(variant, w8, x, n)
    got = al.run(SLOTS).clone()
    mism = int((got != anatomy_reference(variant, w8, x)).sum())
    if mism:
        raise AssertionError(f"int8_anatomy {variant} n {n}: {mism} "
                             f"mismatches")
    macs = _planes_used(variant) * R * K * LB          # a block's dots
    s = tr.slope_ms(al.run, al.blocks_per_iter * macs,
                    tr.DATASHEET_MACS["int8"], target_ms)
    us = s["slope_ms"] * 1e3 / al.blocks_per_iter
    return {"variant": variant, "n": n, "groups": al.groups,
            "n_ctas": al.n_ctas, "units": al.units, "mismatches": mism, **s,
            "us_per_block": us, "tmacs": macs / (us * 1e-6) / 1e12,
            "seconds": time.perf_counter() - t0}


def run(log=print) -> dict:
    """Every variant at N = 32 (K2b's tile) and N = 64; the attribution
    the TPU probe prints, per N."""
    out = {}
    for n in N_TILES:
        for variant in VARIANTS:
            r = measure(variant, n)
            out[f"{variant}_n{n}"] = r
            log(f"{variant:14s} N={n:2d} groups={r['groups']} "
                f"ctas={r['n_ctas']}  {r['us_per_block']:8.3f} us/block "
                f"({r['tmacs']:7.2f} T MAC/s)")
        t_mxu = out[f"mxu_only_n{n}"]["us_per_block"]
        t_ex = out[f"extract_i32+2_n{n}"]["us_per_block"]
        t_full = out[f"full_n{n}"]["us_per_block"]
        two = t_mxu / D
        out[f"attribution_n{n}"] = {
            "per_2dot_us": two, "extraction_us": t_ex - two,
            "full_minus_mxu_us": t_full - t_mxu}
        log(f"N={n}: per-2-dot {two:.3f} us, extraction {t_ex - two:.3f} "
            f"us, full - mxu_only {t_full - t_mxu:.3f} us")
    return out
