"""The flagship's int8 launch (K1b) split into its parts (probe P5).

Counterpart of ``experiments/v3_overhead_anatomy.py`` (``_make_variant``
:83, ``pallas_call`` :230): at the flagship's tiled geometry (44.1 kHz ->
48 kHz q7, 9408-frame launch: P 20, S 2352, R 128, K 264, H 128, 4 periods,
80 blocks, the chunk 14112 rows) and its int8 weights (D = 3 digit planes,
bias, scales), output block (period j, phase m) is R rows of every lane
from the K-row patch of ``hist ++ x`` at ``j * S + offsets[m]``:

- ``full``: K1b's function (``streamed_fir.resample_streamed``, scheme
  int8, the resident kernel)
- ``hoist``: the same output (x split into int8 planes first)
- ``no_assemble``: every block of period j reads phase 0's patch, full
  epilogue
- ``no_epilogue``: the raw sum ``sum_d <w_d, xh> + <w_d, xl>`` (xh = x >>
  8, xl = (x & 255) - 128) wrapped to int16, ``((v + 2^15) mod 2^16) -
  2^15``: no digit combine, bias or WORD2INT
- ``dots_only``: phase 0's patch of the period, the raw sum

:func:`anatomy` returns a variant's int16 ``[n_blocks * R, B]``: the kernel
(``csrc/probes/v3_anatomy.cu``, a CTA walking one (period, 64-row tile, 64
lanes) phase by phase, the TPU program's order) for CUDA tensors, the plain
version :func:`anatomy_reference` (K1b's plain steps,
``tiled_fir.apply_weights``) for CPU tensors.  :func:`measure` times a
variant's launch beside the served K1b's.
"""

from __future__ import annotations

import dataclasses
import functools
import time

import numpy as np
import torch

from ..ops import _build
from ..ops import filter_design as fd
from ..ops import tiled_fir as tf
from ..parallel import batch as tb
from . import check_offsets_launch, served_tiled
from . import tc_rate as tr

__all__ = ["B", "TARGET_IN", "D", "VARIANTS", "Geometry", "geometry",
           "weights", "launch_kw", "inputs", "wrap16", "split",
           "anatomy_reference", "anatomy", "AnatomyLaunch", "served",
           "measure", "run", "launches"]

B = 2048
TARGET_IN = 9408
D = 3
VARIANTS = ("full", "hoist", "no_assemble", "no_epilogue", "dots_only")

launches = 0


@dataclasses.dataclass(frozen=True)
class Geometry:
    """The experiment's ``_geometry()``: the flagship's tiled launch and
    its int8 weights (planes int8 [D, P, K, R], bias f32 [P, R], the D
    digit scales)."""

    S: int
    K: int
    P: int
    R: int
    H: int
    gp: int
    V: int
    n_periods: int
    n_blocks: int
    chunk_rows: int
    in_per_launch: int
    offsets: tuple
    planes: np.ndarray
    bias: np.ndarray
    scales: tuple


@functools.lru_cache(maxsize=1)
def geometry() -> Geometry:
    spec = fd.design_filter(147, 160, 7)
    bspec = tb._launch_geometry(spec, TARGET_IN)
    assert bspec.kernel == "tiled", bspec.kernel
    ptw = tb._tiled_weights(spec, bspec.f0)
    scheme, int8p, scales = tb._resolve_scheme(ptw.w, "auto")
    assert scheme == "int8" and len(scales) == D, (scheme, scales)
    H = tb._hist_rows_tiled(spec.filt_len)
    gp = tb._v3_periods_per_program(ptw.P)
    V = tb._v3_views(ptw.S, ptw.K, H, ptw.offsets) + (gp - 1)
    n_periods = bspec.n_blocks // ptw.P
    chunk_rows = (n_periods - tb._v3_back(ptw.S, H) + V) * ptw.S
    return Geometry(S=ptw.S, K=ptw.K, P=ptw.P, R=ptw.R, H=H, gp=gp, V=V,
                    n_periods=n_periods, n_blocks=bspec.n_blocks,
                    chunk_rows=chunk_rows, in_per_launch=bspec.in_per_launch,
                    offsets=tuple(int(o) for o in ptw.offsets),
                    planes=int8p[0], bias=int8p[1],
                    scales=tuple(float(s) for s in scales))


def weights(g: Geometry, device="cpu") -> tuple:
    """K1b's device weights: (planes int8 [D, P, R, K_pad] K-major and
    permuted, bias f32 [P, R], slices, taps int32 [P, R / 64, 2])
    (``tiled_fir.device_weights``)."""
    return tf.device_weights((g.planes, g.bias), "int8", device)


def launch_kw(g: Geometry, device="cpu", n_periods: int | None = None) -> dict:
    """The launch's keywords: the TPU program's origin table, its period
    S, the blocks and the digit scales."""
    n = g.n_periods if n_periods is None else n_periods
    return dict(offsets=torch.tensor(g.offsets, dtype=torch.int32,
                                     device=device),
                S=g.S, n_blocks=n * g.P, scales=g.scales)


def inputs(g: Geometry, B: int = B, seed: int = 0, device="cpu"):
    """The experiment's hist (zeros, [H, B]) and chunk ([chunk_rows, B]:
    ``rng.integers(-32768, 32768) // 2`` in the launch's real rows, zeros
    after) from ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    x = np.zeros((g.chunk_rows, B), np.int16)
    n = g.in_per_launch
    x[:n] = (rng.integers(-32768, 32768, (n, B)) // 2).astype(np.int16)
    hist = np.zeros((g.H, B), np.int16)
    return torch.from_numpy(hist).to(device), torch.from_numpy(x).to(device)


def wrap16(v: torch.Tensor) -> torch.Tensor:
    """An integer tensor -> int16 by two's complement truncation:
    ``((v + 2^15) mod 2^16) - 2^15``."""
    return (((v.to(torch.int64) + 32768) & 0xFFFF) - 32768).to(torch.int16)


def split(x: torch.Tensor):
    """(xh, xl) as int64: x >> 8 and (x & 255) - 128, x = 256 xh + xl +
    128."""
    u = x.to(torch.int64)
    return u >> 8, (u & 255) - 128


def _origins(variant: str, offsets: torch.Tensor, S: int,
             n_blocks: int) -> torch.Tensor:
    P = offsets.shape[0]
    k = torch.arange(n_blocks, device=offsets.device)
    m = torch.zeros_like(k) if variant in ("no_assemble", "dots_only") \
        else k % P
    return (k // P) * S + offsets.long()[m]


def _check(variant, hist, x, w, offsets, S, n_blocks, scales):
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} not in {VARIANTS}")
    P, K, R = check_offsets_launch(hist, x, w, offsets, S, n_blocks, "int8",
                                   scales)
    if len(scales) != D:
        raise ValueError(f"{len(scales)} digit planes, the probe takes {D}")
    last = (n_blocks // P - 1) * S + int(offsets.max())
    if last > hist.shape[0] + x.shape[0]:
        raise ValueError("a patch starts past hist ++ x")
    return P, K, R


def anatomy_reference(variant: str, hist: torch.Tensor, x: torch.Tensor,
                      w: tuple, *, offsets: torch.Tensor, S: int,
                      n_blocks: int, scales: tuple) -> torch.Tensor:
    """The plain version, int16 [n_blocks * R, B]: K1b's plain steps
    (``tiled_fir.apply_weights``, scheme int8) at each variant's patch
    origins, or for the raw variants the exact sum of the planes' dots with
    xh + xl (float64, exact: |sum| < 2^25), wrapped to int16."""
    P, K, R = _check(variant, hist, x, w, offsets, S, n_blocks, scales)
    v0 = _origins(variant, offsets, S, n_blocks)
    planes = tf.int8_n_major(w[0])                     # [D, P, K, R]
    if variant in ("full", "hoist", "no_assemble"):
        return tf.apply_weights(hist, x, (planes, w[1]), v0, "int8", scales)
    B = hist.shape[1]
    phase = torch.arange(n_blocks, device=x.device) % P
    idx = v0[:, None] + torch.arange(K, device=x.device)[None, :]
    virt = torch.cat([hist, x, x.new_zeros((K, B))])
    xh, xl = split(virt[idx])                          # [nb, K, B]
    wsum = planes.to(torch.float64).sum(0)             # [P, K, R]
    acc = torch.matmul(wsum[phase].transpose(1, 2), (xh + xl).double())
    return wrap16(acc).reshape(n_blocks * R, B)


class AnatomyLaunch:
    """One variant's launches on CUDA tensors: y int16 [n_blocks * R, B]
    and, for hoist, the split planes int8 [2, H + T + K, B];
    ``run()`` launches on the current stream."""

    def __init__(self, variant: str, hist: torch.Tensor, x: torch.Tensor,
                 w: tuple, *, offsets: torch.Tensor, S: int, n_blocks: int,
                 scales: tuple):
        P, K, R = _check(variant, hist, x, w, offsets, S, n_blocks, scales)
        if hist.shape[1] % 16:
            raise ValueError(f"B {hist.shape[1]} must be a multiple of 16")
        self.lib = lib = _build.load_probes()
        self.v = VARIANTS.index(variant)
        self.slices = max(int(w[2]), 1)
        self.smem = lib.probe_v3_anatomy_smem(self.v, self.slices, K)
        if self.smem > tr.MAX_SMEM:
            raise ValueError(f"a band of {self.slices} K-slices takes "
                             f"{self.smem} bytes of shared memory")
        self.hist, self.x, self.w = hist, x, w
        self.offsets, self.S, self.scales = offsets, S, tuple(scales)
        self.P, self.K, self.R, self.n_blocks = P, K, R, n_blocks
        H, T, Bn = hist.shape[0], x.shape[0], hist.shape[1]
        self.y = torch.empty((n_blocks * R, Bn), dtype=torch.int16,
                             device=x.device)
        self.split = (torch.empty((2, H + T + K, Bn), dtype=torch.int8,
                                  device=x.device)
                      if variant == "hoist" else None)

    def run(self) -> torch.Tensor:
        global launches
        dev = self.x.device
        H, T, Bn = self.hist.shape[0], self.x.shape[0], self.hist.shape[1]
        with torch.cuda.device(dev):
            err = self.lib.probe_v3_anatomy(
                self.hist.data_ptr(), self.x.data_ptr(), self.y.data_ptr(),
                self.offsets.data_ptr(), self.w[3].data_ptr(),
                self.w[0].data_ptr(), self.w[1].data_ptr(),
                None if self.split is None else self.split.data_ptr(),
                self.v, *self.scales, H, T, Bn, self.R, self.K, self.P,
                self.S, self.n_blocks // self.P, self.slices,
                _build.stream_handle(dev))
        if err:
            raise RuntimeError("v3_anatomy kernel launch failed: "
                               + self.lib.probe_error_string(err).decode())
        launches += 1
        return self.y

    def run_split(self) -> torch.Tensor:
        """hoist's pre-pass alone (the split planes), on the current
        stream: the walk's share of hoist's launch is ``run()`` less it."""
        global launches
        if self.split is None:
            raise ValueError("only hoist has a pre-pass")
        dev = self.x.device
        H, T, Bn = self.hist.shape[0], self.x.shape[0], self.hist.shape[1]
        with torch.cuda.device(dev):
            err = self.lib.probe_v3_split(
                self.hist.data_ptr(), self.x.data_ptr(), self.split.data_ptr(),
                H, T, Bn, self.K, _build.stream_handle(dev))
        if err:
            raise RuntimeError("v3_split kernel launch failed: "
                               + self.lib.probe_error_string(err).decode())
        launches += 1
        return self.split


def anatomy(variant: str, hist: torch.Tensor, x: torch.Tensor, w: tuple, *,
            offsets: torch.Tensor, S: int, n_blocks: int,
            scales: tuple) -> torch.Tensor:
    """The probe's function, int16 [n_blocks * R, B]: the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    kw = dict(offsets=offsets, S=S, n_blocks=n_blocks, scales=scales)
    if x.device.type == "cpu":
        return anatomy_reference(variant, hist, x, w, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return AnatomyLaunch(variant, hist, x, w, **kw).run()


def served(hist, x, w, **kw) -> torch.Tensor:
    """The served K1b on the same launch (``probes.served_tiled``: the
    resident kernel at the flagship's closed-form origins)."""
    return served_tiled(hist, x, w, scheme="int8", **kw)


def measure(variant: str, seed: int = 0) -> dict:
    """One variant at the flagship on the card: held against the plain
    version (0 mismatches; full and hoist also against the served K1b, bit
    for bit; hoist's pre-pass against :func:`split`) then ms a launch
    (median of 5 groups of 20), the served K1b's ms beside, and for hoist
    the pre-pass's ms alone."""
    t0 = time.perf_counter()
    g = geometry()
    hist, x = inputs(g, seed=seed, device="cuda")
    w, kw = weights(g, "cuda"), launch_kw(g, "cuda")
    al = AnatomyLaunch(variant, hist, x, w, **kw)
    got = al.run().clone()
    want = anatomy_reference(variant, hist, x, w, **kw)
    mism = int((got != want).sum())
    if variant in ("full", "hoist"):
        mism += int((got != served(hist, x, w, **kw)).sum())
    if mism:
        raise AssertionError(f"v3_anatomy {variant}: {mism} mismatches")
    ms = tr.events_ms(lambda: [al.run() for _ in range(20)]) / 20
    k1b = tr.events_ms(lambda: [served(hist, x, w, **kw)
                                for _ in range(20)]) / 20
    out = {"variant": variant, "B": x.shape[1], "smem": al.smem,
           "slices": al.slices, "mismatches": mism, "ms": ms,
           "served_K1b_ms": k1b}
    if variant == "hoist":
        out.update(split_check(al, hist, x))
        out["split_ms"] = tr.events_ms(
            lambda: [al.run_split() for _ in range(20)]) / 20
        out["walk_ms"] = ms - out["split_ms"]
    return {**out, "seconds": time.perf_counter() - t0}


def split_check(al: "AnatomyLaunch", hist: torch.Tensor,
                x: torch.Tensor) -> dict:
    """hoist's pre-pass planes against :func:`split` of hist ++ x ++ K
    zero rows (a mismatch raises)."""
    virt = torch.cat([hist, x, x.new_zeros((al.K, x.shape[1]))])
    xh, xl = split(virt)
    got = al.run_split()
    mism = int((got[0] != xh).sum()) + int((got[1] != xl).sum())
    if mism:
        raise AssertionError(f"v3_split: {mism} mismatches")
    return {"split_mismatches": mism}


def run(log=print) -> dict:
    """Every variant, and the ladder: full against the served K1b (the
    structure's cost), each variant's difference from full."""
    out = {v: measure(v) for v in VARIANTS}
    full = out["full"]["ms"]
    for v in VARIANTS:
        r = out[v]
        log(f"{v:12s} {r['ms']:.4f} ms ({r['ms'] - full:+.4f} against full; "
            f"served K1b {r['served_K1b_ms']:.4f} ms)"
            + (f"; pre-pass {r['split_ms']:.4f}, walk {r['walk_ms']:.4f} ms"
               if v == "hoist" else ""))
    out["ladder"] = {
        "full_minus_K1b_ms": full - out["full"]["served_K1b_ms"],
        "hoist_walk_minus_full_ms": out["hoist"]["walk_ms"] - full,
        **{f"{v}_minus_full_ms": out[v]["ms"] - full for v in VARIANTS[1:]}}
    return out
