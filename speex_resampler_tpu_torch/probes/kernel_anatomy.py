"""The tiled f32 block on the CUDA cores split into its parts (probe P6).

Counterpart of ``experiments/kernel_anatomy.py`` (``make`` :43, its
``pallas_call`` :63): the phase-tiled weights of 44.1 kHz -> 48 kHz q7
(``build_phase_tiled_weights(phase_table, 147, 160, 0)``: P 20, R 128, K
264, S 2352, no history), 4 periods (80 blocks), x int16 [T, B] with T =
``ceil((3 S + offsets[-1] + K) / 16) * 16``, B = 2048.  Block (j, m) reads
``x[j * S + offsets[m] : + K]``; the variants:

- ``full``: ``WORD2INT(W_m . float(patch))``, f32 (HIGHEST)
- ``nodot``: ``WORD2INT`` of the patch's column sums, the same in all R
  rows (exact in f32)
- ``noslice``: full with every block reading rows 0 .. K
- ``nocvt``: full with x handed over as float32 [T, B]

:func:`anatomy` returns a variant's int16 [n_blocks * R, B]: the kernel
(``csrc/probes/f32_anatomy.cu``: full and noslice are the served highest
body, ``fir::f32::fir_tile``; nodot and nocvt that body with the dots or
the conversion taken out) for CUDA tensors, the plain version
:func:`anatomy_reference` (float32 matmuls with TF32 off) for CPU tensors.
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

__all__ = ["B", "N_PERIODS", "VARIANTS", "Geometry", "geometry", "weights",
           "launch_kw", "inputs", "variant_input", "anatomy_reference",
           "anatomy", "AnatomyLaunch", "library_call",
           "measure", "run", "launches"]

B = 2048
N_PERIODS = 4
VARIANTS = ("full", "nodot", "noslice", "nocvt")

launches = 0


@dataclasses.dataclass(frozen=True)
class Geometry:
    """The experiment's module constants: weights f32 [P, K, R]."""

    P: int
    K: int
    R: int
    S: int
    T: int
    offsets: tuple
    w: np.ndarray


@functools.lru_cache(maxsize=1)
def geometry() -> Geometry:
    spec = fd.design_filter(147, 160, 7)
    ptw = ph.build_phase_tiled_weights(spec.phase_table, 147, 160, 0)
    offs = tuple(int(o) for o in ptw.offsets)
    T = -(-((N_PERIODS - 1) * ptw.S + offs[-1] + ptw.K) // 16) * 16
    return Geometry(P=ptw.P, K=ptw.K, R=ptw.R, S=ptw.S, T=T, offsets=offs,
                    w=np.asarray(ptw.w, dtype=np.float32))


def weights(g: Geometry, device="cpu") -> tuple:
    """(w f32 [P, K, R], the 16-row sub-band table int32 [P, R / 16, 2]):
    the served highest weights (``tiled_fir.device_weights``)."""
    return tf.device_weights(g.w, "highest", device)


def launch_kw(g: Geometry, device="cpu", n_periods: int = N_PERIODS) -> dict:
    return dict(offsets=torch.tensor(g.offsets, dtype=torch.int32,
                                     device=device),
                S=g.S, n_blocks=n_periods * g.P)


def inputs(g: Geometry, B: int = B, seed: int = 0, device="cpu",
           T: int | None = None) -> torch.Tensor:
    """The experiment's x16: ``rng.integers(-32768, 32768, (T, B)) // 2``
    from ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    T = g.T if T is None else T
    x = (rng.integers(-32768, 32768, size=(T, B)) // 2).astype(np.int16)
    return torch.from_numpy(x).to(device)


def variant_input(variant: str, x16: torch.Tensor) -> torch.Tensor:
    """The x a variant reads: x16, or for nocvt x16 as float32."""
    return x16.float() if variant == "nocvt" else x16


def _check(variant, x, w, offsets, S, n_blocks):
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} not in {VARIANTS}")
    want = torch.float32 if variant == "nocvt" else torch.int16
    if x.dtype != want or x.dim() != 2:
        raise TypeError(f"{variant} takes x {want} [T, B], got {x.dtype} "
                        f"{tuple(x.shape)}")
    P, K, R = tf.check_launch(x.new_zeros((0, x.shape[1]), dtype=torch.int16),
                              x.new_zeros((0, x.shape[1]), dtype=torch.int16),
                              w, "highest", ())
    if offsets.dtype != torch.int32 or tuple(offsets.shape) != (P,) \
            or n_blocks % P or S <= 0:
        raise ValueError(f"offsets {tuple(offsets.shape)}, n_blocks "
                         f"{n_blocks} for P = {P}")
    for t in (x, offsets):
        if t.device != w[0].device:
            raise ValueError(f"tensor on {t.device}, weights on "
                             f"{w[0].device}")
    return P, K, R


def anatomy_reference(variant: str, x: torch.Tensor, w: tuple, *,
                      offsets: torch.Tensor, S: int,
                      n_blocks: int) -> torch.Tensor:
    """The plain version, int16 [n_blocks * R, B]: each block's patch
    gathered (rows past T read as zero), then a float32 matmul with TF32
    off (full, noslice, nocvt) or the patch's column sums (nodot), then
    WORD2INT."""
    P, K, R = _check(variant, x, w, offsets, S, n_blocks)
    Bn = x.shape[1]
    k = torch.arange(n_blocks, device=x.device)
    v0 = (k // P) * S + offsets.long()[k % P]
    if variant == "noslice":
        v0 = torch.zeros_like(v0)
    idx = v0[:, None] + torch.arange(K, device=x.device)[None, :]
    virt = torch.cat([x.float(), x.new_zeros((K, Bn), dtype=torch.float32)])
    patch = virt[idx]                                     # [nb, K, B]
    if variant == "nodot":
        y = patch.sum(1, keepdim=True).expand(n_blocks, R, Bn)
    else:
        with tf._no_tf32():
            y = torch.matmul(w[0][k % P].transpose(1, 2), patch)
    return word2int(y).reshape(n_blocks * R, Bn)


class AnatomyLaunch:
    """One variant's launches on CUDA tensors (y int16 [n_blocks * R, B]);
    ``run()`` launches on the current stream."""

    def __init__(self, variant: str, x: torch.Tensor, w: tuple, *,
                 offsets: torch.Tensor, S: int, n_blocks: int):
        P, K, R = _check(variant, x, w, offsets, S, n_blocks)
        if x.shape[1] % 8 or (x.data_ptr() | w[0].data_ptr()) % 16:
            raise ValueError("B must be a multiple of 8 and x and w 16-byte "
                             "aligned")
        self.lib = _build.load_probes()
        self.v = VARIANTS.index(variant)
        self.x, self.w, self.offsets = x.contiguous(), w, offsets
        self.S, self.n_blocks, self.P, self.K, self.R = S, n_blocks, P, K, R
        self.y = torch.empty((n_blocks * R, x.shape[1]), dtype=torch.int16,
                             device=x.device)

    def run(self) -> torch.Tensor:
        global launches
        dev = self.x.device
        with torch.cuda.device(dev):
            err = self.lib.probe_f32_anatomy(
                self.x.data_ptr(), self.y.data_ptr(),
                self.offsets.data_ptr(), self.w[1].data_ptr(),
                self.w[0].data_ptr(), self.v, self.x.shape[0],
                self.x.shape[1], self.R, self.K, self.P, self.S,
                self.n_blocks, _build.stream_handle(dev))
        if err:
            raise RuntimeError("f32_anatomy kernel launch failed: "
                               + self.lib.probe_error_string(err).decode())
        launches += 1
        return self.y


def anatomy(variant: str, x: torch.Tensor, w: tuple, *,
            offsets: torch.Tensor, S: int, n_blocks: int) -> torch.Tensor:
    """The probe's function, int16 [n_blocks * R, B]: the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    kw = dict(offsets=offsets, S=S, n_blocks=n_blocks)
    if x.device.type == "cpu":
        return anatomy_reference(variant, x, w, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return AnatomyLaunch(variant, x, w, **kw).run()


def library_call(variant: str, x: torch.Tensor, w: tuple, *,
                 offsets: torch.Tensor, S: int, n_blocks: int):
    """The yardstick, as a function: one PyTorch call on the blocks'
    gathered patches, operands in device memory: a float32 ``torch.bmm``
    (TF32 off) with the blocks' weights, or for nodot ``torch.sum`` over
    the taps (no WORD2INT either way).  The port never calls it."""
    P, K = w[0].shape[0], w[0].shape[1]
    k = torch.arange(n_blocks, device=x.device)
    v0 = torch.zeros_like(k) if variant == "noslice" else \
        (k // P) * S + offsets.long()[k % P]
    idx = v0[:, None] + torch.arange(K, device=x.device)[None, :]
    b = x.float()[idx].contiguous()
    if variant == "nodot":
        return lambda: torch.sum(b, dim=1)
    a = w[0][k % P].transpose(1, 2).contiguous()

    def call():
        with tf._no_tf32():
            return torch.bmm(a, b)
    return call


def measure(variant: str, seed: int = 0) -> dict:
    """One variant on the card: held against the plain version (max |err|
    <= 1 LSB within the tie bound; nodot 0 mismatches), then ms a launch
    (median of 5 groups of 20)."""
    t0 = time.perf_counter()
    g = geometry()
    x = variant_input(variant, inputs(g, seed=seed, device="cuda"))
    w, kw = weights(g, "cuda"), launch_kw(g, "cuda")
    al = AnatomyLaunch(variant, x, w, **kw)
    got = al.run().clone()
    d = (got.int() - anatomy_reference(variant, x, w, **kw).int()).abs()
    err, mism = int(d.max()), int((d > 0).sum())
    if (variant == "nodot" and mism) or err > 1 \
            or mism > lsb_tie_limit(d.numel()):
        raise AssertionError(f"f32_anatomy {variant}: max |err| {err}, "
                             f"{mism} mismatches")
    ms = tr.events_ms(lambda: [al.run() for _ in range(20)]) / 20
    return {"variant": variant, "max_abs_err": err, "mismatches": mism,
            "ms": ms, "seconds": time.perf_counter() - t0}


def run(log=print) -> dict:
    """Every variant, and each one's difference from full."""
    out = {v: measure(v) for v in VARIANTS}
    full = out["full"]["ms"]
    for v in VARIANTS:
        r = out[v]
        log(f"{v:8s} {r['ms']:.4f} ms ({r['ms'] - full:+.4f} against full; "
            f"{r['mismatches']} ties)")
    return out
