"""The f32 launch with its history, phase by phase against one batched
product (probe P11).

Counterpart of ``experiments/batched_dot.py`` (``make`` :45, its
``pallas_call`` :102): the phase-tiled weights of 44.1 kHz -> 48 kHz q7
shifted for a 128-row history (``build_phase_tiled_weights(phase_table,
147, 160, 0, origin_shift=H - (filt_len - 1))``, H = 128: P 20, R 128, K
264, S 2352), 4 periods (80 blocks), hist int16 [H, B] and the chunk x
int16 [T_c, B] (T_c = 14112: 9408 real rows, zeros after; the TPU kernel
took it as V = 3 views of S rows).  Block (j, m) is ``WORD2INT(W_m .
float(patch))`` in float32 (HIGHEST), the patch the K rows of ``hist ++
x`` from ``j * S + offsets[m]``.  The forms:

- ``m-loop``: the TPU program's order, a phase after another, each patch
  assembled and multiplied in turn;
- ``batched``: every patch assembled first (f32), then one batched
  product.

:func:`batched_dot` returns a form's int16 [n_blocks * R, B]: the kernel
(``csrc/probes/batched_dot.cu``: the m-loop a CTA per (period, 64-row
tile, ``lanes`` lanes) walking the phases through the served highest
body, ``fir::f32::fir_tile``; the batched form a pre-pass writing the
patches f32 [n_blocks, K, B] to device memory, then P6's nocvt tile over
(block, row tile, 128 lanes)) for CUDA tensors, the plain version
:func:`batched_dot_reference` (``tiled_fir.apply_weights``, scheme
highest: one float32 matmul, TF32 off) for CPU tensors.
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
from ..ops.convert import lsb_tie_limit
from ..parallel import batch as tb
from . import tc_rate as tr

__all__ = ["B", "H", "N_PERIODS", "FORMS", "LANES", "Geometry", "geometry",
           "weights", "launch_kw", "inputs", "batched_dot_reference",
           "batched_dot", "BatchedLaunch", "patches_reference",
           "library_call", "measure", "run", "launches"]

B = 2048
H = 128
N_PERIODS = 4
FORMS = ("m-loop", "batched")
#: the m-loop's lane tiles: the TPU probe's default (128) and half of it
LANES = (128, 64)

launches = 0


@dataclasses.dataclass(frozen=True)
class Geometry:
    """The experiment's module constants: weights f32 [P, K, R], the views'
    geometry (back, V) and the chunk's rows."""

    P: int
    K: int
    R: int
    S: int
    offsets: tuple
    back: int
    V: int
    n_in: int
    T_c: int
    w: np.ndarray


@functools.lru_cache(maxsize=1)
def geometry() -> Geometry:
    spec = fd.design_filter(147, 160, 7)
    ptw = ph.build_phase_tiled_weights(spec.phase_table, 147, 160, 0,
                                       origin_shift=H - (spec.filt_len - 1))
    back = tb._v3_back(ptw.S, H)
    V = tb._v3_views(ptw.S, ptw.K, H, ptw.offsets)
    return Geometry(P=ptw.P, K=ptw.K, R=ptw.R, S=ptw.S,
                    offsets=tuple(int(o) for o in ptw.offsets), back=back,
                    V=V, n_in=N_PERIODS * ptw.S,
                    T_c=(N_PERIODS - back + V) * ptw.S,
                    w=np.asarray(ptw.w, dtype=np.float32))


def weights(g: Geometry, device="cpu") -> tuple:
    """(w f32 [P, K, R], the 16-row sub-band table int32 [P, R / 16, 2]):
    the served highest weights (``tiled_fir.device_weights``)."""
    return tf.device_weights(g.w, "highest", device)


def launch_kw(g: Geometry, device="cpu", n_periods: int = N_PERIODS) -> dict:
    return dict(offsets=torch.tensor(g.offsets, dtype=torch.int32,
                                     device=device),
                S=g.S, n_blocks=n_periods * g.P)


def inputs(g: Geometry, B: int = B, seed: int = 0, device="cpu"):
    """The experiment's hist (zeros, [H, B]) and x ([T_c, B]: ``rng.integers(
    -32768, 32768, (n_in, B)) // 2`` from ``np.random.default_rng(seed)`` in
    the first n_in rows, zeros after)."""
    rng = np.random.default_rng(seed)
    x = np.zeros((g.T_c, B), dtype=np.int16)
    x[:g.n_in] = (rng.integers(-32768, 32768, size=(g.n_in, B)) // 2
                  ).astype(np.int16)
    hist = np.zeros((H, B), dtype=np.int16)
    return torch.from_numpy(hist).to(device), torch.from_numpy(x).to(device)


def _check(form, hist, x, w, offsets, S, n_blocks, lanes):
    if form not in FORMS:
        raise ValueError(f"form {form!r} not in {FORMS}")
    if lanes not in LANES:
        raise ValueError(f"lanes {lanes} not in {LANES}")
    return tf._check(hist, x, w, offsets, S, n_blocks, "highest", (), 1)


def batched_dot_reference(form: str, hist: torch.Tensor, x: torch.Tensor,
                          w: tuple, *, offsets: torch.Tensor, S: int,
                          n_blocks: int, lanes: int = 128) -> torch.Tensor:
    """The plain version (both forms compute one function), int16
    [n_blocks * R, B]: each block's patch of ``hist ++ x`` gathered (rows
    past it read as zero), one float32 matmul with TF32 off, WORD2INT."""
    P, K, R = _check(form, hist, x, w, offsets, S, n_blocks, lanes)
    k = torch.arange(n_blocks, device=x.device)
    v0 = (k // P) * S + offsets.long()[k % P]
    return tf.apply_weights(hist, x, w, v0, "highest", ())


class BatchedLaunch:
    """One form's launches on CUDA tensors: y int16 [n_blocks * R, B] and,
    for batched, the patches f32 [n_blocks, K, B]; ``run()`` launches on
    the current stream."""

    def __init__(self, form: str, hist: torch.Tensor, x: torch.Tensor,
                 w: tuple, *, offsets: torch.Tensor, S: int, n_blocks: int,
                 lanes: int = 128):
        P, K, R = _check(form, hist, x, w, offsets, S, n_blocks, lanes)
        if hist.shape[1] % 8 or (hist.data_ptr() | x.data_ptr()
                                 | w[0].data_ptr()) % 16:
            raise ValueError("B must be a multiple of 8 and hist, x and w "
                             "16-byte aligned")
        self.lib = _build.load_probes()
        self.form, self.lanes = form, lanes
        self.hist, self.x, self.w, self.offsets = hist, x, w, offsets
        self.S, self.n_blocks, self.P, self.K, self.R = S, n_blocks, P, K, R
        Bn = hist.shape[1]
        self.y = torch.empty((n_blocks * R, Bn), dtype=torch.int16,
                             device=x.device)
        self.patches = (torch.empty((n_blocks, K, Bn), dtype=torch.float32,
                                    device=x.device)
                        if form == "batched" else None)

    def _geo(self):
        return (self.hist.shape[0], self.x.shape[0], self.hist.shape[1])

    def run(self) -> torch.Tensor:
        global launches
        dev = self.x.device
        with torch.cuda.device(dev):
            err = self.lib.probe_batched_dot(
                self.hist.data_ptr(), self.x.data_ptr(), self.y.data_ptr(),
                self.offsets.data_ptr(), self.w[1].data_ptr(),
                self.w[0].data_ptr(),
                None if self.patches is None else self.patches.data_ptr(),
                FORMS.index(self.form), self.lanes, *self._geo(), self.R,
                self.K, self.P, self.S, self.n_blocks,
                _build.stream_handle(dev))
        if err:
            raise RuntimeError("batched_dot kernel launch failed: "
                               + self.lib.probe_error_string(err).decode())
        launches += 1
        return self.y

    def run_patches(self) -> torch.Tensor:
        """batched's pre-pass alone (the patches), on the current stream:
        the product's share of the launch is ``run()`` less it."""
        global launches
        if self.patches is None:
            raise ValueError("only the batched form has a pre-pass")
        dev = self.x.device
        with torch.cuda.device(dev):
            err = self.lib.probe_batched_patches(
                self.hist.data_ptr(), self.x.data_ptr(),
                self.patches.data_ptr(), self.offsets.data_ptr(),
                *self._geo(), self.K, self.P, self.S, self.n_blocks,
                _build.stream_handle(dev))
        if err:
            raise RuntimeError("batched_patch kernel launch failed: "
                               + self.lib.probe_error_string(err).decode())
        launches += 1
        return self.patches


def batched_dot(form: str, hist: torch.Tensor, x: torch.Tensor, w: tuple, *,
                offsets: torch.Tensor, S: int, n_blocks: int,
                lanes: int = 128) -> torch.Tensor:
    """The probe's function, int16 [n_blocks * R, B]: the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    kw = dict(offsets=offsets, S=S, n_blocks=n_blocks, lanes=lanes)
    if x.device.type == "cpu":
        return batched_dot_reference(form, hist, x, w, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return BatchedLaunch(form, hist, x, w, **kw).run()


def patches_reference(hist: torch.Tensor, x: torch.Tensor, K: int, *,
                      offsets: torch.Tensor, S: int,
                      n_blocks: int) -> torch.Tensor:
    """The batched form's patches, f32 [n_blocks, K, B]: block k's K rows
    of ``hist ++ x ++ zeros`` from its origin."""
    P = offsets.shape[0]
    k = torch.arange(n_blocks, device=x.device)
    v0 = (k // P) * S + offsets.long()[k % P]
    virt = torch.cat([hist, x, x.new_zeros((K, x.shape[1]))])
    return virt[v0[:, None] + torch.arange(K, device=x.device)].float()


def library_call(hist: torch.Tensor, x: torch.Tensor, w: tuple, *,
                 offsets: torch.Tensor, S: int, n_blocks: int):
    """The yardstick, as a function: the batched form's product as one
    float32 ``torch.bmm`` (TF32 off), [n_blocks, R, K] x [n_blocks, K, B],
    the patches gathered in device memory (no WORD2INT).  The port never
    calls it."""
    P, K = w[0].shape[0], w[0].shape[1]
    k = torch.arange(n_blocks, device=x.device)
    b = patches_reference(hist, x, K, offsets=offsets, S=S,
                          n_blocks=n_blocks).contiguous()
    a = w[0][k % P].transpose(1, 2).contiguous()

    def call():
        with tf._no_tf32():
            return torch.bmm(a, b)
    return call


def measure(form: str, lanes: int = 128, seed: int = 0) -> dict:
    """One form on the card: held against the plain version (max |err| <=
    1 within the tie bound) and against the m-loop at 128 lanes (bit for
    bit: both are one FMA chain in tap order), then ms a launch (median of
    5 groups of 20), and for batched the pre-pass alone."""
    t0 = time.perf_counter()
    g = geometry()
    hist, x = inputs(g, seed=seed, device="cuda")
    w, kw = weights(g, "cuda"), launch_kw(g, "cuda")
    bl = BatchedLaunch(form, hist, x, w, lanes=lanes, **kw)
    got = bl.run().clone()
    d = (got.int() - batched_dot_reference(form, hist, x, w, **kw)
         .int()).abs()
    err, mism = int(d.max()), int((d > 0).sum())
    if err > 1 or mism > lsb_tie_limit(d.numel()):
        raise AssertionError(f"batched_dot {form}: max |err| {err}, {mism} "
                             "mismatches")
    loop = BatchedLaunch("m-loop", hist, x, w, **kw).run()
    vs_loop = int((got != loop).sum())
    ms = tr.events_ms(lambda: [bl.run() for _ in range(20)]) / 20
    out = {"form": form, "lanes": lanes, "max_abs_err": err,
           "mismatches": mism, "vs_m_loop": vs_loop, "ms": ms,
           "out_per_s": kw["n_blocks"] * g.R * B / (ms * 1e-3)}
    if form == "batched":
        out["patches_ms"] = tr.events_ms(
            lambda: [bl.run_patches() for _ in range(20)]) / 20
        out["product_ms"] = ms - out["patches_ms"]
    return {**out, "seconds": time.perf_counter() - t0}


def run(log=print) -> dict:
    """The m-loop (lane tiles 128 and 64) and the batched form, as the
    experiment prints them: max |d| against the m-loop, ms a launch and G
    samples/s."""
    out = {"m-loop": measure("m-loop"), "m-loop lb64": measure("m-loop", 64),
           "batched": measure("batched")}
    for name, r in out.items():
        log(f"{name} lb={r['lanes']}: {r['ms']:.4f} ms/launch "
            f"{r['out_per_s'] / 1e9:.1f} Gsample/s (vs m-loop: "
            f"{r['vs_m_loop']} differ)"
            + (f"; pre-pass {r['patches_ms']:.4f}, product "
               f"{r['product_ms']:.4f} ms" if "patches_ms" in r else ""))
    return out
