"""Phase-tiled polyphase FIR weights: the device layouts, tap tables and
plain product shared by both phase-tiled geometries.

Counterpart of the v3 family in ``speex_resampler_tpu/ops/pallas_fir.py``
(``resample_conv_tm_pallas_v3``), schemes ``"highest"``, ``"int8"``,
``"fixed"`` (the Q15 universe, ``n_accum`` 1 or 4) and ``"split5"``.  The
launch itself, of either geometry, is ``ops/streamed_fir.resample_streamed``
(the kernels of ``csrc/streamed_fir.cu``, and the resident int8 kernel of
``csrc/tiled_fir.cu``).

Layout: time-major int16 ``[rows, B]`` with the lane axis minor, as in the
JAX package, so the same host slabs feed both.  Output block k (R rows)
reads K rows of the virtual axis ``hist ++ x`` from its origin ``v0[k]``
and applies the weights of block phase ``k % P`` (:func:`apply_weights`).

Device weights (built once per step, never per launch; see
:func:`device_weights`):

- ``"highest"``: ``(w f32[P, K, R], bands int32[P, R // SUB_ROWS, 2])``
- ``"int8"``: ``(planes int8[D, P, R, K_pad], bias f32[P, R], slices,
  taps)``: K-major and permuted as the fixed planes (below), ``slices``
  the most 32-tap K-slices a row tile's band spans (:func:`band_slices`,
  a host int), which the resident kernel needs; a step that launches the
  streamed kernel carries the tap table's :class:`BandWidths` in its place
  (``streamed_fir.int8_launch_weights``)
- ``"split5"``: ``(planes bf16[3, P, K, R], taps)``, the weights split as
  ``w_hi + w_mid + w_lo`` (:func:`split5_weights`)
- ``"fixed"``: ``(planes int8[2, P, C, K_pad], bias int32[P, C], coef
  int32[P, 4, R], bands, taps)`` for ``n_accum`` 4, ``(planes, bias,
  bands, taps)`` for ``n_accum`` 1; C = n_accum * R columns,
  accumulator-major (column ``c*R + r``); ``bands`` the K-slices of each
  row tile's band (:class:`BandWidths`, host ints), which the persistent
  fixed kernel needs; :func:`fixed_device_weights`

``w`` and the split5 planes keep the JAX package's ``[.., K, R]`` layout
(the TPU kernel transposed to ``[R, K]`` for the MXU; the CUDA kernels read
R-wide tap rows, which that layout already gives).  The int8 and fixed
planes are the int8 tensor cores' shared-memory operand
(``csrc/int8_wgmma.cuh``, ``csrc/fixed_wgmma.cuh``), which 8-bit wgmma
takes only K-major: int8[.., R or C, K_pad], ``K`` padded with zero taps
to ``K_pad``, a multiple of 32, and each 32-tap group permuted to the
kernels' fragment order: position ``32*i + k`` holds tap ``32*i +
K_PERM[k]`` (:func:`int8_k_major`; :func:`int8_n_major` and
:func:`fixed_taps16` map them back).  The int8 planes are the JAX
package's digit planes; the fixed planes its split of the int16 taps,
``w = 256*wh + wl0`` (``fixed_math.balanced_q15_split``), with its bias
``128 * sum_t w``: the four int8 dots of ``_dot_fixed``.  Both tap tables
are computed in tap order, before the permutation.  ``taps[m, i] = (lo,
hi)`` is the range of tap rows in which weight columns ``[i*ROW_TILE,
(i+1)*ROW_TILE)`` of phase m have a nonzero entry (in any of the
``n_accum`` components); the CUDA kernel skips the rest, which changes no
result (the skipped products are exact zeros).  The fixed table counts
``FIXED_ROWS[n_accum]`` columns a row (a fixed CTA's), ``"highest"``'s
``SUB_ROWS`` (16), ``bands``: its kernel (``csrc/f32_fir.cuh``) copies
the union of a row tile's four sub-bands and each warp multiplies only the
8-tap slices that meet its own 16 rows' band (:func:`f32_walk`).
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from ..utils.profiling import span
from . import int8_planes
from .convert import word2int
from .fixed_math import (balanced_q15_split, fixed_interp_mix_rows,
                         sat32pshr15)

__all__ = ["int8_weights", "int8_weights_auto", "split5_weights",
           "tap_ranges", "f32_walk", "SUB_ROWS", "K_SLICE", "K_PERM",
           "full_perm", "int8_k_major", "int8_n_major", "band_slices",
           "BandWidths", "band_widths",
           "FIXED_ROWS", "fixed_device_weights", "fixed_taps16",
           "device_weights", "check_launch", "apply_weights", "wrap_int32",
           "ROW_TILE"]

#: Output rows of one block handled by one CTA (``kRowTile`` in the CUDA
#: source); R must be a multiple of it.
ROW_TILE = 64

#: Rows of one sub-band of the "highest" table (``kSubRows``; one warp's
#: rows in ``csrc/f32_fir.cuh``), and the taps of the slices a warp
#: multiplies or skips (``kSlice``).
SUB_ROWS = 16
K_SLICE = 8

#: Tile rows of one fixed CTA, and of its tap table, by n_accum
#: (``fixedtc::Shape<n_accum>::kRows`` in ``csrc/fixed_wgmma.cuh``).
FIXED_ROWS = {1: 64, 4: 32}

#: The tap order of one 32-tap K-slice in the int8 tensor-core kernels' A
#: fragment (``csrc/int8_wgmma.cuh``, ``csrc/fixed_wgmma.cuh``): K position
#: ``4t + j`` (t < 4, j < 4) holds tap ``8*(j//2) + 2t + j%2``, position
#: ``16 + 4t + j`` tap 16 + that.  Two ``ldmatrix.trans`` of int16 rows
#: give a thread taps 2t, 2t+1 of one lane in each 8-tap block; a byte
#: permute packs blocks 0-1 (2-3).
K_PERM = np.array([16 * (k // 16) + 8 * (k % 4 // 2) + 2 * (k % 16 // 4)
                   + k % 2 for k in range(32)])


def full_perm(K: int) -> np.ndarray:
    """K_PERM applied to every 32-tap group of K positions."""
    k = np.arange(K)
    return k // 32 * 32 + K_PERM[k % 32]


def int8_k_major(planes: np.ndarray) -> torch.Tensor:
    """Host K-major int8[D, P, R, K] digit planes in tap order (K a
    multiple of 32) -> the int8 kernels' permuted planes, a contiguous
    CPU tensor: ``out[..., 32*i + k] = planes[..., 32*i + K_PERM[k]]``.
    One gather; ``planes`` may be a strided view."""
    return torch.from_numpy(np.ascontiguousarray(
        np.take(planes, full_perm(planes.shape[3]), axis=3)))


def int8_n_major(planes: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`int8_k_major` and the transpose: int8[D, P, R,
    K] K-major, permuted planes -> int8[D, P, K, R] in tap order."""
    inv = torch.from_numpy(np.argsort(full_perm(planes.shape[3])))
    return planes[..., inv.to(planes.device)].transpose(2, 3).contiguous()


def band_slices(taps: np.ndarray) -> int:
    """The most 32-tap K-slices any row tile's band spans, from its lo
    rounded down to 32 up to its hi (0 for an all-zero table): the band
    the resident int8 kernel (``csrc/int8_wgmma.cuh``) keeps in shared
    memory, which decides, when a tiled step is built, whether it or the
    streamed int8 kernel serves the step."""
    lo, hi = taps[..., 0] // 32 * 32, taps[..., 1]
    return int(np.where(hi > lo, -(-(hi - lo) // 32), 0).max(initial=0))


@dataclasses.dataclass(frozen=True, eq=False)
class BandWidths:
    """The 32-tap K-slices of each (phase, row tile) band of a fixed or
    int8 tap table (:func:`band_widths`), band-major, and the widest: what
    the persistent fixed and streamed int8 kernels (the ``fir_tiles`` of
    ``csrc/fixed_wgmma.cuh`` and ``csrc/int8_wgmma.cuh``) need to hold
    bands resident and to balance their CTAs' runs, carried in the device
    weights beside the table they were computed from.
    Compared and hashed by identity, so a launch's checks and its band
    count (cached per weights) make no pass over the widths."""
    slices: tuple
    widest: int = dataclasses.field(init=False)

    def __post_init__(self):
        if not self.slices or any(type(s) is not int or s < 1
                                  for s in self.slices):
            raise ValueError("band widths must be ints >= 1")
        object.__setattr__(self, "widest", max(self.slices))


def band_widths(taps: np.ndarray) -> BandWidths:
    """The 32-tap K-slices each row tile's band spans, from its lo rounded
    down to 32 up to its hi (1 where the entry is empty: the fixed
    kernels walk one K-slice of zero weights there), band-major: entry
    ``m * row_tiles + rt`` of ``taps[m, rt]``.  Computed once a step, with
    its tap table (:func:`fixed_device_weights`)."""
    lo, hi = taps[..., 0] // 32 * 32, taps[..., 1]
    return BandWidths(tuple(
        int(s) for s in np.where(hi > lo, -(-(hi - lo) // 32), 1).ravel()))


def int8_weights(w, digits: int = 3):
    """Host-side int8 digit-plane decomposition (ops/int8_planes.py) for
    the "int8" scheme: returns (planes int8[D, P, K, R], bias f32[P, R],
    scales tuple, err_bound).  Exactness is gated by the decomposition's
    rigorous certificate."""
    sw = {3: 23, 4: 31}.get(digits, 23)
    pl8 = int8_planes.decompose(np.asarray(w, dtype=np.float32), sw=sw,
                                digits=digits)
    return (pl8.planes, pl8.bias, tuple(float(s) for s in pl8.scales),
            float(pl8.err_bound))


def int8_weights_auto(w, gate: float):
    """Smallest digit count whose certificate clears ``gate`` (3 then 4);
    None if even 4 digits cannot."""
    for digits in (3, 4):
        planes = int8_weights(w, digits=digits)
        if planes[3] <= gate:
            return planes
    return None


def split5_weights(w) -> torch.Tensor:
    """The split5 scheme's 3-term bf16 split of f32 weights (the JAX
    package's ``pallas_fir.split5_weights``): ``w_hi = bf16(w)``, ``w_mid =
    bf16(w - w_hi)``, ``w_lo = bf16(w - w_hi - w_mid)``, each rounded to
    nearest even, the differences in f32.  w: f32[...]; returns a CPU
    tensor bf16[3, ...]."""
    w = torch.as_tensor(np.asarray(w, dtype=np.float32))
    hi = w.to(torch.bfloat16)
    mid = (w - hi.float()).to(torch.bfloat16)
    lo = (w - hi.float() - mid.float()).to(torch.bfloat16)
    return torch.stack([hi, mid, lo])


def tap_ranges(nonzero: np.ndarray, rows: int = ROW_TILE) -> np.ndarray:
    """``nonzero``: bool[P, K, R] -> int32[P, R // rows, 2], the [lo, hi)
    tap rows holding a nonzero weight in each group of ``rows`` weight
    columns (0, 0 for an all-zero group)."""
    P, K, R = nonzero.shape
    assert R % rows == 0, R
    groups = nonzero.reshape(P, K, R // rows, rows).any(axis=3)
    out = np.zeros((P, R // rows, 2), dtype=np.int32)
    for m in range(P):
        for i in range(R // rows):
            taps = np.flatnonzero(groups[m, :, i])
            if taps.size:
                out[m, i] = taps[0], taps[-1] + 1
    return out


def f32_walk(bands: np.ndarray) -> np.ndarray:
    """``bands``: the "highest" table int32[P, R // SUB_ROWS, 2] ->
    int64[P, R // SUB_ROWS], the tap rows each sub-band's warp multiplies
    in ``csrc/f32_fir.cuh``: the ``K_SLICE``-tap slices, counted from its
    row tile's band start (the least lo of the tile's non-empty
    sub-bands), that meet its own [lo, hi); 0 for an empty sub-band."""
    P, n, _ = bands.shape
    per = ROW_TILE // SUB_ROWS
    b = bands.reshape(P, n // per, per, 2).astype(np.int64)
    lo, hi = b[..., 0], b[..., 1]
    full = hi > lo
    start = np.where(full, lo, np.iinfo(np.int64).max).min(axis=2,
                                                           keepdims=True)
    first = (lo - start) // K_SLICE
    last = -(-(hi - start) // K_SLICE)
    return np.where(full, (last - first) * K_SLICE, 0).reshape(P, n)


def fixed_device_weights(w, device) -> tuple:
    """The fixed scheme's host weights ``(w int16[P, K, C],)`` or ``(w,
    coef int32[P, 4, R])`` (``n_accum`` 1 or 4) -> its device weights
    ``(planes int8[2, P, C, K_pad], bias int32[P, C], [coef,] bands,
    taps)`` (module docstring): K padded with zero taps to a multiple of
    32, each phase split by ``balanced_q15_split`` (the JAX package's
    ``fixed_weight_planes_tiled`` split) in the permuted tap order, which
    changes no sum; the tap table over ``FIXED_ROWS[n_accum]`` columns and
    its :func:`band_widths`.  The split, the tap table and its widths,
    host work of the fixed universe alone, are the span
    ``speex.setup.q15``; the copies to ``device`` are not."""
    w16, *coef = (np.asarray(a) for a in w)
    assert w16.dtype == np.int16 and len(coef) <= 1
    P, K, C = w16.shape
    n_accum = 4 if coef else 1
    K_pad = -(-K // 32) * 32
    perm = full_perm(K_pad)
    with span("speex.setup.q15"):
        planes = np.empty((2, P, C, K_pad), dtype=np.int8)
        bias = np.empty((P, C), dtype=np.int32)
        wm = np.zeros((K_pad, C), dtype=np.int16)
        for m in range(P):      # a phase at a time: 77 MB of taps at q10
            wm[:K] = w16[m]
            wh, wl0, bias[m] = balanced_q15_split(wm[perm], tap_axis=0)
            planes[0, m], planes[1, m] = wh.T, wl0.T
        nonzero = (w16.reshape(P, K, n_accum, C // n_accum) != 0).any(axis=2)
        nonzero = np.pad(nonzero, ((0, 0), (0, K_pad - K), (0, 0)))
        taps = tap_ranges(nonzero, FIXED_ROWS[n_accum])
        bands = band_widths(taps)
    return (torch.from_numpy(planes).to(device),
            torch.from_numpy(bias).to(device),
            *(torch.from_numpy(c.astype(np.int32)).to(device) for c in coef),
            bands, torch.from_numpy(taps).to(device))


def fixed_taps16(planes: torch.Tensor) -> torch.Tensor:
    """The fixed device planes int8[2, P, C, K] -> the int16 taps
    ``256*wh + wl0``, int16[P, K, C] in tap order (the inverse of
    :func:`fixed_device_weights`' layout), on the planes' device."""
    inv = torch.from_numpy(np.argsort(full_perm(planes.shape[3])))
    w = planes[0].to(torch.int16) * 256 + planes[1].to(torch.int16)
    return w[..., inv.to(planes.device)].transpose(1, 2).contiguous()


def device_weights(w, scheme: str, device, *, k_major: bool = False
                   ) -> tuple:
    """Host weights -> the kernel's device weights (see module docstring).
    ``w``: f32[P, K, R] for "highest", ``(planes int8[D, P, K, R], bias)``
    for "int8" (K-major here, K padded to a multiple of 32; with
    ``k_major`` the planes come as int8[D, P, R, K]),
    ``(w int16[P, K, C],)`` or ``(w, coef int32[P, 4, R])`` for "fixed"
    (``n_accum`` 1 or 4; :func:`fixed_device_weights`), the bf16[3, P, K,
    R] tensor of :func:`split5_weights` for "split5"."""
    if scheme == "highest":
        w = np.asarray(w, dtype=np.float32)
        return (torch.from_numpy(w.copy()).to(device),
                torch.from_numpy(tap_ranges(w != 0, SUB_ROWS)).to(device))
    if scheme == "int8":
        planes, bias = (np.asarray(a) for a in w)
        assert planes.dtype == np.int8 and bias.dtype == np.float32
        if not k_major:
            planes = planes.transpose(0, 1, 3, 2)
        taps = tap_ranges((planes != 0).any(axis=0).transpose(0, 2, 1))
        kmaj = np.pad(planes, ((0, 0),) * 3 + ((0, -planes.shape[3] % 32),))
        return (int8_k_major(kmaj).to(device),
                torch.from_numpy(bias.copy()).to(device), band_slices(taps),
                torch.from_numpy(taps).to(device))
    if scheme == "fixed":
        return fixed_device_weights(w, device)
    if scheme == "split5":
        planes = torch.as_tensor(w)
        assert planes.dtype == torch.bfloat16 and planes.shape[0] == 3
        nonzero = (planes != 0).any(dim=0).numpy()
        return (planes.contiguous().to(device),
                torch.from_numpy(tap_ranges(nonzero)).to(device))
    raise ValueError(f"unknown scheme {scheme!r}")


def check_launch(hist, x, w, scheme, scales, n_accum=1, extra=()):
    """Validate one launch's buffers and device weights (``extra``: more
    tensors that must share x's device and be contiguous; the int8 and
    fixed planes are K-major, K a multiple of 32, and they and their bias
    16-byte aligned); returns (P, K, R)."""
    if scheme not in ("highest", "int8", "fixed", "split5"):
        raise ValueError(f"unknown scheme {scheme!r}")
    if n_accum != 1 and (scheme != "fixed" or n_accum != 4):
        raise ValueError(f"n_accum {n_accum} under scheme {scheme!r}")
    for t in (hist, *extra, *(t for t in w if isinstance(t, torch.Tensor))):
        if t.device != x.device:
            raise ValueError(f"tensor on {t.device}, expected {x.device}")
        if not t.is_contiguous():
            raise ValueError("tensors must be contiguous")
    if hist.dtype != torch.int16 or x.dtype != torch.int16:
        raise TypeError("hist and x must be int16")
    if hist.ndim != 2 or x.ndim != 2 or hist.shape[1] != x.shape[1]:
        raise ValueError(f"hist {tuple(hist.shape)} / x {tuple(x.shape)}")
    if scheme == "highest":
        wt, taps = w
        if wt.dtype != torch.float32 or wt.ndim != 3:
            raise TypeError("highest weights must be f32[P, K, R]")
        P, K, R = wt.shape
    elif scheme == "split5":
        planes, taps = w
        if planes.dtype != torch.bfloat16 or planes.ndim != 4 \
                or planes.shape[0] != 3:
            raise TypeError("split5 planes must be bf16[3, P, K, R]")
        _, P, K, R = planes.shape
    elif scheme == "fixed":
        if len(w) != (5 if n_accum == 4 else 4) or scales:
            raise ValueError(f"{len(w)} fixed weights, scales {scales} for "
                             f"n_accum {n_accum}")
        planes, bias, taps = w[0], w[1], w[-1]
        if planes.dtype != torch.int8 or planes.ndim != 4 \
                or planes.shape[0] != 2 or planes.shape[2] % n_accum:
            raise TypeError("fixed planes must be int8[2, P, n_accum * R, K]")
        _, P, C, K = planes.shape
        R = C // n_accum
        if tuple(bias.shape) != (P, C) or bias.dtype != torch.int32:
            raise TypeError("fixed bias must be int32[P, n_accum * R]")
        if n_accum == 4 and (tuple(w[2].shape) != (P, 4, R)
                             or w[2].dtype != torch.int32):
            raise TypeError("fixed coefficients must be int32[P, 4, R]")
    else:
        planes, bias, taps = w[0], w[1], w[-1]
        if planes.dtype != torch.int8 or planes.ndim != 4:
            raise TypeError("int8 planes must be int8[D, P, R, K]")
        D, P, R, K = planes.shape
        if tuple(bias.shape) != (P, R) or bias.dtype != torch.float32:
            raise TypeError("int8 bias must be f32[P, R]")
        if len(scales) != D or not 1 <= D <= 4:
            raise ValueError(f"{len(scales)} scales for {D} digit planes")
    if scheme in ("int8", "fixed"):
        if K % 32:
            raise ValueError(f"K {K} of the {scheme} planes is not a "
                             "multiple of 32")
        if (planes.data_ptr() | bias.data_ptr()) % 16:
            raise ValueError(f"{scheme} planes and bias must be 16-byte "
                             "aligned")
    if scheme in ("highest", "split5") and scales:
        raise ValueError(f"scales {scales} under scheme {scheme!r}")
    rows = (SUB_ROWS if scheme == "highest" else
            FIXED_ROWS[n_accum] if scheme == "fixed" else ROW_TILE)
    if R % ROW_TILE or tuple(taps.shape) != (P, R // rows, 2) \
            or taps.dtype != torch.int32:
        raise ValueError(f"taps {tuple(taps.shape)} {taps.dtype} for "
                         f"R = {R} under scheme {scheme!r}")
    if scheme == "fixed" and (type(w[-2]) is not BandWidths
                              or len(w[-2].slices) != P * (R // rows)
                              or w[-2].widest > K // 32):
        raise ValueError("fixed weights must carry their tap table's "
                         "BandWidths, each band in [1, K / 32] K-slices")
    return P, K, R


@contextlib.contextmanager
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def wrap_int32(v: torch.Tensor) -> torch.Tensor:
    """An exact integer-valued tensor (float64 or int64) -> int32, wrapped
    mod 2^32 as a two's-complement int32 accumulator wraps."""
    v = v.to(torch.int64) & 0xFFFFFFFF
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def apply_weights(hist: torch.Tensor, x: torch.Tensor, w: tuple,
                  v0: torch.Tensor, scheme: str, scales: tuple,
                  n_accum: int = 1) -> torch.Tensor:
    """Plain product of one launch (the phase-tiled kernels' plain
    version, ``streamed_fir.resample_streamed_reference``): block k reads
    K rows of the virtual axis ``hist ++ x ++ zeros`` from origin ``v0[k]``
    (each block's patch gathered with an index tensor) and applies the
    weights of phase ``k % P`` in one batched product over all blocks;
    int16[n_blocks * R, B].  ``w``: the device weights, the int8 planes
    back in tap order, ``(int8_n_major(planes), bias)``.

    "highest": f32 matmul with TF32 off, then WORD2INT.  "split5": the
    five f32 matmuls (TF32 off) of bf16-valued operands of the JAX
    package's ``_dot_scheme``, w_hi*x_hi + w_hi*x_lo + w_mid*x_hi +
    w_mid*x_lo + w_lo*x_hi summed in that order (x_hi = bf16(x), x_lo = x -
    x_hi, both exact), then WORD2INT.  "int8": each digit's integer dot
    ``sum w_d * (x - 128)`` in float64 (the taps past K are zero), exact
    because its magnitude stays below 2^31 (the certificate refuses planes
    where it would not), converted to int32, then the kernel's f32
    epilogue in the same order.  "fixed": the int16 taps rebuilt from the
    planes (:func:`fixed_taps16`; the bias is the kernel's alone), then the
    int16 x int16 dot of every weight column in float64, exact (each
    product is at most 2^30 and every partial sum an integer below 2^40,
    so any order gives the same number), wrapped to int32 as the C
    accumulator wraps, then the Q15 epilogue in int32 (ops/fixed_math:
    SATURATE32PSHR for n_accum 1, the MULT16_32_Q15 cubic mix of the 4
    accumulators for n_accum 4)."""
    if scheme == "fixed":
        w = (fixed_taps16(w[0]), *w[2:-2])       # int16[P, K, C], coef
    P, K, R = w[0].shape[-3:]     # [P, K, R], [D|3, P, K, R] or [P, K, C]
    R //= n_accum
    n_blocks, B = v0.shape[0], hist.shape[1]
    dev = x.device
    phase = torch.arange(n_blocks, device=dev) % P
    idx = v0[:, None] + torch.arange(K, device=dev)[None, :]   # [nb, K]
    virt = torch.cat([hist, x, x.new_zeros((K, B))])
    idx = idx.clamp(max=virt.shape[0] - 1)                   # zero rows
    patch = virt[idx]                                          # [nb, K, B]
    if scheme == "highest":
        with _no_tf32():
            y = torch.matmul(w[0][phase].transpose(1, 2), patch.float())
    elif scheme == "split5":
        xf = patch.float()
        xh = xf.to(torch.bfloat16).float()
        xl = (xf - xh).to(torch.bfloat16).float()
        wp = [w[0][p][phase].float().transpose(1, 2) for p in range(3)]
        with _no_tf32():
            y = (torch.matmul(wp[0], xh) + torch.matmul(wp[0], xl)
                 + torch.matmul(wp[1], xh) + torch.matmul(wp[1], xl)
                 + torch.matmul(wp[2], xh))
    elif scheme == "fixed":
        acc = wrap_int32(torch.matmul(w[0][phase].double().transpose(1, 2),
                                      patch.double()))        # [nb, C, B]
        if n_accum == 1:
            return sat32pshr15(acc).reshape(n_blocks * R, B)
        return fixed_interp_mix_rows(acc.view(n_blocks, 4, R, B),
                                     w[1][phase]).reshape(n_blocks * R, B)
    else:
        planes, bias = w[0], w[1]
        xs = patch.double() - 128.0
        acc = torch.zeros((n_blocks, R, B), dtype=torch.float32, device=dev)
        for d, s in enumerate(scales):
            dot = torch.matmul(planes[d][phase].double().transpose(1, 2), xs)
            acc = acc + dot.to(torch.int32).float() * s
        y = acc + bias[phase][:, :, None]
    return word2int(y).reshape(n_blocks * R, B)
