"""Dense padded-weight FIR launch: the kernel of the dense geometry.

Counterpart of ``resample_conv_tm_pallas`` / ``_kernel`` in
``speex_resampler_tpu/ops/pallas_fir.py`` (K3, f32 ``HIGHEST``).  The dense
geometry serves launch quanta below one tiled or streamed unit, such as the
voip preset's hard 20 ms cap: super-blocks of R = group*den outputs, each
consuming stride = group*num inputs, all with the same weights.

Output block b, row r is

    y[b*R + r] = WORD2INT( sum_{l < L_pad} W[l, r] * X[b*stride + l] ),

where X is the virtual axis ``hist ++ x ++ zeros`` (the concatenation the
JAX step builds before its launch) and W the padded phase weights
(``ops/phase.build_padded_weights``, zero rows up to L_pad, a multiple of
stride).  R is any width (160, 96, 129 at the voip configs).

Device weights (:func:`device_weights`): ``(w f32[L_pad, R_pad], bands
int32[1, R_pad // SUB_ROWS, 2])``, W padded with zero columns to ``R_pad =
round_up(R, ROW_TILE)``, as the kernel's 64-row tiles read it;
``bands[0, i]`` is the [lo, hi) range of tap rows holding a nonzero weight
in columns ``[i*SUB_ROWS, (i+1)*SUB_ROWS)`` (the "highest" table of
``tiled_fir``).  The CUDA kernel (``csrc/f32_fir.cuh``) walks only those
ranges: the skipped products are exact zeros, so no sum changes; nor do
the zero columns, whose rows are not stored.  A launch names R itself.

:func:`resample_dense` launches the CUDA kernel (``csrc/dense_fir.cu``) for
CUDA tensors and runs :func:`resample_dense_reference`, its plain PyTorch
version, for CPU tensors.  It never falls back from one to the other.

The fixed-point (Q15) dense launch, :func:`resample_dense_fixed`, is the
JAX package's ``fm.resample_conv_tm_fixed`` (an XLA program there, outside
Pallas) as ``dense_fir_fixed_kernel<n_accum>``: ``csrc/fixed_wgmma.cuh``'s
int8 tensor-core tile, the tiled and streamed fixed kernels', under this
geometry's launcher (one phase, block origin b*stride, rows of hist ++ x
++ zeros).  Its device weights (:func:`device_weights_fixed`) are a
:class:`FixedDenseWeights` (direct filter, n_accum 1) or a
:class:`FixedDenseInterpWeights` (n_accum 4), read by field name:

    w16      int16[L_pad, C]                  the plain version's taps
    coef     int32[4, R] (n_accum 4)          the plain version's mix
    planes   int8[2, 1, n_accum * R_pad, K_pad]  the kernel's
    bias     int32[1, n_accum * R_pad]
    coef_pad int32[1, 4, R_pad] (n_accum 4)
    taps     int32[1, R_pad / rows, 2]

``w16`` and ``coef`` are the dense fixed weights as ``ops/fir_matmul``
takes them (C = n_accum * R columns, accumulator-major); the kernel reads
the rest: each column set padded with zero columns to R_pad, a multiple of
the fixed CTA's rows (``tiled_fir.FIXED_ROWS[n_accum]``), K padded to
K_pad, a multiple of 32, and split and permuted by
``tiled_fir.fixed_device_weights``.  Its plain version,
:func:`resample_dense_fixed_reference`, is ``fm.resample_conv_tm_fixed``
on the concatenated axis, bit for bit the kernel's function.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.profiling import span
from . import _build
from . import tiled_fir as tf
from .convert import word2int
from .fir_matmul import dense_patches, resample_conv_tm_fixed

__all__ = ["device_weights", "resample_dense", "resample_dense_reference",
           "FixedDenseWeights", "FixedDenseInterpWeights",
           "device_weights_fixed", "resample_dense_fixed",
           "resample_dense_fixed_reference"]

#: The library whose tile sizes this module has checked (once per library).
_checked = None

#: Launches of the CUDA kernels in this process, by scheme; only
#: resample_dense and resample_dense_fixed add to it, once per launch.
#: Callers reset the counts to count one run.
launches = {"highest": 0, "fixed": 0}


def device_weights(w_np, device) -> tuple:
    """Host f32[L_pad, R] padded weights -> ``(w f32[L_pad, R_pad],
    bands)`` on ``device`` (module docstring)."""
    w = np.asarray(w_np, dtype=np.float32)
    L, R = w.shape
    w = np.pad(w, ((0, 0), (0, -(-R // tf.ROW_TILE) * tf.ROW_TILE - R)))
    bands = tf.tap_ranges((w != 0)[None], tf.SUB_ROWS)
    return (torch.from_numpy(w).to(device),
            torch.from_numpy(bands).to(device))


def _check(hist, x, w, stride, n_blocks, R):
    wt, taps = w
    for t in (hist, wt, taps):
        if t.device != x.device:
            raise ValueError(f"tensor on {t.device}, expected {x.device}")
    for t in (hist, x, wt, taps):
        if not t.is_contiguous():
            raise ValueError("tensors must be contiguous")
    if hist.dtype != torch.int16 or x.dtype != torch.int16:
        raise TypeError("hist and x must be int16")
    if hist.ndim != 2 or x.ndim != 2 or hist.shape[1] != x.shape[1]:
        raise ValueError(f"hist {tuple(hist.shape)} / x {tuple(x.shape)}")
    if wt.dtype != torch.float32 or wt.ndim != 2:
        raise TypeError("dense weights must be f32[L_pad, R_pad]")
    L, R_pad = wt.shape
    if stride <= 0 or L % stride or n_blocks <= 0:
        raise ValueError(f"L_pad {L}, stride {stride}, n_blocks {n_blocks}")
    if R <= 0 or R_pad != -(-R // tf.ROW_TILE) * tf.ROW_TILE:
        raise ValueError(f"weights of {R_pad} columns for R = {R}")
    if taps.dtype != torch.int32 or tuple(taps.shape) != (
            1, R_pad // tf.SUB_ROWS, 2):
        raise ValueError(f"taps {tuple(taps.shape)} for R_pad = {R_pad}")
    return L, R_pad


def _library():
    """The kernels' library, its tile sizes checked against this module's
    the first time it is seen (``_build.use_csrc`` may load another)."""
    global _checked
    lib = _build.load()
    if lib is not _checked:
        if lib.dense_fir_row_tile() != tf.ROW_TILE \
                or lib.f32_fir_sub_rows() != tf.SUB_ROWS:
            raise RuntimeError("csrc/dense_fir.cu tile sizes disagree with "
                               "ROW_TILE / SUB_ROWS")
        _checked = lib
    return lib


@span("speex.kernel.dense")
def resample_dense(hist: torch.Tensor, x: torch.Tensor, w: tuple, *,
                   stride: int, n_blocks: int, R: int) -> torch.Tensor:
    """One launch: int16[n_blocks * R, B].

    hist: int16[H, B] trailing history (H = filt_len - 1 in the engine)
    x:    int16[T, B] chunk; rows of the virtual axis at or past H + T read
          as zero
    w:    device weights (module docstring), R_pad = round_up(R, ROW_TILE)
          columns

    CUDA tensors launch the kernel on the current stream (asynchronously; a
    launch error raises); CPU tensors run the plain version."""
    L, R_pad = _check(hist, x, w, stride, n_blocks, R)
    if x.device.type == "cpu":
        return resample_dense_reference(hist, x, w, stride=stride,
                                        n_blocks=n_blocks, R=R)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    lib = _library()
    H, B = hist.shape
    y = torch.empty((n_blocks * R, B), dtype=torch.int16, device=x.device)
    with torch.cuda.device(x.device):
        stream = _build.stream_handle(x.device)
        err = lib.dense_fir_f32(hist.data_ptr(), x.data_ptr(), y.data_ptr(),
                                w[1].data_ptr(), w[0].data_ptr(), H,
                                x.shape[0], B, R_pad, L, stride, n_blocks, R,
                                stream)
    if err:
        raise RuntimeError("dense FIR kernel launch failed: "
                           + lib.dense_fir_error_string(err).decode())
    launches["highest"] += 1
    return y


def resample_dense_reference(hist: torch.Tensor, x: torch.Tensor, w: tuple,
                             *, stride: int, n_blocks: int,
                             R: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`resample_dense` (same contract), on
    the tensors' own device: the twin of the JAX package's
    ``fm.resample_conv_tm``, one f32 matmul (TF32 off) of W^T (its first R
    columns) against every block's patch, then WORD2INT."""
    L, _ = _check(hist, x, w, stride, n_blocks, R)
    B = hist.shape[1]
    rows = (n_blocks + L // stride) * stride
    virt = torch.cat([hist, x])[:rows]
    if virt.shape[0] < rows:
        virt = torch.cat([virt, virt.new_zeros((rows - virt.shape[0], B))])
    patches = dense_patches(virt, L, stride)               # [nb, L, B]
    with tf._no_tf32():
        y = torch.matmul(w[0][:, :R].t(), patches.float())  # [nb, R, B]
    return word2int(y).reshape(n_blocks * R, B)


class FixedDenseWeights(NamedTuple):
    """A direct filter's (n_accum 1) fixed dense device weights (module
    docstring); ``coef`` and ``coef_pad`` are None."""
    w16: torch.Tensor
    planes: torch.Tensor
    bias: torch.Tensor
    taps: torch.Tensor
    coef = None
    coef_pad = None


class FixedDenseInterpWeights(NamedTuple):
    """An interpolated filter's (n_accum 4) fixed dense device weights
    (module docstring)."""
    w16: torch.Tensor
    coef: torch.Tensor
    planes: torch.Tensor
    bias: torch.Tensor
    coef_pad: torch.Tensor
    taps: torch.Tensor


def device_weights_fixed(w16, coef, device):
    """Host int16[L_pad, C] dense fixed taps (C = n_accum * R,
    accumulator-major) and, for n_accum 4, the Q15 coefficients int32[4,
    R] -> the fixed dense step's device weights on ``device``, a
    :class:`FixedDenseWeights` or :class:`FixedDenseInterpWeights`."""
    w16 = np.asarray(w16, dtype=np.int16)
    L, C = w16.shape
    n_accum = 1 if coef is None else 4
    R = C // n_accum
    R_pad = -(-R // tf.FIXED_ROWS[n_accum]) * tf.FIXED_ROWS[n_accum]
    wp = np.pad(w16.reshape(L, n_accum, R),
                ((0, 0), (0, 0), (0, R_pad - R))).reshape(1, L, -1)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    if coef is None:
        planes, bias, _, taps = tf.fixed_device_weights((wp,), device)
        return FixedDenseWeights(dev(w16), planes, bias, taps)
    coef = np.ascontiguousarray(coef, dtype=np.int32)
    planes, bias, coef_pad, _, taps = tf.fixed_device_weights(
        (wp, np.pad(coef, ((0, 0), (0, R_pad - R)))[None]), device)
    return FixedDenseInterpWeights(dev(w16), dev(coef), planes, bias,
                                   coef_pad, taps)


def _fixed_weights(w: tuple, n_accum: int):
    """``w`` (any tuple of the layout) as its n_accum's named tuple."""
    form = FixedDenseInterpWeights if n_accum == 4 else FixedDenseWeights
    if n_accum not in (1, 4) or len(w) != len(form._fields):
        raise ValueError(f"{len(w)} fixed dense weights for n_accum "
                         f"{n_accum}")
    return form(*w)


def _check_fixed(hist, x, w, stride, n_blocks, R, n_accum):
    """Validate one fixed dense launch; returns (w as its named tuple,
    R_pad, K_pad)."""
    w = _fixed_weights(w, n_accum)
    for t in (hist, *w):
        if t.device != x.device:
            raise ValueError(f"tensor on {t.device}, expected {x.device}")
    for t in (hist, x, *w):
        if not t.is_contiguous():
            raise ValueError("tensors must be contiguous")
    if hist.dtype != torch.int16 or x.dtype != torch.int16:
        raise TypeError("hist and x must be int16")
    if hist.ndim != 2 or x.ndim != 2 or hist.shape[1] != x.shape[1]:
        raise ValueError(f"hist {tuple(hist.shape)} / x {tuple(x.shape)}")
    w16, planes, bias, coef, taps = w.w16, w.planes, w.bias, w.coef_pad, \
        w.taps
    L, C = w16.shape
    if w16.dtype != torch.int16 or C != n_accum * R:
        raise TypeError(f"taps {w16.dtype} {tuple(w16.shape)} for R = {R}")
    if stride <= 0 or L % stride or n_blocks <= 0:
        raise ValueError(f"L_pad {L}, stride {stride}, n_blocks {n_blocks}")
    rows = tf.FIXED_ROWS[n_accum]
    R_pad = -(-R // rows) * rows
    K = -(-L // 32) * 32
    if planes.dtype != torch.int8 or tuple(planes.shape) != (
            2, 1, n_accum * R_pad, K):
        raise ValueError(f"planes {planes.dtype} {tuple(planes.shape)}")
    if bias.dtype != torch.int32 or tuple(bias.shape) != (1, n_accum * R_pad):
        raise ValueError(f"bias {bias.dtype} {tuple(bias.shape)}")
    if n_accum == 4 and (coef.dtype != torch.int32
                         or tuple(coef.shape) != (1, 4, R_pad)):
        raise ValueError(f"coef {tuple(coef.shape)} for R_pad = {R_pad}")
    if taps.dtype != torch.int32 or tuple(taps.shape) != (
            1, R_pad // rows, 2):
        raise ValueError(f"taps {tuple(taps.shape)} for R_pad = {R_pad}")
    return w, R_pad, K


@span("speex.kernel.dense")
def resample_dense_fixed(hist: torch.Tensor, x: torch.Tensor, w: tuple, *,
                         stride: int, n_blocks: int, R: int,
                         n_accum: int) -> torch.Tensor:
    """One fixed-point launch: int16[n_blocks * R, B], bit-exact.

    hist: int16[H, B] trailing history (H = filt_len - 1 in the engine)
    x:    int16[T, B] chunk; rows of the virtual axis at or past H + T read
          as zero
    w:    :func:`device_weights_fixed` (module docstring)

    CUDA tensors launch ``dense_fir_fixed_kernel<n_accum>`` on the current
    stream (asynchronously; a launch error raises); CPU tensors run the
    plain version."""
    w, R_pad, K = _check_fixed(hist, x, w, stride, n_blocks, R, n_accum)
    if x.device.type == "cpu":
        return resample_dense_fixed_reference(
            hist, x, w, stride=stride, n_blocks=n_blocks, R=R,
            n_accum=n_accum)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    lib = _library()
    if lib.fixed_fir_rows(n_accum) != tf.FIXED_ROWS[n_accum]:
        raise RuntimeError("csrc/fixed_wgmma.cuh rows disagree with "
                           "FIXED_ROWS")
    H, B = hist.shape
    y = torch.empty((n_blocks * R, B), dtype=torch.int16, device=x.device)
    with torch.cuda.device(x.device):
        stream = _build.stream_handle(x.device)
        err = lib.dense_fir_fixed(hist.data_ptr(), x.data_ptr(), y.data_ptr(),
                                  w.taps.data_ptr(), w.planes.data_ptr(),
                                  w.bias.data_ptr(),
                                  None if w.coef_pad is None
                                  else w.coef_pad.data_ptr(),
                                  n_accum, H,
                                  x.shape[0], B, R_pad, K, stride, n_blocks,
                                  R, stream)
    if err:
        raise RuntimeError("fixed dense FIR kernel launch failed: "
                           + lib.dense_fir_error_string(err).decode())
    launches["fixed"] += 1
    return y


def resample_dense_fixed_reference(hist: torch.Tensor, x: torch.Tensor,
                                   w: tuple, *, stride: int, n_blocks: int,
                                   R: int, n_accum: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`resample_dense_fixed` (same
    contract), on the tensors' own device: ``fm.resample_conv_tm_fixed``
    (exact float64 products wrapped to int32, then the Q15 epilogue) of
    the int16 taps on the concatenation hist ++ x ++ zeros."""
    w = _check_fixed(hist, x, w, stride, n_blocks, R, n_accum)[0]
    L, B = w.w16.shape[0], hist.shape[1]
    rows = (n_blocks + L // stride) * stride
    virt = torch.cat([hist, x])[:rows]
    if virt.shape[0] < rows:
        virt = torch.cat([virt, virt.new_zeros((rows - virt.shape[0], B))])
    return resample_conv_tm_fixed(
        virt, (w.w16,) if w.coef is None else (w.w16, w.coef),
        stride=stride, n_accum=n_accum)
