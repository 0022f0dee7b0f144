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
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build
from . import tiled_fir as tf
from .convert import word2int
from .fir_matmul import dense_patches

__all__ = ["device_weights", "resample_dense", "resample_dense_reference"]

#: The library whose tile sizes this module has checked (once per library).
_checked = None

#: Launches of the CUDA kernel in this process; only resample_dense adds to
#: it, once per launch.  Callers reset the count to count one run.
launches = {"highest": 0}


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
