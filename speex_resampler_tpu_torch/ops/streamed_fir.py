"""Streamed-weight polyphase FIR launch: the kernel of the large-P configs.

Counterpart of ``resample_conv_tm_pallas_v4`` in
``speex_resampler_tpu/ops/pallas_fir.py``, schemes ``"highest"``, ``"int8"``,
``"fixed"`` (``n_accum`` 1 or 4) and ``"split5"``.  It serves the geometries whose
phase-tiled weight cycle is too large for the tiled kernel: every
48 kHz -> 44.1 kHz conversion (P = 147), 44.1 kHz -> 16 kHz at q7 (P = 20),
and, in the fixed universe, those whose int16 column sets pass the 6 MB
fixed tiled cap (44.1 kHz -> 48 kHz q10).

Output block k (R rows) reads K rows of the virtual axis ``hist ++ x`` from
the closed-form origin of ``_kernel_v4``

    v0(k) = floor16((f0 + k*R*num) // den + shift)

and applies the weights of block phase ``k % P``.  ``shift`` is
``H - (filt_len - 1)``; ``v0`` equals the tiled kernel's
``(k // P) * S + offsets[k % P]``, so no offset table is needed.

Device weights (:func:`device_weights_streamed`), padded to ``K_pad`` (a
multiple of 128) tap rows as the JAX package pads them, keep the tiled
kernel's layout but for "int8":

- ``"highest"``: ``(w f32[P, K_pad, R], bands int32[P, R // SUB_ROWS, 2])``
- ``"int8"``: ``(planes int8[D, P, R, K_pad], bias f32[P, R], taps)``:
  K-major, as the int8 tensor cores read them (``csrc/int8_wgmma.cuh``),
  each 32-tap group in the fragment's tap order: position ``32*i + k``
  holds tap ``32*i + K_PERM[k]`` (``tiled_fir.int8_k_major``,
  ``tiled_fir.int8_n_major``; the tiled planes' layout, without their
  ``slices``)
- ``"fixed"``: ``(planes int8[2, P, C, K_pad], bias int32[P, C], [coef
  int32[P, 4, R],] taps)``, C = n_accum * R accumulator-major columns,
  K-major and permuted as "int8"'s (``tiled_fir.fixed_device_weights``;
  the kernel is ``csrc/fixed_wgmma.cuh``)
- ``"split5"``: ``(planes bf16[3, P, K_pad, R], taps)``

The JAX package streams ``[P, R, K_pad]`` (``[P, D, R, K_pad]`` planes;
fixed: int8 ``[P, 2, C, K_pad]`` planes and an int32 bias; split5: bf16
``[P, 3, R, K_pad]``);
``parallel/batch.weights_from_jax`` converts.  The tap table skips the zero
rows of each tile's columns (64; fixed: ``tiled_fir.FIXED_ROWS``), the
K_pad padding among them.

:func:`resample_streamed` launches the CUDA kernel
(``csrc/streamed_fir.cu``) for CUDA tensors and runs
:func:`resample_streamed_reference`, its plain PyTorch version, for CPU
tensors.  It never falls back from one to the other.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.profiling import span
from . import _build
from . import tiled_fir as tf
from .tiled_fir import K_PERM, int8_k_major, int8_n_major

__all__ = ["device_weights_streamed", "origins", "resample_streamed",
           "resample_streamed_reference", "K_PERM", "int8_k_major",
           "int8_n_major"]

#: Launches of each CUDA kernel in this process, by scheme; only
#: resample_streamed adds to it, once per launch.  Callers reset the counts
#: to count one run.
launches = {"highest": 0, "int8": 0, "fixed": 0, "split5": 0}

def device_weights_streamed(w, scheme: str, device, *,
                            k_major: bool = False) -> tuple:
    """Host weights -> the kernel's device weights (module docstring): the
    tiled kernel's conversion (``tiled_fir.device_weights``), applied to
    the K_pad-padded set.  "int8" planes are int8[D, P, K_pad, R], or with
    ``k_major`` int8[D, P, R, K_pad] (the JAX package's streamed layout
    with P and D swapped); either goes to the kernel's layout in one
    gather (:func:`int8_k_major`)."""
    if scheme != "int8":
        return tf.device_weights(w, scheme, device)
    planes, bias = (np.asarray(a) for a in w)
    assert planes.dtype == np.int8 and bias.dtype == np.float32
    if not k_major:
        planes = planes.transpose(0, 1, 3, 2)
    taps = tf.tap_ranges((planes != 0).any(axis=0).transpose(0, 2, 1))
    return (int8_k_major(planes).to(device),
            torch.from_numpy(bias.copy()).to(device),
            torch.from_numpy(taps).to(device))


def origins(n_blocks: int, R: int, *, shift: int, num: int, den: int,
            f0: int, device=None) -> torch.Tensor:
    """int64[n_blocks]: each block's patch origin on the virtual axis."""
    t = f0 + torch.arange(n_blocks, dtype=torch.int64, device=device) \
        * (R * num)
    return torch.div(t // den + shift, 16, rounding_mode="floor") * 16


def _check(hist, x, w, n_blocks, shift, num, den, f0, scheme, scales,
           n_accum):
    P, K, R = tf.check_launch(hist, x, w, scheme, scales, n_accum)
    if n_blocks <= 0 or n_blocks % P or shift < 0 or num <= 0 \
            or not 0 <= f0 < den:
        raise ValueError(f"n_blocks {n_blocks}, P {P}, shift {shift}, "
                         f"num/den {num}/{den}, f0 {f0}")
    return P, K, R


@span("speex.kernel.streamed")
def resample_streamed(hist: torch.Tensor, x: torch.Tensor, w: tuple, *,
                      n_blocks: int, shift: int, num: int, den: int,
                      f0: int = 0, scheme: str = "highest",
                      scales: tuple = (), n_accum: int = 1) -> torch.Tensor:
    """One launch: int16[n_blocks * R, B].

    hist: int16[H, B] trailing history, H = round16(filt_len - 1)
    x:    int16[T_c, B] chunk, real rows [0, n_in), zeros in whatever
          rows of [n_in, n_in + K) it has: the bare chunk (T_c = n_in)
          needs none
    w:    device weights (module docstring)
    shift, num, den, f0: the closed-form origin (module docstring)
    scales: the int8 digit scales (one per plane), () otherwise.
    n_accum: "fixed" only: 1 (direct) or 4 (interpolated) weight columns
          per output.

    Rows of the virtual axis at or past H + T_c read as zero.  CUDA
    tensors launch the kernel on the current stream (asynchronously; a
    launch error raises); CPU tensors run the plain version."""
    P, K, R = _check(hist, x, w, n_blocks, shift, num, den, f0, scheme,
                     scales, n_accum)
    if x.device.type == "cpu":
        return resample_streamed_reference(
            hist, x, w, n_blocks=n_blocks, shift=shift, num=num, den=den,
            f0=f0, scheme=scheme, scales=scales, n_accum=n_accum)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    lib = _build.load()
    if lib.streamed_fir_row_tile() != tf.ROW_TILE \
            or lib.f32_fir_sub_rows() != tf.SUB_ROWS \
            or lib.fixed_fir_rows(n_accum) != tf.FIXED_ROWS[n_accum]:
        raise RuntimeError("csrc/streamed_fir.cu tile sizes disagree with "
                           "ROW_TILE / SUB_ROWS / FIXED_ROWS")
    H, B = hist.shape
    y = torch.empty((n_blocks * R, B), dtype=torch.int16, device=x.device)
    with torch.cuda.device(x.device):
        stream = _build.stream_handle(x.device)
        geo = (H, x.shape[0], B, R, K, P, n_blocks, shift, num, den, f0,
               stream)
        head = (hist.data_ptr(), x.data_ptr(), y.data_ptr(),
                w[-1].data_ptr())
        if scheme == "highest":
            err = lib.streamed_fir_f32(*head, w[0].data_ptr(), *geo)
        elif scheme == "split5":
            err = lib.streamed_fir_split5(*head, w[0].data_ptr(), *geo)
        elif scheme == "fixed":
            coef = w[2].data_ptr() if n_accum == 4 else None
            err = lib.streamed_fir_fixed(*head, w[0].data_ptr(),
                                         w[1].data_ptr(), coef, n_accum, *geo)
        else:
            s = tuple(scales) + (0.0,) * (4 - len(scales))
            err = lib.streamed_fir_int8(*head, w[0].data_ptr(),
                                        w[1].data_ptr(), len(scales), *s,
                                        *geo)
    if err:
        raise RuntimeError("streamed FIR kernel launch failed: "
                           + lib.streamed_fir_error_string(err).decode())
    launches[scheme] += 1
    return y


def resample_streamed_reference(hist: torch.Tensor, x: torch.Tensor,
                                w: tuple, *, n_blocks: int, shift: int,
                                num: int, den: int, f0: int = 0,
                                scheme: str = "highest", scales: tuple = (),
                                n_accum: int = 1) -> torch.Tensor:
    """Plain PyTorch version of :func:`resample_streamed` (same contract),
    on the tensors' own device: each block's patch is gathered by index
    from its closed-form origin, then the tiled reference's product
    (``tiled_fir.apply_weights``): "highest" an f32 matmul with TF32 off;
    "split5" the five f32 matmuls of bf16-valued operands;
    "int8" the exact float64 digit dots, then the kernel's f32 epilogue in
    the same order; "fixed" the exact float64 int16 dots wrapped to int32,
    then the Q15 epilogue (the int8 planes back in tap order first,
    :func:`int8_n_major`; the fixed int16 taps rebuilt,
    ``tiled_fir.fixed_taps16``)."""
    P, K, R = _check(hist, x, w, n_blocks, shift, num, den, f0, scheme,
                     scales, n_accum)
    v0 = origins(n_blocks, R, shift=shift, num=num, den=den, f0=f0,
                 device=x.device)
    if scheme == "int8":
        w = (int8_n_major(w[0]), *w[1:])
    return tf.apply_weights(hist, x, w, v0, scheme, scales, n_accum)
