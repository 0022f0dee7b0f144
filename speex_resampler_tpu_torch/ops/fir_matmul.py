"""Plain-torch twins of the JAX package's XLA-only launch ops.

Counterpart of ``speex_resampler_tpu/ops/fir_matmul.py``.  The JAX package
runs these outside any ``pallas_call`` (XLA fuses them), so they are no TPU
kernels and stay plain torch on every device, the card included:

- :func:`resample_conv`: ``ResamplerCore``'s device route, one f32 matmul
  of strided patches against the padded phase weights, in full FP32 (the
  JAX package's ``Precision.HIGHEST``) whatever the caller set for TF32;
- :func:`resample_conv_tm_fixed`: the fixed-point (Q15) dense launch, exact;
- :func:`resample_gather` / :func:`resample_gather_fixed`: the weight-free
  gather launch of huge-denominator ratios (e.g. 44100 -> 44101), float and
  fixed.

The float dense launch is a TPU kernel (K3) and lives in ``ops/dense_fir``.
Also here: the dense geometry's group factor and padded-weight cap.

Fixed weights are the int16 taps themselves (as in ``ops/tiled_fir``), not
the two int8 planes plus a bias that the JAX package builds for the MXU:
``w16 int16[L, C]`` with ``C = n_accum * R`` columns accumulator-major
(column ``c*R + r``), and the Q15 cubic coefficients ``coef int32[4, R]``
for the interpolated filter (``n_accum`` 4).  The exact integer dots are
float64 matmuls (every int16 x int16 product is at most 2^30 and every
partial sum an integer far below 2^53, so any order gives the same number),
wrapped to int32 as the C accumulator wraps.
"""

from __future__ import annotations

import torch

from .convert import word2int
from .fixed_math import fixed_interp_mix_rows, sat32pshr15
from .tiled_fir import _no_tf32, wrap_int32

__all__ = ["MAX_PADDED_WEIGHT_BYTES", "choose_group", "resample_conv",
           "resample_conv_tm_fixed", "resample_gather",
           "resample_gather_fixed"]

#: Above this padded-weight size the engine takes the gather geometry.
MAX_PADDED_WEIGHT_BYTES = 32 * 1024 * 1024

_LANE_TARGET = 128   # output columns per block row the group widens toward

# float64 bytes of one gather tile's [tile, N, batch] window; the tile is
# chosen from N and the batch so that it stays under this at any batch, and
# holds at most the JAX package's 2048 outputs (each tile is a dozen small
# ops, so at 2048 lanes a larger window means fewer of them: 128 outputs a
# tile at N 128)
_GATHER_WINDOW_BYTES = 256 * 1024 * 1024
_GATHER_MAX_TILE = 2048


def choose_group(num: int, den: int, filt_len: int) -> int:
    """The dense super-block group factor G (R = G*den output columns):
    widens small-den configs toward 128 columns while G*num <= 2*filt_len
    (the JAX package's rule)."""
    if den >= _LANE_TARGET:
        return 1
    g = -(-_LANE_TARGET // den)
    while g > 1 and g * num > 2 * filt_len:
        g -= 1
    return max(g, 1)


def dense_patches(x: torch.Tensor, L: int, stride: int) -> torch.Tensor:
    """[n_blocks, L, B] view: block b is rows b*stride .. b*stride+L-1 of
    the time-major x int16[T, B] (T % stride == 0, L % stride == 0,
    n_blocks = T // stride - L // stride)."""
    T, B = x.shape
    assert T % stride == 0 and L % stride == 0, (T, L, stride)
    n_blocks = T // stride - L // stride
    assert n_blocks >= 1, (T, L, stride)
    return x.unfold(0, L, stride)[:n_blocks].transpose(1, 2)


def resample_conv(x: torch.Tensor, w: torch.Tensor, *, stride: int,
                  raw: bool = False) -> torch.Tensor:
    """One launch of the single-stream device route: strided patches times
    the padded phase weights.

    x: f32 (or int16) [batch, T]  history ++ chunk ++ zero pad, where
                                  T = n_blocks * stride + L
    w: f32 [L, R]                 padded phase weights, L % stride == 0
    returns int16 [batch, n_blocks * R] through WORD2INT, or the raw f32
    sums (the float-sample API, no WORD2INT) when ``raw``; callers slice
    off the masked tail outputs.

    Patch b is x[b*stride : b*stride + L] (an unfold view); the product is
    one f32 matmul with TF32 off for its duration."""
    L, R = w.shape
    batch, T = x.shape
    assert T % stride == 0 and L % stride == 0, (T, L, stride)
    n_blocks = T // stride - L // stride
    patches = x.unfold(1, L, stride)[:, :n_blocks]        # [batch, nb, L]
    with _no_tf32():
        y = torch.matmul(patches.reshape(batch * n_blocks, L).float(),
                         w.float())                       # [batch*nb, R]
    y = y.reshape(batch, n_blocks * R)
    return y if raw else word2int(y)


def resample_conv_tm_fixed(x: torch.Tensor, w: tuple, *, stride: int,
                           n_accum: int = 1) -> torch.Tensor:
    """Fixed-point dense launch, time-major, bit-exact.

    x: int16[T, B], T % stride == 0 (history ++ chunk ++ zeros)
    w: ``(w16 int16[L, C],)`` (direct, n_accum 1) or ``(w16, coef
       int32[4, R])`` (interpolated, n_accum 4); L % stride == 0
    returns int16[n_blocks * R, B].  n_accum 1: SATURATE32PSHR(sum, 15,
    32767); n_accum 4: sum_c MULT16_32_Q15(coef[c], acc_c >> 1), then the
    same saturation."""
    w16 = w[0]
    L, C = w16.shape
    R = C // n_accum
    patches = dense_patches(x, L, stride)                  # [nb, L, B]
    n_blocks, B = patches.shape[0], x.shape[1]
    acc = wrap_int32(torch.matmul(w16.double().t(), patches.double()))
    if n_accum == 1:
        return sat32pshr15(acc).reshape(n_blocks * R, B)
    return fixed_interp_mix_rows(acc.view(n_blocks, 4, R, B),
                                 w[1]).reshape(n_blocks * R, B)


def _gather_tiles(n_out: int, N: int, batch: int, tile: int | None):
    if tile is None:
        tile = min(_GATHER_MAX_TILE,
                   max(1, _GATHER_WINDOW_BYTES // (N * batch * 8)))
    return range(0, n_out, tile), tile


def _windows(x: torch.Tensor, starts: torch.Tensor, o0: int, o1: int,
             N: int) -> torch.Tensor:
    """float64 [o1-o0, N, batch]: output o's window, rows starts[o] ..
    starts[o]+N-1 of x int16[batch, T] (read time-major)."""
    idx = starts[o0:o1].long()[:, None] + torch.arange(N, device=x.device)
    return x.t()[idx].double()


def resample_gather(x: torch.Tensor, taps: torch.Tensor,
                    starts: torch.Tensor, *,
                    tile: int | None = None,
                    raw: bool = False) -> torch.Tensor:
    """Float gather launch: per-output tap-row dots.

    x:      int16 (or f32) [batch, T]
    taps:   f32[n_out, N]   each output's taps, gathered by phase
    starts: int32[n_out]    window starts (clamped in range)
    returns int16[batch, n_out], or the raw f32 sums when ``raw``

    Each dot is taken in float64 (the products of f32 taps and int16
    samples are exact there), rounded once to f32, then WORD2INT: within
    the LSB contract of the JAX package's f32 HIGHEST einsum.  Outputs are
    walked ``tile`` at a time (by default sized from N and the batch, so
    the window stays bounded); the result does not depend on the tile."""
    n_out, N = taps.shape
    batch = x.shape[0]
    y = torch.empty((n_out, batch), dtype=torch.float32, device=x.device)
    tiles, tile = _gather_tiles(n_out, N, batch, tile)
    for o0 in tiles:
        o1 = min(o0 + tile, n_out)
        win = _windows(x, starts, o0, o1, N)               # [t, N, batch]
        y[o0:o1] = torch.matmul(taps[o0:o1, None, :].double(),
                                win)[:, 0].float()
    return y.t() if raw else word2int(y).t()


def resample_gather_fixed(x: torch.Tensor, taps: torch.Tensor,
                          starts: torch.Tensor,
                          coef: torch.Tensor | None = None, *,
                          tile: int | None = None) -> torch.Tensor:
    """Fixed-point gather launch, bit-exact.

    x:      int16[batch, T]
    taps:   int16[n_out, N] (direct rows) or int16[n_out, 4, N]
            (interpolated accumulator rows), gathered by phase
    starts: int32[n_out] clamped window origins
    coef:   int32[n_out, 4] Q15 cubic coefficients (interpolated only)
    returns int16[batch, n_out]

    The int16 dots are exact float64 matmuls wrapped to int32, then the
    Q15 epilogue (the cubic mix of the 4 accumulators for an interpolated
    filter)."""
    n_out, N = taps.shape[0], taps.shape[-1]
    batch = x.shape[0]
    interp = taps.dim() == 3
    t3 = taps if interp else taps[:, None, :]
    y = torch.empty((n_out, batch), dtype=torch.int16, device=x.device)
    tiles, tile = _gather_tiles(n_out, N, batch, tile)
    for o0 in tiles:
        o1 = min(o0 + tile, n_out)
        win = _windows(x, starts, o0, o1, N)               # [t, N, batch]
        acc = wrap_int32(torch.matmul(t3[o0:o1].double(), win))
        if interp:
            y[o0:o1] = fixed_interp_mix_rows(
                acc[:, :, None, :], coef[o0:o1, :, None])[:, 0]
        else:
            y[o0:o1] = sat32pshr15(acc[:, 0])
    return y.t()
