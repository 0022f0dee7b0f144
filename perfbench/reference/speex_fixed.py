"""Speex's fixed-point (Q15) resampler over one call of a stream, in
plain PyTorch and NumPy: speexdsp built with ``--enable-fixed-point``
(``-DFIXED_POINT``), its interpolated path.

A stream whose calls each consume ``n_in`` frames and produce ``n_out``
(``n_in * den == n_out * num``, so every call starts at phase 0) gives,
for its global output j, what a fresh C state gives in
``resampler_basic_interpolate_single`` (resample.c:438-496, the
``FIXED_POINT`` branches):

    offset = f_j * oversample / den
    frac   = PDIV32(SHL32((f_j * oversample) % den, 15), den)        (Q15)
    acc[k] = sum_t xp[s_j + t] * table[4 + (t+1) oversample - offset - 2 + k]
    sum    = sum_k MULT16_32_Q15(interp[k], SHR32(acc[k], 1))
    y_j    = SATURATE32PSHR(sum, 15, 32767)

with ``xp`` the N - 1 zeros of a fresh filter memory followed by the int16
input, ``s_j = floor(j num / den)`` (``last_sample``), ``f_j = j num mod
den`` (``samp_frac_num``), ``interp`` the fixed ``cubic_coef`` of
``frac`` (resample.c:302-316) and ``table`` the int16 table of the fixed
``sinc`` (resample.c:275-285): 32768 times the double value, through the
fixed build's ``WORD2INT`` (clamped, then truncated toward zero).  The
accumulators are C's ``spx_word32_t`` and wrap.

The four sums over the window are one float64 ``bmm`` of the stacked tap
rows against the gathered windows, in blocks of output rows: exact, since
N products of int16 by int16 stay under 2^39, far inside float64's 2^53;
the result is then wrapped to int32 in int64.  With another ``dtype``
(the control) the products are summed in it and the sums rounded to the
nearest integer before the wrap.

Where it departs from resample.c: it sums each accumulator in one step
instead of tap by tap, which changes nothing, since a sum that wraps mod
2^32 is the same in any order; it works out any call of the stream alone
from that call's input and the N - 1 frames before it, where C carries
``last_sample``, ``samp_frac_num`` and its filter memory from call to
call, which gives the same outputs for calls that return to phase 0; it
takes the filter length, oversample, cutoff and window from the float
build's design (``speex_design``), which ``update_filter`` computes the
same way in both builds; and it refuses the direct path (``use_direct``),
whose loop it does not reproduce.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .speex_design import QUALITY_MAP, _compute_func, design

#: the configurations' ``numeric`` that this reference reproduces
NUMERICS = ("fixed",)
#: output frames worked out together (a block's gathered windows take
#: rows x filt_len x lanes elements)
BLOCK_ROWS = 256

F32 = np.float32
F64 = np.float64


def _wrap(v, bits: int):
    """Two's-complement wrap of whole numbers (int64 arrays or tensors)
    to ``bits`` bits, as C's narrowing conversion leaves them."""
    half = 1 << (bits - 1)
    return ((v + half) % (1 << bits)) - half


def _qconst16(c: float) -> int:
    """QCONST16(c, 15) of a float literal: (spx_word16_t)(.5 + c * 32768),
    the product in float, the sum in double, truncated toward zero."""
    return int(math.trunc(0.5 + float(F32(c) * F32(32768))))


def fixed_table(in_rate: int, out_rate: int, quality: int):
    """(design, int16 table) of the fixed build's interpolated path: the
    fixed ``sinc`` of the float build's grid, entries for i in [-4,
    oversample N + 4) at index i + 4.  ValueError for a direct design."""
    d = design(in_rate, out_rate, quality)
    if d.use_direct:
        raise ValueError(f"{in_rate} -> {out_rate} at quality {quality} "
                         "takes resample.c's direct path, which this "
                         "reference does not reproduce")
    _, _, down_bw, up_bw, window = QUALITY_MAP[quality]
    cutoff = (F32(F32(down_bw) * F32(d.den) / F32(d.num)) if d.num > d.den
              else F32(up_bw))
    N, ov = d.filt_len, d.oversample
    i = np.arange(-4, ov * N + 4, dtype=np.int64)
    x = ((i.astype(F32) / F32(ov)).astype(F32) - F32(N // 2)).astype(F32)
    xx = (x * cutoff).astype(F32)
    ax = np.abs(x.astype(F64))
    pi_xx = F64(math.pi) * xx.astype(F64)
    win = _compute_func(np.abs(F64(2.0) * x.astype(F64) / F64(N)).astype(F32),
                        window)
    with np.errstate(divide="ignore", invalid="ignore"):
        v = F64(32768.0) * cutoff.astype(F64) * np.sin(pi_xx) / pi_xx * win
    v = np.where(ax < F64(F32(1e-6)), F64(32768.0) * cutoff.astype(F64), v)
    # WORD2INT of the fixed build: clamped, then the int16 return value
    # truncates toward zero
    w = np.where(v < -32767, -32768.0, np.where(v > 32766, 32767.0,
                                                np.trunc(v)))
    w = np.where(ax > F64(F32(0.5) * F32(N)), 0.0, w)
    return d, w.astype(np.int16)


def cubic_coef_q15(frac: np.ndarray) -> np.ndarray:
    """The fixed ``cubic_coef`` (resample.c:302-316) of Q15 fractions:
    int64 [..., 4], each an int16 value."""
    x = np.asarray(frac, dtype=np.int64)
    x2 = _wrap((x * x + 16384) >> 15, 16)                   # MULT16_16_P15
    x3 = _wrap((x * x2 + 16384) >> 15, 16)
    c0, c1 = _qconst16(-0.16667), _qconst16(0.16667)
    c3, c5 = _qconst16(-0.33333), _qconst16(0.5)
    i0 = _wrap((c0 * x + c1 * x3 + 16384) >> 15, 16)        # PSHR32(., 15)
    i1 = _wrap(x + ((x2 - x3) >> 1), 16)
    i3 = _wrap((c3 * x + c5 * x2 - c1 * x3 + 16384) >> 15, 16)
    i2 = _wrap(32767 - i0 - i1 - i3, 16)                    # Q15_ONE - ...
    i2 = np.where(i2 < 32767, i2 + 1, i2)
    return np.stack([i0, i1, i2, i3], axis=-1)


def phase_rows(d, table: np.ndarray, phases: np.ndarray):
    """(taps int16 [n, 4, N], interp int64 [n, 4]) of the phases
    ``samp_frac_num`` = f: the four table columns that ``acc[0..3]`` sum,
    and the Q15 cubic coefficients that mix them."""
    f = np.asarray(phases, dtype=np.int64)
    prod = (f * d.oversample) & 0xFFFFFFFF          # spx_uint32_t product
    offset = prod // d.den
    shl = _wrap(((prod % d.den) << 15) & 0xFFFFFFFF, 32)   # SHL32, as int32
    # PDIV32: (a + ((spx_word16_t)b >> 1)) / b, C's division toward zero
    a = _wrap(shl + (_wrap(d.den, 16) >> 1), 32)
    q = np.abs(a) // d.den
    frac = _wrap(np.where(a < 0, -q, q), 16)
    t = np.arange(d.filt_len, dtype=np.int64)
    base = 4 + (t + 1)[None, :] * d.oversample - offset[:, None] - 2
    idx = base[:, None, :] + np.arange(4)[None, :, None]        # [n, 4, N]
    return table[idx], cubic_coef_q15(frac)


def mix(acc: torch.Tensor, interp: torch.Tensor) -> torch.Tensor:
    """int16 [J, B] from the wrapped accumulators int64 [J, 4, B] and the
    coefficients int64 [J, 4]: sum_k MULT16_32_Q15(interp[k], SHR32(acc[k],
    1)), wrapped to int32, then SATURATE32PSHR(sum, 15, 32767)."""
    a = interp[:, :, None]
    b = acc >> 1
    s = _wrap((a * (b >> 15) + ((a * (b & 0x7FFF)) >> 15)).sum(dim=1), 32)
    hi = 32767 << 15
    y = torch.where(s >= hi, 32767, torch.where(s <= -hi, -32767,
                                                (s + (1 << 14)) >> 15))
    return y.to(torch.int16)


def filter_size(config: dict) -> tuple[int, int]:
    """(taps, bytes of the int16 filter table) of the fixed build's design
    for a configuration."""
    d, table = fixed_table(config["in_rate"], config["out_rate"],
                           config["quality"])
    return d.filt_len, table.nbytes


def call_reference(config: dict, n_in: int, n_out: int, device,
                   dtype=torch.float64) -> "CallReference":
    """The reference of one call of ``n_in`` -> ``n_out`` frames of a
    configuration's stream, its sums taken in ``dtype``."""
    return CallReference(config["in_rate"], config["out_rate"],
                         config["quality"], n_in, n_out, device, dtype)


class CallReference:
    """The outputs of one call of a stream (module docstring)."""

    def __init__(self, in_rate: int, out_rate: int, quality: int, n_in: int,
                 n_out: int, device, dtype=torch.float64):
        self.d, self.table = fixed_table(in_rate, out_rate, quality)
        d = self.d
        if n_in * d.den != n_out * d.num or n_in % d.num:
            raise ValueError(f"a call of {n_in} -> {n_out} frames does not "
                             f"return to phase 0 at {in_rate} -> {out_rate}")
        self.n_in, self.n_out, self.dtype = n_in, n_out, dtype
        self.device = torch.device(device)
        self.hist_rows = d.filt_len - 1
        taps, interp = phase_rows(d, self.table,
                                  np.arange(d.den, dtype=np.int64))
        self.taps = torch.from_numpy(taps).to(self.device, dtype)
        self.interp = torch.from_numpy(interp).to(self.device)
        j = np.arange(n_out, dtype=np.int64)
        self.phases = torch.from_numpy((j * d.num) % d.den).to(self.device)
        self.starts = torch.from_numpy((j * d.num) // d.den).to(self.device)
        self.window = torch.arange(d.filt_len, device=self.device)

    def __call__(self, prev: torch.Tensor | None,
                 cur: torch.Tensor) -> torch.Tensor:
        """int16 [n_out, B] of the call that consumes ``cur`` (int16
        [n_in, B]) after ``prev`` (the previous call's input, of at least
        N - 1 rows; None for a stream's first call)."""
        B = cur.shape[1]
        if prev is None:
            head = torch.zeros((self.hist_rows, B), dtype=torch.int16,
                               device=cur.device)
        else:
            head = prev[prev.shape[0] - self.hist_rows:]
        xp = torch.cat([head, cur]).to(self.device, self.dtype)
        out = torch.empty((self.n_out, B), dtype=torch.int16,
                          device=self.device)
        for j0 in range(0, self.n_out, BLOCK_ROWS):
            j1 = min(j0 + BLOCK_ROWS, self.n_out)
            f = self.phases[j0:j1]
            idx = self.starts[j0:j1, None] + self.window      # [J, N]
            acc = torch.bmm(self.taps[f], xp[idx])              # [J, 4, B]
            acc = _wrap(torch.round(acc.to(torch.float64)).to(torch.int64),
                        32)
            out[j0:j1] = mix(acc, self.interp[f])
        return out
