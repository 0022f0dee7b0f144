"""Speex's float resampler over one call of a stream, in plain PyTorch.

A stream whose calls each consume ``n_in`` frames and produce ``n_out``
(``n_in * den == n_out * num``, so every call starts at phase 0) gives,
for its global output j, what a fresh C state gives:

    y_j = WORD2INT( float( sum_t h_{f_j}[t] * xp[s_j + t] ) )

with ``xp`` the N - 1 zeros of a fresh filter memory followed by the
input, ``s_j = floor(j num / den)`` (``last_sample``), ``f_j = j num mod
den`` (``samp_frac_num``) and ``h_f`` the taps of phase f
(:func:`speex_design.phase_filters`).  The sum is taken in ``dtype``:
float64 for the reference, which is C's result up to the rounding of its
own accumulators (float32 at quality <= 8, double above), and a lower
precision for the control.  The result is rounded to float32, as C
stores it, and converted by the float build's ``WORD2INT``.

A call's outputs depend on its own input and the N - 1 input frames
before it, so any call of the stream can be worked out alone.
"""

from __future__ import annotations

import numpy as np
import torch

from .speex_design import design, phase_filters

#: the configurations' ``numeric`` that this reference reproduces
NUMERICS = ("float",)
#: output frames worked out together (a block's gathered windows take
#: rows x filt_len x lanes elements)
BLOCK_ROWS = 256


def filter_size(config: dict) -> tuple[int, int]:
    """(taps, bytes of the filter table) of Speex's design for a
    configuration."""
    d = design(config["in_rate"], config["out_rate"], config["quality"])
    return d.filt_len, d.sinc_table.nbytes


def call_reference(config: dict, n_in: int, n_out: int, device,
                   dtype=torch.float64) -> "CallReference":
    """The reference of one call of ``n_in`` -> ``n_out`` frames of a
    configuration's stream, summed in ``dtype``."""
    return CallReference(config["in_rate"], config["out_rate"],
                         config["quality"], n_in, n_out, device, dtype)


def word2int(y: torch.Tensor) -> torch.Tensor:
    """The float build's WORD2INT of float32 values: floor(0.5 + x) in
    double, saturated at -32767.5 / 32766.5; int16."""
    y = y.to(torch.float64)
    r = torch.floor(y + 0.5)
    r = torch.where(y < -32767.5, torch.full_like(r, -32768.0), r)
    r = torch.where(y > 32766.5, torch.full_like(r, 32767.0), r)
    return r.to(torch.int16)


class CallReference:
    """The outputs of one call of a stream (module docstring)."""

    def __init__(self, in_rate: int, out_rate: int, quality: int, n_in: int,
                 n_out: int, device, dtype=torch.float64):
        self.d = design(in_rate, out_rate, quality)
        if n_in * self.d.den != n_out * self.d.num or n_in % self.d.num:
            raise ValueError(f"a call of {n_in} -> {n_out} frames does not "
                             f"return to phase 0 at {in_rate} -> {out_rate}")
        self.n_in, self.n_out, self.dtype = n_in, n_out, dtype
        self.device = torch.device(device)
        j = np.arange(n_out, dtype=np.int64)
        taps = self.d.filt_len
        self.hist_rows = taps - 1
        self.w = torch.from_numpy(
            phase_filters(self.d, (j * self.d.num) % self.d.den)).to(
                self.device, dtype)
        self.starts = torch.from_numpy((j * self.d.num) // self.d.den).to(
            self.device)
        self.window = torch.arange(taps, device=self.device)

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
            idx = self.starts[j0:j1, None] + self.window      # [J, N]
            y = torch.bmm(self.w[j0:j1, None, :], xp[idx])[:, 0, :]
            out[j0:j1] = word2int(y.to(torch.float32))
        return out
