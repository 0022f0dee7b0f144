"""Int8 digit-plane decomposition for the opt-in fast kernel.

The MXU runs int8×int8→int32 at 2× the bf16 rate (4× the f32-HIGHEST
rate).  The resampler dot  y[r] = Σ_j w[j,r]·x[j]  decomposes exactly:

  x int16  = 256·xh + (xl8 + 128)          xh, xl8 ∈ [-128,127] int8
  w        ≈ W/2^sw,  W = Σ_d 256^d·w_d    w_d ∈ [-128,127] int8 (balanced)

  y·2^sw   = Σ_d 2^{8d} ( 256·⟨w_d, xh⟩ + ⟨w_d, xl8⟩ + 128·Σ_j w_d[j,r] )

i.e. 6 int8 MXU dots, an exact int32 inner combine, a per-column constant
bias, and one f32 scale per digit.  All integer arithmetic is exact; the
only approximations are (a) the weight quantization W/2^sw − w and (b) f32
rounding when converting the int32 partials whose magnitude can exceed
2^24.  Both are bounded RIGOROUSLY per filter by :func:`decompose`'s
certificate (worst case over all possible int16 inputs); the engine only
enables the fast path when the certificate stays below ``max_abs_err``
(default 0.35 LSB, comfortably under the 0.5 LSB rounding boundary so the
≤1 LSB contract vs the reference is preserved).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Int8Planes", "decompose"]

_DIGITS = 3
_XMAX = 32768.0  # worst-case |x|


@dataclasses.dataclass(frozen=True)
class Int8Planes:
    """Digit planes + recombination constants for one tiled weight set.

    planes: int8[D, P, K, R]   balanced base-256 digits of round(w·2^sw)
    bias:   f32[P, R]          128·Σ_j w[j,r] (the xl8+128 shift), exact
    scales: f32[D]             2^{8d − sw}
    err_bound: rigorous worst-case |error| in s16 LSB over all inputs
    """
    planes: np.ndarray
    bias: np.ndarray
    scales: np.ndarray
    sw: int
    err_bound: float

    @property
    def D(self) -> int:
        return self.planes.shape[0]


def decompose(w: np.ndarray, sw: int = 22,
              digits: int = _DIGITS) -> Int8Planes:
    """w: f32[P, K, R] tiled weights (ops/phase.build_phase_tiled_weights).

    Balanced digits require |round(w·2^sw)| ≤ 128·Σ_d 256^d; sw is lowered
    until that holds.  More digits admit a larger sw (finer quantization,
    tighter certificate) at the cost of 2 extra MXU passes per digit.
    """
    w64 = w.astype(np.float64)
    # balanced digits are asymmetric: max +127*sum(256^d), min -128*sum
    s = sum(256 ** d for d in range(digits))
    cap_pos, cap_neg = 127 * s, -128 * s
    while sw > 0:
        r = np.round(w64 * 2.0 ** sw)
        if r.max() <= cap_pos and r.min() >= cap_neg:
            break
        sw -= 1
    W = np.round(w64 * 2.0 ** sw).astype(np.int64)

    planes = np.empty((digits,) + w.shape, dtype=np.int8)
    t = W.copy()
    for d in range(digits):
        dig = ((t + 128) % 256) - 128
        planes[d] = dig.astype(np.int8)
        t = (t - dig) >> 8
    assert not t.any(), f"weight exceeded {digits}-digit balanced capacity"

    # exact bias for the +128 shift of the low input digit
    bias = (128.0 * W.sum(axis=1) / 2.0 ** sw).astype(np.float32)  # [P, R]
    scales = np.array([2.0 ** (8 * d - sw) for d in range(digits)],
                      dtype=np.float32)

    # --- rigorous error certificate (worst case over all int16 inputs) ---
    # (a) weight quantization: |Σ_j x_j e_j| ≤ XMAX · Σ_j |e_j|
    e = np.abs(w64 - W / 2.0 ** sw)                       # [P, K, R]
    quant = _XMAX * e.sum(axis=1).max()
    # (b) f32 conversion of the int32 partials I_d = 256·Dh_d + Dl_d:
    #     |I_d| ≤ (256·128 + 128) · Σ_j |w_d[j,r]| = 32896·colsum_d;
    #     f32 relative error 2^-24 (0 if |I_d| < 2^24, but bound uniformly),
    #     scaled by 2^{8d-sw}.
    conv = 0.0
    for d in range(digits):
        colsum = np.abs(planes[d].astype(np.float64)).sum(axis=1).max()
        imax = 32896.0 * colsum
        if imax >= 2.0 ** 31:
            # the kernel's exact combine 256*ah + al would WRAP int32 —
            # no error bound exists; refuse this decomposition outright
            # (very long decimation filters; callers fall back to split5)
            conv = np.inf
            break
        if imax >= 2.0 ** 24:
            conv += imax * 2.0 ** -24 * 2.0 ** (8 * d - sw)
    # (c) the final f32 sum of 3 scaled terms + bias: ≤ 3 roundings at the
    #     output magnitude (≤ 2^15 · 2^-23 each, counting guard bits)
    final = 4 * 2.0 ** 15 * 2.0 ** -23

    return Int8Planes(planes=planes, bias=bias, scales=scales, sw=sw,
                      err_bound=float(quant + conv + final))
