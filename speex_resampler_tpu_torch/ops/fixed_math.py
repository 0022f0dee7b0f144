"""Exact Q15 fixed-point macro algebra for the FIXED_POINT build universe.

The reference is a dual numeric build (deps/speex/arch.h:39-67): the shipped
WASM artifact is the float build, but the C core equally compiles with
``-DFIXED_POINT`` where ``spx_word16_t = spx_int16_t`` and all sample math is
Q15 integer arithmetic (deps/speex/fixed_generic.h:38-109).  This module
reproduces that integer algebra bit-exactly in vectorized NumPy so the fixed
universe can be pinned sample-for-sample against the reference compiled with
``-DFIXED_POINT`` (tests/oracle, built twice).

Two's-complement notes: the C accumulators are ``spx_word32_t`` (int32) and
overflow in the hot loops wraps on every relevant target (and in the oracle
binary we pin against); NumPy int32 arithmetic wraps identically, so every
operation here is performed in int32 with silent wraparound, and narrowing
stores (``spx_word16_t`` assignment) truncate to int16 exactly like the C
conversions.

Reference map:
  - macro algebra:        deps/speex/fixed_generic.h:38-109
  - fixed WORD2INT:       deps/speex/arch.h:104 (clamp; C float->int16
                          conversion truncates toward zero)
  - fixed cubic_coef:     deps/speex/resample.c:302-316
  - fixed interp mixing:  deps/speex/resample.c:465-479 (MULT16_32_Q15 of the
                          half-shifted accumulators, then SATURATE32PSHR)

The torch twins at the end (``sat32pshr15``, ``mult16_32_q15_t``,
``fixed_interp_mix_rows``) are the device epilogues of the fixed kernels'
plain versions, on int32 tensors: the counterparts of the JAX package's
``sat32pshr15_jax`` / ``mult16_32_q15_jax`` / ``fixed_interp_mix_rows_jax``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "I16", "I32",
    "mult16_16", "pshr32", "shr32", "saturate32pshr",
    "mult16_32_q15", "pdiv32", "word2int_fixed",
    "cubic_coef_fixed", "interp_mix_fixed", "to_word16",
    "balanced_q15_split",
    "sat32pshr15", "mult16_32_q15_t", "fixed_interp_mix_rows",
]

I16 = np.int16
I32 = np.int32


def balanced_q15_split(w16, tap_axis: int):
    """EXACT balanced base-256 split of int16 Q15 taps — the ONE
    definition behind the fixed universe's int8-plane kernels (dense XLA
    twin AND both Pallas layouts; see fir_matmul.fixed_weight_planes,
    pallas_fir.fixed_weight_planes_tiled).

    Realizable Q15 taps satisfy |w| <= 32768*cutoff < 32639 (cutoff <=
    .975, resample.c:226-238), so w = 256*wh + wl0 with wh, wl0 in
    [-128, 127] is exact with NO constant term; the INPUT's +128 plane
    lands in a per-output bias of 128 * sum(w) over ``tap_axis``.
    Returns (wh int8, wl0 int8, bias int32)."""
    w32 = np.asarray(w16).astype(np.int32)
    # exact for every int16 in [-32768, 32639]; only [32640, 32767] fails
    assert w32.max() < 32640, "tap exceeds exact 2-plane range"
    wl0 = ((w32 + 128) & 255) - 128
    wh = (w32 - wl0) >> 8
    assert np.abs(wh).max() <= 127 and (w32 == 256 * wh + wl0).all()
    bias = w32.sum(axis=tap_axis, dtype=np.int32) << 7
    return wh.astype(np.int8), wl0.astype(np.int8), bias


def _i32(x) -> np.ndarray:
    return np.asarray(x).astype(I32)


def to_word16(x) -> np.ndarray:
    """Narrowing store into spx_word16_t: C int->int16 conversion (wraps)."""
    return _i32(x).astype(I16)


def mult16_16(a, b) -> np.ndarray:
    """MULT16_16: exact int16*int16 -> int32 product (never overflows)."""
    return _i32(to_word16(a)) * _i32(to_word16(b))


def shr32(a, shift: int) -> np.ndarray:
    """SHR32: arithmetic right shift of int32."""
    return _i32(a) >> shift


def pshr32(a, shift: int) -> np.ndarray:
    """PSHR32: rounding arithmetic shift ((a + (1<<(shift-1))) >> shift).
    The bias add wraps in int32, matching the C macro on overflow."""
    with np.errstate(over="ignore"):
        return (_i32(a) + I32(1 << (shift - 1))) >> shift


def saturate32pshr(x, shift: int, a: int) -> np.ndarray:
    """SATURATE32PSHR(x, shift, a) (fixed_generic.h:55-57)."""
    x = _i32(x)
    hi = I32(a << shift)
    return np.where(x >= hi, I32(a),
                    np.where(x <= -hi, I32(-a), pshr32(x, shift)))


def mult16_32_q15(a, b) -> np.ndarray:
    """MULT16_32_Q15(a, b) = a*(b>>15) + (a*(b & 0x7fff)) >> 15.

    ``a`` is a Q15 int16 coefficient, ``b`` an int32; both partial products
    and the final add are int32 with wraparound (fixed_generic.h:90)."""
    a = _i32(to_word16(a))
    b = _i32(b)
    with np.errstate(over="ignore"):
        return a * (b >> 15) + ((a * (b & I32(0x7FFF))) >> 15)


def pdiv32(a, b) -> np.ndarray:
    """PDIV32(a,b) = (a + ((spx_word16_t)b >> 1)) / b, C division toward zero
    (fixed_generic.h:108).  Note the bias uses b truncated to int16."""
    a = _i32(a)
    bias = _i32(to_word16(b)) >> 1
    with np.errstate(over="ignore"):
        num = a + bias  # ADD32 wraps in int32 (can land exactly on INT32_MIN)
    # C integer division truncates toward zero; numpy // floors.  The
    # quotient must be computed in int64: np.abs(INT32_MIN) wraps back to
    # INT32_MIN in int32, which poisoned the sign fixup for any
    # interpolated config with den >= 65537 (SHL32(rem,15) can wrap to
    # exactly -2^31).  The int32-wrapped ``num`` above is the C value; only
    # the division widens.
    num64 = num.astype(np.int64)
    den64 = _i32(b).astype(np.int64)
    q = np.abs(num64) // np.abs(den64)
    return np.where((num64 < 0) != (den64 < 0), -q, q).astype(I32)


def word2int_fixed(x) -> np.ndarray:
    """Fixed-build WORD2INT (arch.h:104): clamp a float expression at
    [-32767, 32766] boundaries (out-of-range -> -32768 / 32767), then the
    spx_word16_t assignment truncates toward zero."""
    x = np.asarray(x, dtype=np.float64)
    inner = np.trunc(x).astype(I32)  # safe: |x| < 32768 wherever selected
    return np.where(x < -32767.0, I32(-32768),
                    np.where(x > 32766.0, I32(32767), inner)).astype(I16)


def cubic_coef_fixed(frac) -> np.ndarray:
    """Fixed-build cubic_coef (resample.c:302-316).

    ``frac`` is the Q15 fractional phase (int, [0, 32767]).  Returns
    (..., 4) int16 [interp0..interp3].  Constants are QCONST16 of the float
    literals: trunc(.5 + c*32768) toward zero."""
    x = _i32(frac)
    x2 = _i32(to_word16(pshr32(x * x, 15)))        # MULT16_16_P15(x, x)
    x3 = _i32(to_word16(pshr32(x * x2, 15)))       # MULT16_16_P15(x, x2)
    # QCONST16 truncates toward zero: QCONST16(-0.16667f,15) = -5460,
    # QCONST16(0.16667f,15) = 5461, QCONST16(-0.33333f,15) = -10922,
    # QCONST16(.5f,15) = 16384 (verified against the compiled macro)
    i0 = to_word16(pshr32(I32(-5460) * x + I32(5461) * x3, 15))
    i1 = to_word16(x + ((x2 - x3) >> 1))           # EXTRACT16(x + SHR32(...))
    i3 = to_word16(pshr32(I32(-10922) * x + I32(16384) * x2
                          + I32(-5461) * x3, 15))
    # interp[2] = Q15_ONE - i0 - i1 - i3 computed in int, STORED to int16
    # (wraps), then the < 32767 guard tests the stored value
    i2 = to_word16(I32(32767) - _i32(i0) - _i32(i1) - _i32(i3))
    i2 = to_word16(np.where(_i32(i2) < 32767, _i32(i2) + 1, _i32(i2)))
    return np.stack([i0, i1, i2, i3], axis=-1)


def interp_mix_fixed(accum, interp) -> np.ndarray:
    """Fixed interpolate-path epilogue (resample.c:474-479):

        sum = sum_k MULT16_32_Q15(interp[k], SHR32(accum[k], 1))
        out = (int16) SATURATE32PSHR(sum, 15, 32767)

    ``accum``: (..., 4) int32 raw tap accumulators; ``interp``: (..., 4)
    int16 cubic coefficients."""
    accum = _i32(accum)
    terms = mult16_32_q15(interp, shr32(accum, 1))
    with np.errstate(over="ignore"):
        s = terms[..., 0] + terms[..., 1] + terms[..., 2] + terms[..., 3]
    return to_word16(saturate32pshr(s, 15, 32767))


# ---------------------------------------------------------------------------
# torch twins of the device epilogues, on int32 tensors.  torch int32
# arithmetic wraps like the jnp versions': every product, sum and the
# rounding add stays in int32 (no widening), and >> is arithmetic.
# ---------------------------------------------------------------------------


def sat32pshr15(s: torch.Tensor) -> torch.Tensor:
    """SATURATE32PSHR(s, 15, 32767) + int16 store (the fixed direct
    epilogue; fixed_generic.h:55-57): 32767 at or above 32767<<15, -32767
    at or below -(32767<<15), else (s + (1<<14)) >> 15."""
    hi = 32767 << 15
    r = (s + (1 << 14)) >> 15
    return torch.where(s >= hi, 32767,
                       torch.where(s <= -hi, -32767, r)).to(torch.int16)


def mult16_32_q15_t(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """MULT16_32_Q15 on int32 tensors (int32 wrap):
    a*(b>>15) + ((a*(b & 0x7fff)) >> 15)."""
    return a * (b >> 15) + ((a * (b & 0x7FFF)) >> 15)


def fixed_interp_mix_rows(acc: torch.Tensor,
                          coef: torch.Tensor) -> torch.Tensor:
    """Fixed interpolate epilogue (resample.c:474-479, fixed branch).

    acc: int32 [..., 4, R, lanes] raw tap accumulators, accumulator-major;
    coef: int32 [..., 4, R] Q15 cubic coefficients.  Returns int16
    [..., R, lanes]: sum_c MULT16_32_Q15(coef[c], acc[c] >> 1), then
    SATURATE32PSHR(., 15, 32767)."""
    s = torch.zeros_like(acc[..., 0, :, :])
    for c in range(4):
        s = s + mult16_32_q15_t(coef[..., c, :, None], acc[..., c, :, :] >> 1)
    return sat32pshr15(s)
