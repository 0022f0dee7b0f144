"""Closed-form phase/index arithmetic for the resampler hot path.

The reference hot loops (resample.c:331-559) advance per output sample:
    last_sample += int_advance; samp_frac_num += frac_advance;
    if (samp_frac_num >= den) { samp_frac_num -= den; last_sample++; }
which has the closed form (with num = int_advance*den + frac_advance and
initial state (ls0, f0), f0 in [0, den)):
    window_start(k)  = ls0 + (f0 + k*num) // den
    phase(k)         = (f0 + k*num) %  den
Every output sample is therefore an independent dot product — the entire
sequential state machine disappears, which is what makes the TPU
formulation (one phase-indexed matmul per launch) possible.

All functions here are exact integer host math (Python ints / NumPy int64);
nothing runs on device.  Phase state evolves deterministically from chunk
sizes alone, so the host mirrors it and the device never syncs scalars back.
"""

from __future__ import annotations

import dataclasses
import math
from functools import lru_cache

import numpy as np

__all__ = [
    "producible_outputs",
    "advance",
    "ProcessAccounting",
    "native_step",
    "process_accounting",
    "block_constants",
    "build_padded_weights",
    "build_phase_tiled_weights",
    "PhaseTiledWeights",
]


def producible_outputs(n_new: int, ls0: int, f0: int, num: int,
                       den: int) -> int:
    """Number of outputs the hot loop emits given ``n_new`` fresh input
    samples (loop condition ``last_sample < in_len``, resample.c:344)."""
    if n_new <= ls0:
        return 0
    # largest k with ls0 + (f0 + k*num)//den <= n_new - 1
    return ((n_new - ls0) * den - 1 - f0) // num + 1


def advance(n_out: int, ls0: int, f0: int, num: int,
            den: int) -> tuple[int, int]:
    """State after emitting ``n_out`` outputs: (last_sample, samp_frac_num)
    before the consumed-input subtraction (resample.c:891-894)."""
    t = f0 + n_out * num
    return ls0 + t // den, t % den


@dataclasses.dataclass(frozen=True)
class ProcessAccounting:
    """Exact (produced, consumed) bookkeeping of one reference process_*
    call, split between the magic-sample drain and the fresh chunk."""
    magic_out: int
    magic_consumed: int
    fresh_out: int
    fresh_consumed: int


def _native_step(n_in: int, o_bound: int, ls: int, f: int, num: int,
                 den: int) -> tuple[int, int, int, int]:
    """One speex_resampler_process_native call (resample.c:878-902):
    returns (produced, consumed, ls', f') for ``n_in`` offered inputs and
    ``o_bound`` output capacity, where ls' carries the unconsumed residual
    (``last_sample -= in_len``, :894)."""
    o = min(producible_outputs(n_in, ls, f, num, den), max(o_bound, 0))
    la, fa = advance(o, ls, f, num, den)
    cons = min(la, n_in)  # the in_len clamp, resample.c:891-892
    return o, cons, la - cons, fa


#: Public alias — one process_native call's exact bookkeeping, used by
#: ResamplerCore.process_native_interleaved (which bypasses the entry-point
#: bite/ystack quantization) and by differential tests.
native_step = _native_step


def process_accounting(n_magic: int, n_new: int, cap: int, ls0: int,
                       f0: int, num: int, den: int, *, xlen: int,
                       ystack: bool,
                       ystack_len: int = 1024) -> ProcessAccounting:
    """Mirror the reference's per-call consumed/produced bookkeeping
    EXACTLY, bite loop and all.

    The C process entry points feed the hot loop in bites of ``xlen =
    mem_alloc_size - (filt_len-1)`` input samples (160 unless the filter
    has since shrunk — mem_alloc_size never shrinks, resample.c:709-720)
    and exit the moment the caller's output capacity ``olen`` hits zero —
    later bites are never offered, so the consumed-input count is
    BITE-QUANTIZED whenever the capacity binds.  The JS wrapper then drops
    the unconsumed tail (``pos`` advances by the full chunk regardless of
    ``in_len``, src/index.ts:92-116), making this quantization part of the
    reference's observable streaming behavior: a closed-form
    ``consumed = min(ls_after, n_new)`` can exceed what C consumed by up
    to ``xlen - 1`` samples and desync the stream forever after.

    Two entry-point shapes exist (the ``#ifdef FIXED_POINT`` name swap,
    resample.c:924-928/:965-969):

    - ``ystack=False`` — the native-word entry (float build's
      process_float, fixed build's process_int, resample.c:929-963):
      magic samples are drained by ONE native call with the full output
      capacity before the loop; fresh input is processed only if the
      stash fully drained; each bite's output bound is the full remaining
      capacity.
    - ``ystack=True`` — the staging entry (float build's process_int,
      fixed build's process_float, resample.c:971-1035): everything runs
      inside ``while (ilen && olen)``, so NOTHING is processed (not even
      magic) when no fresh input is offered; each iteration stages
      through a 1024-sample stack buffer, draining magic first, so the
      fresh bite sharing an iteration with the final magic drain gets the
      slot's leftover ``min(olen,1024) - omagic`` as its output bound
      (and may consume residual input even with a zero output bound, via
      the ``last_sample`` clamp).

    When no bound binds, the totals equal the closed form (the bite
    recurrence composes); this function is still cheap — O(n/xlen +
    out/1024) pure-integer iterations — so callers use it unconditionally.
    """
    ls, f = int(ls0), int(f0)
    magic, ilen, olen = int(n_magic), int(n_new), int(cap)
    m_out = m_cons = f_out = f_cons = 0

    if not ystack:
        if magic:
            o, cons, ls, f = _native_step(magic, olen, ls, f, num, den)
            m_out, m_cons = o, cons
            magic -= cons
            olen -= o
        if magic == 0:
            while ilen > 0 and olen > 0:
                ichunk = min(ilen, xlen)
                o, cons, ls, f = _native_step(ichunk, olen, ls, f, num,
                                              den)
                f_out += o
                f_cons += cons
                ilen -= cons
                olen -= o
                if cons == 0 and o == 0:  # no progress possible
                    break
        return ProcessAccounting(m_out, m_cons, f_out, f_cons)

    while ilen > 0 and olen > 0:
        ichunk = min(ilen, xlen)
        ochunk = min(olen, ystack_len)
        progressed = 0
        if magic:
            o, cons, ls, f = _native_step(magic, ochunk, ls, f, num, den)
            m_out += o
            m_cons += cons
            magic -= cons
            ochunk -= o
            olen -= o
            progressed = o + cons
        if magic == 0:
            o, cons, ls, f = _native_step(ichunk, ochunk, ls, f, num, den)
            f_out += o
            f_cons += cons
            ilen -= cons
            olen -= o
            progressed += o + cons
        if progressed == 0:  # no progress possible
            break
    return ProcessAccounting(m_out, m_cons, f_out, f_cons)


@dataclasses.dataclass(frozen=True)
class BlockConstants:
    """Per-launch constants for the block formulation.

    Outputs are laid out k = b*den + r (block b, sub-phase r).  Within a
    launch that starts at fractional phase f0:
        phase(b, r)  = p[r]            (independent of b)
        start(b, r)  = ls0 + o[r] + b*num
    so the whole launch is  Y[b, r] = dot(H[p[r]], X[ls0 + b*num + o[r] :]).
    """
    num: int
    den: int
    f0: int
    p: np.ndarray  # [den] int32 phase per sub-index
    o: np.ndarray  # [den] int32 window-start offset per sub-index, in [0, num]


@lru_cache(maxsize=256)
def block_constants(num: int, den: int, f0: int,
                    group: int = 1) -> BlockConstants:
    """Constants for super-blocks of R = group*den outputs (consuming exactly
    group*num inputs each, since den outputs always consume num inputs)."""
    r = np.arange(group * den, dtype=np.int64)
    t = f0 + r * num
    return BlockConstants(
        num=num, den=den, f0=f0,
        p=(t % den).astype(np.int32),
        o=(t // den).astype(np.int32),
    )


@dataclasses.dataclass(frozen=True)
class PhaseTiledWeights:
    """Weights for the MXU-aligned phase-tiled kernel (pallas_fir v2).

    Outputs are tiled in blocks of exactly R = 128 (one full MXU pass on the
    output axis).  Block k's window starts are NOT periodic in k unless
    num ≡ 0 (mod den), so weights cycle with period ``P`` blocks: block k
    uses ``w[k % P]`` and reads input rows
    ``(k // P) * S + offsets[k % P]  ..  + K``.
    Every offset (and S·(k//P)) is a multiple of ``align`` (16 = the int16
    sublane tile), so the kernel's dynamic sublane slices stay tile-aligned
    — the sub-align remainder of each block's true start is folded into the
    weight matrix as leading zero rows.

    w:       f32[P, K, R]  (row l, col r) = taps for block-local output r
    offsets: int32[P]      8-aligned input-row offset per block phase
    S:       input rows consumed per P consecutive blocks (8-aligned)
    f_end:   samp_frac_num advance per P blocks is zero by construction —
             P·R outputs always consume exactly S inputs.
    """
    w: np.ndarray
    offsets: np.ndarray
    S: int
    R: int

    @property
    def P(self) -> int:
        return self.w.shape[0]

    @property
    def K(self) -> int:
        return self.w.shape[1]


def build_phase_tiled_weights(phase_table: np.ndarray, num: int, den: int,
                              f0: int, R: int = 128,
                              origin_shift: int = 0) -> PhaseTiledWeights:
    """Build the v2/v3 kernels' cyclic weight set.

    Let t(j) = f0 + j*num.  Output j's window starts at row t(j)//den with
    taps H[t(j) % den].  For block k (outputs k*R .. k*R+R-1):
        base(k)   = t(k*R) // den
    Phases repeat when k*R*num ≡ 0 (mod den): P0 = den / gcd(R*num, den).
    base advances by S0 = P0*R*num/den per P0 blocks; to keep all slices
    align-multiple, P = P0 * (align / gcd(S0, align)) and S = P*R*num/den,
    and each block-phase's base is rounded down to a multiple of align with
    the remainder folded into leading zero rows of its weight matrix.

    ``origin_shift`` prepends that many virtual rows before the original
    sample axis (window starts shift by +origin_shift): the concat-free v3
    kernel uses it to pad the history prefix to an aligned height
    (filt_len-1 rounded up to 16) so the history/chunk boundary lands on a
    16-multiple.
    """
    align = 16  # int16 sublane tile height on TPU
    filt_len = phase_table.shape[1]
    g = math.gcd(R * num, den)
    P0 = den // g
    S0 = P0 * R * num // den
    factor = align // math.gcd(S0, align)
    P = P0 * factor
    S = P * R * num // den
    assert S % align == 0 and (f0 + P * R * num) % den == f0 % den

    offsets = np.empty(P, dtype=np.int32)
    spans = np.empty(P, dtype=np.int64)
    for k in range(P):
        t0 = f0 + k * R * num
        base = t0 // den + origin_shift
        aligned = (base // align) * align
        offsets[k] = aligned
        spans[k] = (t0 + (R - 1) * num) // den + origin_shift - aligned
    K = int(spans.max()) + filt_len
    K = -(-K // 8) * 8

    w = np.zeros((P, K, R), dtype=phase_table.dtype)
    rows = np.arange(filt_len)
    for k in range(P):
        t = f0 + (k * R + np.arange(R, dtype=np.int64)) * num
        p = (t % den).astype(np.int64)
        o = (t // den) + origin_shift - offsets[k]  # incl. sub-align shift
        w[k][o[None, :] + rows[:, None], np.arange(R)[None, :]] = \
            phase_table[p].T
    return PhaseTiledWeights(w=w, offsets=offsets, S=int(S), R=R)


def build_padded_weights(phase_table: np.ndarray, num: int, den: int,
                         f0: int, group: int = 1) -> np.ndarray:
    """Scatter per-phase taps into the padded matmul weight matrix.

    With R = group*den output columns and stride = group*num inputs per
    super-block:  W[l, r] = H[p[r], l - o[r]] for l - o[r] in [0, filt_len),
    else 0, with L = filt_len + group*num rows.  A launch is then the single
    matmul / strided conv
        Y[B, R] = P[B, L] @ W[L, R],   P[b] = X[ls0 + b*stride : +L].
    ``group`` widens the matmul for small den so MXU lanes stay filled.
    W depends only on (phase_table, num, den, f0, group); callers cache it
    per f0 (steady-state serving feeds multiples of ``num`` inputs per
    launch, so f0 — and therefore W — never changes).
    """
    filt_len = phase_table.shape[1]
    bc = block_constants(num, den, f0, group)
    R = group * den
    L = filt_len + group * num
    W = np.zeros((L, R), dtype=phase_table.dtype)
    cols = np.arange(R)
    rows = bc.o[None, :] + np.arange(filt_len)[:, None]  # [filt_len, R]
    W[rows, cols[None, :]] = phase_table[bc.p].T
    return W
