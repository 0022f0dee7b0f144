"""Host-side filter designer for the TPU-native Speex-compatible resampler.

Re-derives the reference's Kaiser-windowed-sinc filter tables with the exact
mixed float32/float64 arithmetic of the C core so that tables are
*bit-identical* to the reference build (``deps/speex/resample.c`` compiled
with ``-DFLOATING_POINT -DOUTSIDE_SPEEX`` as the shipped WASM is,
``scripts/build_emscripten.sh:18-19``).

Everything here is cold-path NumPy: tables are built once per (quality,
num/den) configuration and shipped to the device, where the hot path is a
single phase-indexed matmul (see ``ops/fir_matmul.py``).

Reference map (file:line cites into the Speex reference sources):
  - quality presets:        deps/speex/resample.c:226-238 (quality_map)
  - Kaiser window tables:   deps/speex/resample.c:148-206
  - window evaluator:       deps/speex/resample.c:240-258 (compute_func)
  - sinc tap generator:     deps/speex/resample.c:288-299 (float build)
  - cubic phase interp:     deps/speex/resample.c:318-329 (cubic_coef)
  - filter (re)design:      deps/speex/resample.c:605-701 (update_filter)
  - ratio reduction:        deps/speex/resample.c:1095-1145
"""

from __future__ import annotations

import dataclasses
import math
import threading
from functools import lru_cache

import numpy as np

__all__ = [
    "QUALITY_MAP",
    "FilterSpec",
    "design_filter",
    "compute_gcd",
    "multiply_frac",
    "build_sinc_table_direct",
    "build_sinc_table_interp",
    "effective_phase_table",
    "cubic_coef",
    "OverflowArgError",
]

_UINT32_MAX = 0xFFFFFFFF

F32 = np.float32
F64 = np.float64

# Concurrency contract: design_filter is lru_cache'd, so FilterSpec
# instances (and their lazily-built tables / the phase-tiled weight cache
# parallel/batch.py attaches) are SHARED across engines.  Server threads
# construct engines for the same config concurrently (MultiFleet buckets
# are built on demand from request threads), so every mutation of a shared
# spec — the lazy phase_table / interp tensors here, and batch.py's
# spec-attached ``_ptw_cache`` — serializes on a PER-SPEC re-entrant lock
# (re-entrant because the tiled-weight build reads the lazy tables while
# holding it; per-spec so cold builds of UNRELATED configs — a
# heterogeneous MultiFleet's buckets — proceed in parallel instead of
# queueing behind one near-256 MB streamed-table build).  The global lock
# below only guards attaching the per-spec lock itself.  Tables are
# immutable once built, so lock-free READS of an already-populated
# attribute stay safe; only build-and-attach races are possible, and the
# per-spec lock removes them.  (The JAX package's tests/test_threaded.py
# pins the original of this code.)
SPEC_BUILD_LOCK = threading.RLock()


def _spec_lock(spec) -> threading.RLock:
    """The spec's build lock, attached on first demand (one per instance;
    design_filter's lru_cache makes that one-per-config)."""
    lk = spec.__dict__.get("_build_lock")
    if lk is None:
        with SPEC_BUILD_LOCK:
            lk = spec.__dict__.get("_build_lock")
            if lk is None:
                lk = threading.RLock()
                object.__setattr__(spec, "_build_lock", lk)
    return lk


class OverflowArgError(ValueError):
    """Raised where the C core would return RESAMPLER_ERR_OVERFLOW."""


# ---------------------------------------------------------------------------
# Window tables (algorithmic constants of the Speex design; values are data
# published in deps/speex/resample.c:148-192, required for bit parity).
# ---------------------------------------------------------------------------

_KAISER12 = np.array(
    [0.99859849, 1.00000000, 0.99859849, 0.99440475, 0.98745105, 0.97779076,
     0.96549770, 0.95066529, 0.93340547, 0.91384741, 0.89213598, 0.86843014,
     0.84290116, 0.81573067, 0.78710866, 0.75723148, 0.72629970, 0.69451601,
     0.66208321, 0.62920216, 0.59606986, 0.56287762, 0.52980938, 0.49704014,
     0.46473455, 0.43304576, 0.40211431, 0.37206735, 0.34301800, 0.31506490,
     0.28829195, 0.26276832, 0.23854851, 0.21567274, 0.19416736, 0.17404546,
     0.15530766, 0.13794294, 0.12192957, 0.10723616, 0.09382272, 0.08164178,
     0.07063950, 0.06075685, 0.05193064, 0.04409466, 0.03718069, 0.03111947,
     0.02584161, 0.02127838, 0.01736250, 0.01402878, 0.01121463, 0.00886058,
     0.00691064, 0.00531256, 0.00401805, 0.00298291, 0.00216702, 0.00153438,
     0.00105297, 0.00069463, 0.00043489, 0.00025272, 0.00013031, 0.0000527734,
     0.00001000, 0.00000000], dtype=F64)

_KAISER10 = np.array(
    [0.99537781, 1.00000000, 0.99537781, 0.98162644, 0.95908712, 0.92831446,
     0.89005583, 0.84522401, 0.79486424, 0.74011713, 0.68217934, 0.62226347,
     0.56155915, 0.50119680, 0.44221549, 0.38553619, 0.33194107, 0.28205962,
     0.23636152, 0.19515633, 0.15859932, 0.12670280, 0.09935205, 0.07632451,
     0.05731132, 0.04193980, 0.02979584, 0.02044510, 0.01345224, 0.00839739,
     0.00488951, 0.00257636, 0.00115101, 0.00035515, 0.00000000, 0.00000000],
    dtype=F64)

_KAISER8 = np.array(
    [0.99635258, 1.00000000, 0.99635258, 0.98548012, 0.96759014, 0.94302200,
     0.91223751, 0.87580811, 0.83439927, 0.78875245, 0.73966538, 0.68797126,
     0.63451750, 0.58014482, 0.52566725, 0.47185369, 0.41941150, 0.36897272,
     0.32108304, 0.27619388, 0.23465776, 0.19672670, 0.16255380, 0.13219758,
     0.10562887, 0.08273982, 0.06335451, 0.04724088, 0.03412321, 0.02369490,
     0.01563093, 0.00959968, 0.00527363, 0.00233883, 0.00050000, 0.00000000],
    dtype=F64)

_KAISER6 = np.array(
    [0.99733006, 1.00000000, 0.99733006, 0.98935595, 0.97618418, 0.95799003,
     0.93501423, 0.90755855, 0.87598009, 0.84068475, 0.80211977, 0.76076565,
     0.71712752, 0.67172623, 0.62508937, 0.57774224, 0.53019925, 0.48295561,
     0.43647969, 0.39120616, 0.34752997, 0.30580127, 0.26632152, 0.22934058,
     0.19505503, 0.16360756, 0.13508755, 0.10953262, 0.08693120, 0.06722600,
     0.05031820, 0.03607231, 0.02432151, 0.01487334, 0.00752000, 0.00000000],
    dtype=F64)

# window table + its oversample factor (FuncDef, resample.c:194-206)
_WINDOWS = {
    "kaiser12": (_KAISER12, 64),
    "kaiser10": (_KAISER10, 32),
    "kaiser8": (_KAISER8, 32),
    "kaiser6": (_KAISER6, 32),
}


@dataclasses.dataclass(frozen=True)
class QualityEntry:
    base_length: int
    oversample: int
    downsample_bandwidth: float  # stored as the f32 value the C table holds
    upsample_bandwidth: float
    window: str


# quality_map, resample.c:226-238
QUALITY_MAP: tuple[QualityEntry, ...] = (
    QualityEntry(8, 4, 0.830, 0.860, "kaiser6"),     # Q0
    QualityEntry(16, 4, 0.850, 0.880, "kaiser6"),    # Q1
    QualityEntry(32, 4, 0.882, 0.910, "kaiser6"),    # Q2
    QualityEntry(48, 8, 0.895, 0.917, "kaiser8"),    # Q3
    QualityEntry(64, 8, 0.921, 0.940, "kaiser8"),    # Q4
    QualityEntry(80, 16, 0.922, 0.940, "kaiser10"),  # Q5
    QualityEntry(96, 16, 0.940, 0.945, "kaiser10"),  # Q6
    QualityEntry(128, 16, 0.950, 0.950, "kaiser10"), # Q7
    QualityEntry(160, 16, 0.960, 0.960, "kaiser10"), # Q8
    QualityEntry(192, 32, 0.968, 0.968, "kaiser12"), # Q9
    QualityEntry(256, 32, 0.975, 0.975, "kaiser12"), # Q10
)


def compute_gcd(a: int, b: int) -> int:
    """GCD, resample.c:1095-1105."""
    return math.gcd(a, b)


def multiply_frac(value: int, num: int, den: int) -> int:
    """Overflow-guarded ``value * num / den`` in uint32, resample.c:593-603."""
    major, remain = divmod(value, den)
    if (remain > _UINT32_MAX // num or major > _UINT32_MAX // num
            or major * num > _UINT32_MAX - remain * num // den):
        raise OverflowArgError("rational scaling overflows uint32")
    return remain * num // den + major * num


# ---------------------------------------------------------------------------
# Window / sinc evaluation with exact C float semantics.
#
# The C expressions mix f32 and f64: float locals and float-typed parameters
# round intermediate values to f32; double literals promote products to f64.
# Each np.float32(...) cast below marks a place where C stores/passes a float.
# ---------------------------------------------------------------------------

def _compute_func(x_f32: np.ndarray, window: str) -> np.ndarray:
    """Vectorized compute_func (resample.c:240-258). x is the f32 argument;
    returns float64 exactly like the C double return value."""
    table, oversample = _WINDOWS[window]
    x = x_f32.astype(F32)
    y = (x * F32(oversample)).astype(F32)          # float y = x*oversample
    ind = np.floor(y.astype(F64)).astype(np.int64)  # (int)floor(y)
    # callers mask |x| > N/2 (sinc returns 0 there, resample.c:294) — clip so
    # the vectorized gather stays in range for those lanes
    ind = np.clip(ind, 0, len(_WINDOWS[window][0]) - 4)
    frac = (y - ind.astype(F32)).astype(F32)        # float frac
    f = frac.astype(F64)
    # frac*frac and frac*frac*frac are computed in f32 in C (float*float)
    f2_32 = (frac * frac).astype(F32)
    f3_32 = (f2_32 * frac).astype(F32)
    f2 = f2_32.astype(F64)
    f3 = f3_32.astype(F64)
    interp3 = F64(-0.1666666667) * f + F64(0.1666666667) * f3
    interp2 = f + F64(0.5) * f2 - F64(0.5) * f3
    interp0 = F64(-0.3333333333) * f + F64(0.5) * f2 - F64(0.1666666667) * f3
    interp1 = F64(np.float32(1.0)) - interp3 - interp2 - interp0
    t = table
    return (interp0 * t[ind] + interp1 * t[ind + 1]
            + interp2 * t[ind + 2] + interp3 * t[ind + 3])


def _sinc(cutoff_f32: np.float32, x_f32: np.ndarray, N: int,
          window: str) -> np.ndarray:
    """Vectorized float-build sinc() (resample.c:288-299). Returns f32 taps."""
    x = x_f32.astype(F32)
    cutoff = F32(cutoff_f32)
    xx = (x * cutoff).astype(F32)                       # float xx = x*cutoff
    ax = np.abs(x.astype(F64))
    pi_xx = F64(math.pi) * xx.astype(F64)
    with np.errstate(divide="ignore", invalid="ignore"):
        core = cutoff.astype(F64) * np.sin(pi_xx) / pi_xx
    win_arg = np.abs(F64(2.0) * x.astype(F64) / F64(N)).astype(F32)
    val = core * _compute_func(win_arg, window)
    out = np.where(ax < 1e-6, cutoff.astype(F64),
                   np.where(ax > 0.5 * N, F64(0.0), val))
    return out.astype(F32)


def _sinc_fixed(cutoff_f32: np.float32, x_f32: np.ndarray, N: int,
                window: str) -> np.ndarray:
    """Vectorized FIXED_POINT-build sinc() (resample.c:275-285).

    Same double-precision core as the float build but scaled by 32768 with
    the fixed-build WORD2INT (clamp then truncate toward zero) and the C
    expression's exact left-to-right association
    ``32768.*cutoff*sin(pi*xx)/(pi*xx) * compute_func(...)``."""
    from .fixed_math import word2int_fixed
    x = x_f32.astype(F32)
    cutoff = F32(cutoff_f32)
    xx = (x * cutoff).astype(F32)                       # float xx = x*cutoff
    ax = np.abs(x.astype(F64))
    pi_xx = F64(math.pi) * xx.astype(F64)
    with np.errstate(divide="ignore", invalid="ignore"):
        core = (F64(32768.0) * cutoff.astype(F64)) * np.sin(pi_xx) / pi_xx
    win_arg = np.abs(F64(2.0) * x.astype(F64) / F64(N)).astype(F32)
    val = core * _compute_func(win_arg, window)
    out_f64 = np.where(ax < 1e-6, F64(32768.0) * cutoff.astype(F64),
                       np.where(ax > 0.5 * N, F64(0.0), val))
    taps = word2int_fixed(out_f64)
    return np.where(ax > 0.5 * N, np.int16(0), taps)


def cubic_coef(frac_f32: np.ndarray) -> np.ndarray:
    """Vectorized float-build cubic_coef (resample.c:318-329).

    Returns shape (..., 4) f32 coefficients [interp0..interp3]; interp2 is
    computed as double(1.0) - others exactly like the C code."""
    frac = np.asarray(frac_f32, dtype=F32)
    # C evaluates e.g. 0.16667f*frac*frac*frac left-to-right in f32
    c16 = F32(0.16667)
    c33 = F32(0.33333)
    c05 = F32(0.5)
    i0 = (F32(-0.16667) * frac + ((c16 * frac) * frac) * frac).astype(F32)
    i1 = (frac + ((c05 * frac) * frac)
          - (((c05 * frac) * frac) * frac)).astype(F32)
    i3 = (F32(-0.33333) * frac + ((c05 * frac) * frac)
          - (((c16 * frac) * frac) * frac)).astype(F32)
    i2 = (F64(1.0) - i0.astype(F64) - i1.astype(F64)
          - i3.astype(F64)).astype(F32)
    return np.stack([i0, i1, i2, i3], axis=-1)


# ---------------------------------------------------------------------------
# Table construction (update_filter table-fill loops, resample.c:668-691).
# ---------------------------------------------------------------------------

def build_sinc_table_direct(cutoff_f32: np.float32, filt_len: int, den: int,
                            window: str) -> np.ndarray:
    """Direct path table, layout [den phases, filt_len taps]
    (resample.c:671-678, flattened there as i*filt_len+j)."""
    j = np.arange(filt_len, dtype=np.int64)
    i = np.arange(den, dtype=np.int64)
    # x = (j - filt_len/2 + 1) - i/den   with i/den an f32 division
    base = (j - filt_len // 2 + 1).astype(F32)[None, :]
    frac_i = (i.astype(F32) / F32(den)).astype(F32)[:, None]
    x = (base - frac_i).astype(F32)
    return _sinc(cutoff_f32, x, filt_len, window)  # [den, filt_len]


def build_sinc_table_interp(cutoff_f32: np.float32, filt_len: int,
                            oversample: int, window: str) -> np.ndarray:
    """Interpolated path table, length oversample*filt_len + 8, entries for
    i in [-4, oversample*filt_len+4) stored at index i+4 (resample.c:689-691).
    """
    i = np.arange(-4, oversample * filt_len + 4, dtype=np.int64)
    x = (i.astype(F32) / F32(oversample)).astype(F32) - F32(filt_len // 2)
    return _sinc(cutoff_f32, x.astype(F32), filt_len, window)


def build_sinc_table_direct_fixed(cutoff_f32: np.float32, filt_len: int,
                                  den: int, window: str) -> np.ndarray:
    """Direct path table for the FIXED_POINT build: same x grid as the float
    build (resample.c:671-678) through the fixed sinc(); int16 [den, N]."""
    j = np.arange(filt_len, dtype=np.int64)
    i = np.arange(den, dtype=np.int64)
    base = (j - filt_len // 2 + 1).astype(F32)[None, :]
    frac_i = (i.astype(F32) / F32(den)).astype(F32)[:, None]
    x = (base - frac_i).astype(F32)
    return _sinc_fixed(cutoff_f32, x, filt_len, window)


def build_sinc_table_interp_fixed(cutoff_f32: np.float32, filt_len: int,
                                  oversample: int, window: str) -> np.ndarray:
    """Interpolated path table for the FIXED_POINT build (resample.c:689-691
    grid through the fixed sinc()); int16, length oversample*filt_len + 8."""
    i = np.arange(-4, oversample * filt_len + 4, dtype=np.int64)
    x = (i.astype(F32) / F32(oversample)).astype(F32) - F32(filt_len // 2)
    return _sinc_fixed(cutoff_f32, x.astype(F32), filt_len, window)


def fixed_interp_tensors(sinc_table: np.ndarray, filt_len: int,
                         oversample: int, den: int
                         ) -> tuple[np.ndarray, np.ndarray]:
    """Per-phase tap tensor + Q15 cubic coefficients for the FIXED_POINT
    interpolated hot loop (resampler_basic_interpolate_single,
    resample.c:438-496, fixed branches).

    Unlike the float build, the cubic mixing CANNOT be folded into the taps:
    it happens on int32 accumulators through truncating-shift macros
    (MULT16_32_Q15 of SHR32(accum,1)), which are nonlinear in the taps.  The
    exact formulation keeps the four accumulators explicit:

        accum[k] = sum_j in[j] * W4[f, k, j]      (int32, wrapping)
        out      = interp_mix_fixed(accum, coef[f])

    Returns (W4 int16 [den, 4, filt_len], coef int16 [den, 4])."""
    return fixed_interp_rows(sinc_table, filt_len, oversample, den,
                             np.arange(den, dtype=np.int64))


def fixed_interp_rows(sinc_table: np.ndarray, filt_len: int,
                      oversample: int, den: int, f: np.ndarray
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Rows of fixed_interp_tensors for the given phases only.

    Each row depends solely on its own f value, so a subset is bit-identical
    to slicing the full tensors — this is what lets huge-den configs (the
    gather serving path) avoid materializing all ``den`` rows."""
    from .fixed_math import cubic_coef_fixed, pdiv32
    f = np.asarray(f, dtype=np.int64)
    # samp_frac_num*oversample is uint32 arithmetic in C (wraps mod 2^32)
    prod = (f * oversample) & 0xFFFFFFFF
    offset = (prod // den).astype(np.int64)
    rem = (prod % den).astype(np.int64)
    # frac = PDIV32(SHL32(rem,15), den): the uint32 shift wraps, PDIV32 casts
    # to int32 and divides toward zero
    shl = ((rem << 15) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    frac = pdiv32(shl, np.int32(den))
    coef = cubic_coef_fixed(frac)  # [den, 4] int16
    j = np.arange(filt_len, dtype=np.int64)
    base = 4 + (j + 1)[None, :] * oversample - offset[:, None] - 2
    idx = base[:, :, None] + np.arange(4)[None, None, :]  # [den, N, 4]
    w4 = sinc_table[idx].transpose(0, 2, 1)  # [den, 4, N] int16
    return np.ascontiguousarray(w4), coef


def effective_phase_table(sinc_table: np.ndarray, filt_len: int,
                          oversample: int, den: int) -> np.ndarray:
    """Collapse the interpolated path into per-phase effective taps.

    The reference hot loop (resampler_basic_interpolate_*, resample.c:438-559)
    computes, for fractional phase f = samp_frac_num in [0, den):
        offset = f*oversample // den
        frac   = f32((f*oversample) % den) / f32(den)
        out    = sum_c interp_c(frac) * sum_j in[j] * T[4+(j+1)*ov - offset - 2 + c]
    Because the phase sequence is periodic with period den, there are exactly
    den distinct effective filters
        H[f, j] = sum_c interp_c(frac_f) * T[4+(j+1)*ov - offset_f - 2 + c]
    which we precompute here (f64 combine of the f32 table and f32 cubic
    coefficients, rounded once to f32).  This turns the interpolated path
    into the same phase-indexed dot product as the direct path, which is the
    shape the TPU matmul kernel wants.  Deviation from the reference is only
    float reassociation, bounded well under 1 LSB of the s16 output.
    """
    return effective_phase_rows(sinc_table, filt_len, oversample, den,
                                np.arange(den, dtype=np.uint64))


def effective_phase_rows(sinc_table: np.ndarray, filt_len: int,
                         oversample: int, den: int,
                         f: np.ndarray) -> np.ndarray:
    """Rows of effective_phase_table for the given phases only.

    Row f depends solely on its own phase value, so computing a subset is
    bit-identical to slicing the full table.  Huge-den configs (reduced
    den in the tens of thousands and up, served by the gather kernel) use
    this to avoid the O(den * filt_len) table the dense paths want — the C
    reference never materializes per-phase effective taps at all for the
    interpolated path (resample.c:438-559 interpolates on the fly)."""
    f = np.asarray(f).astype(np.uint64)
    offset = (f * np.uint64(oversample) // np.uint64(den)).astype(np.int64)
    rem = (f * np.uint64(oversample) % np.uint64(den)).astype(np.int64)
    frac = (rem.astype(F32) / F32(den)).astype(F32)
    interp = cubic_coef(frac).astype(F64)  # [den, 4]
    j = np.arange(filt_len, dtype=np.int64)
    # idx[f, j, c] = 4 + (j+1)*ov - offset_f - 2 + c, c in 0..3
    base = 4 + (j + 1)[None, :] * oversample - offset[:, None] - 2
    idx = base[:, :, None] + np.arange(4)[None, None, :]
    taps = sinc_table.astype(F64)[idx]  # [den, filt_len, 4]
    return np.einsum("fjc,fc->fj", taps, interp).astype(F32)


# ---------------------------------------------------------------------------
# Full filter design (update_filter equivalent).
# ---------------------------------------------------------------------------

# Full collapsed tables are materialized (and cached on the spec) only up
# to this many entries; beyond it, row accessors compute just the rows a
# launch needs.  The cutover matches where the engines stop using dense/
# tiled weights anyway: huge-den configs serve through gather kernels whose
# weights are per-output rows, never the full [den, filt_len] table.
_LAZY_TABLE_ENTRIES = 1 << 22


@dataclasses.dataclass(frozen=True)
class FilterSpec:
    """Immutable result of filter design for one (quality, num/den) config.

    ``phase_table`` is the [den, filt_len] f32 matrix of effective taps: row
    f holds the FIR taps used when samp_frac_num == f.  For the direct path
    it is the reference sinc table verbatim; for the interpolated path it is
    the cubic-collapsed table (see effective_phase_table).  ``sinc_table``
    preserves the reference's raw table layout for parity tests.

    The collapsed tables (``phase_table`` for the float interpolated path;
    ``interp_taps``/``interp_coef`` for the fixed one) are built LAZILY on
    first attribute access: for pathological reduced denominators (e.g.
    44100 -> 44101 gives den = 44101 coprime phases) the full table is
    O(den * filt_len) — hundreds of MB and minutes of host time — while the
    gather serving path only ever needs the rows of the phases in flight.
    Use ``phase_rows`` / ``interp_rows`` to fetch per-output rows without
    forcing the full table.
    """
    num: int                 # reduced ratio numerator (input rate side)
    den: int                 # reduced ratio denominator (output rate side)
    quality: int
    filt_len: int
    oversample: int
    use_direct: bool
    cutoff: float            # f32 value
    int_advance: int
    frac_advance: int
    sinc_table: np.ndarray   # reference-layout raw table (1-D; f32, or
                             # int16 for the fixed universe)
    fixed_point: bool = False
    # Lazily-built caches; access through the properties / row accessors.
    _phase_table: np.ndarray | None = None
    _interp_taps: np.ndarray | None = None
    _interp_coef: np.ndarray | None = None

    @property
    def phase_table(self) -> np.ndarray:
        """[den, filt_len] effective taps (f32; for the fixed universe:
        int16, direct path only — fixed interp keeps a (0, N) sentinel so
        accumulator-mean shapes stay out of phase_table consumers)."""
        if self._phase_table is None:
            with _spec_lock(self):
                if self._phase_table is None:  # double-checked under lock
                    if self.fixed_point and not self.use_direct:
                        t = np.zeros((0, self.filt_len), dtype=np.int16)
                    else:
                        t = effective_phase_table(
                            self.sinc_table, self.filt_len,
                            self.oversample, self.den)
                    object.__setattr__(self, "_phase_table", t)
        return self._phase_table

    @property
    def interp_taps(self) -> np.ndarray | None:
        """int16 [den, 4, filt_len] — FIXED_POINT interpolated universe
        only (the integer cubic mix is nonlinear in the taps, so the four
        accumulators stay explicit; see fixed_interp_tensors)."""
        self._ensure_interp()
        return self._interp_taps

    @property
    def interp_coef(self) -> np.ndarray | None:
        """int16 [den, 4] Q15 cubic coefficients (fixed interp only)."""
        self._ensure_interp()
        return self._interp_coef

    def _ensure_interp(self) -> None:
        if self._interp_taps is None and self.fixed_point \
                and not self.use_direct:
            with _spec_lock(self):
                if self._interp_taps is not None:  # lost the build race
                    return
                taps, coef = fixed_interp_tensors(
                    self.sinc_table, self.filt_len, self.oversample,
                    self.den)
                # coef first: _interp_taps is the "built" gate lock-free
                # readers check, so it must be attached LAST
                object.__setattr__(self, "_interp_coef", coef)
                object.__setattr__(self, "_interp_taps", taps)

    def _materialize_tables(self) -> bool:
        """Whether full-table indexing is the right way to serve row
        requests (cheap table, cached across launches) vs computing just
        the requested rows (huge den)."""
        return (self._phase_table is not None
                or self._interp_taps is not None
                or self.use_direct
                or self.den * self.filt_len <= _LAZY_TABLE_ENTRIES)

    def phase_rows(self, phases: np.ndarray) -> np.ndarray:
        """phase_table[phases] without forcing the full table for huge-den
        configs.  Bit-identical to indexing (rows are independent)."""
        if self._materialize_tables():
            return self.phase_table[phases]
        u, inv = np.unique(np.asarray(phases, dtype=np.int64),
                           return_inverse=True)
        return effective_phase_rows(self.sinc_table, self.filt_len,
                                    self.oversample, self.den, u)[inv]

    def interp_rows(self, phases: np.ndarray
                    ) -> tuple[np.ndarray, np.ndarray]:
        """(interp_taps[phases], interp_coef[phases]) without forcing the
        full tensors for huge-den fixed configs."""
        if self._materialize_tables():
            return self.interp_taps[phases], self.interp_coef[phases]
        u, inv = np.unique(np.asarray(phases, dtype=np.int64),
                           return_inverse=True)
        taps, coef = fixed_interp_rows(self.sinc_table, self.filt_len,
                                       self.oversample, self.den, u)
        return taps[inv], coef[inv]

    @property
    def input_latency(self) -> int:
        """resample.c:1190-1193."""
        return self.filt_len // 2

    @property
    def output_latency(self) -> int:
        """resample.c:1195-1198."""
        return ((self.filt_len // 2) * self.den + (self.num >> 1)) // self.num


@lru_cache(maxsize=64)
def design_filter(num: int, den: int, quality: int,
                  fixed_point: bool = False,
                  full_sinc_table: bool = False) -> FilterSpec:
    """Equivalent of update_filter (resample.c:605-701) for a reduced ratio.

    ``num``/``den`` must already be GCD-reduced (speex_resampler_set_rate_frac
    reduces before update_filter runs, resample.c:1125-1128).

    ``fixed_point=True`` designs for the FIXED_POINT build universe: int16
    Q15 tables through the fixed sinc() (resample.c:275-285); geometry
    (filt_len, cutoff, advances, direct choice) is identical to the float
    build — only the table contents and hot-loop algebra differ.

    ``full_sinc_table=True`` mirrors the RESAMPLE_FULL_SINC_TABLE
    compile-time flag (resample.c:641-644): force the direct table even
    when the interpolated one would use less memory (raises
    OverflowArgError where the C build would fail its INT_MAX guard).
    """
    if not (0 <= quality <= 10):
        raise ValueError("quality must be in [0, 10]")
    if num <= 0 or den <= 0:
        raise ValueError("ratio must be positive")

    q = QUALITY_MAP[quality]
    int_advance = num // den
    frac_advance = num % den
    oversample = q.oversample
    filt_len = q.base_length

    if num > den:
        # down-sampling: scale cutoff down and filter length up
        # (resample.c:618-635)
        cutoff = F32(F32(q.downsample_bandwidth) * F32(den) / F32(num))
        filt_len = multiply_frac(filt_len, num, den)
        filt_len = ((filt_len - 1) & ~0x7) + 8  # round up to multiple of 8
        if 2 * den < num:
            oversample >>= 1
        if 4 * den < num:
            oversample >>= 1
        if 8 * den < num:
            oversample >>= 1
        if 16 * den < num:
            oversample >>= 1
        oversample = max(oversample, 1)
    else:
        cutoff = F32(q.upsample_bandwidth)

    # direct vs interpolated choice by table memory (resample.c:646-648);
    # RESAMPLE_FULL_SINC_TABLE forces direct (resample.c:641-644).  The
    # INT_MAX guards divide by sizeof(spx_word16_t): 4 in the float build,
    # 2 in the fixed build.
    word_size = 2 if fixed_point else 4
    if full_sinc_table:
        if (2**31 - 1) // word_size // den < filt_len:
            raise OverflowArgError("full sinc table exceeds INT_MAX")
        use_direct = True
    else:
        use_direct = (filt_len * den <= filt_len * oversample + 8
                      and (2**31 - 1) // word_size // den >= filt_len)

    window = q.window
    phase_table = None  # interp collapsed tables build lazily (huge den)
    if fixed_point:
        if use_direct:
            table2d = build_sinc_table_direct_fixed(cutoff, filt_len, den,
                                                    window)
            sinc_table = table2d.reshape(-1)
            phase_table = table2d
        else:
            sinc_table = build_sinc_table_interp_fixed(
                cutoff, filt_len, oversample, window)
    elif use_direct:
        table2d = build_sinc_table_direct(cutoff, filt_len, den, window)
        sinc_table = table2d.reshape(-1)
        phase_table = table2d
    else:
        sinc_table = build_sinc_table_interp(cutoff, filt_len, oversample,
                                             window)

    return FilterSpec(
        num=num, den=den, quality=quality, filt_len=filt_len,
        oversample=oversample, use_direct=use_direct, cutoff=float(cutoff),
        int_advance=int_advance, frac_advance=frac_advance,
        sinc_table=sinc_table, fixed_point=fixed_point,
        _phase_table=phase_table,
    )
