"""A frozen copy of Speex's float-build filter design (``resample.c``
``update_filter`` and the functions it calls), for the benchmark's plain
reference.

It reproduces the tables of the reference build (``-DFLOATING_POINT``)
with the C code's mixed float32 / float64 arithmetic: the quality map,
the Kaiser window tables, ``compute_func``, ``sinc``, ``cubic_coef`` and
the table fill of the direct and the interpolated paths.  It is kept
apart from the program under test on purpose: the reference designs its
filter itself and takes no table, weight or scale from the program.

Source: speexdsp ``libspeexdsp/resample.c`` (quality_map, the window
tables, ``compute_func``, ``sinc``, ``cubic_coef``, ``update_filter``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

F32 = np.float32
F64 = np.float64

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

# window table and its oversample factor (FuncDef)
_WINDOWS = {
    "kaiser12": (_KAISER12, 64),
    "kaiser10": (_KAISER10, 32),
    "kaiser8": (_KAISER8, 32),
    "kaiser6": (_KAISER6, 32),
}

# quality_map: base length, oversample, downsample and upsample bandwidth,
# window
QUALITY_MAP = (
    (8, 4, 0.830, 0.860, "kaiser6"),
    (16, 4, 0.850, 0.880, "kaiser6"),
    (32, 4, 0.882, 0.910, "kaiser6"),
    (48, 8, 0.895, 0.917, "kaiser8"),
    (64, 8, 0.921, 0.940, "kaiser8"),
    (80, 16, 0.922, 0.940, "kaiser10"),
    (96, 16, 0.940, 0.945, "kaiser10"),
    (128, 16, 0.950, 0.950, "kaiser10"),
    (160, 16, 0.960, 0.960, "kaiser10"),
    (192, 32, 0.968, 0.968, "kaiser12"),
    (256, 32, 0.975, 0.975, "kaiser12"),
)

_UINT32_MAX = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class Design:
    """One configuration's filter, as ``update_filter`` leaves it."""
    num: int            # reduced input rate
    den: int            # reduced output rate
    quality: int
    filt_len: int
    oversample: int
    use_direct: bool
    sinc_table: np.ndarray  # float32, the C layout


def _multiply_frac(value: int, num: int, den: int) -> int:
    major, remain = divmod(value, den)
    if (remain > _UINT32_MAX // num or major > _UINT32_MAX // num
            or major * num > _UINT32_MAX - remain * num // den):
        raise ValueError("rational scaling overflows uint32")
    return remain * num // den + major * num


def _compute_func(x_f32: np.ndarray, window: str) -> np.ndarray:
    table, oversample = _WINDOWS[window]
    x = x_f32.astype(F32)
    y = (x * F32(oversample)).astype(F32)
    ind = np.floor(y.astype(F64)).astype(np.int64)
    ind = np.clip(ind, 0, len(table) - 4)
    frac = (y - ind.astype(F32)).astype(F32)
    f = frac.astype(F64)
    f2_32 = (frac * frac).astype(F32)
    f3_32 = (f2_32 * frac).astype(F32)
    f2 = f2_32.astype(F64)
    f3 = f3_32.astype(F64)
    interp3 = F64(-0.1666666667) * f + F64(0.1666666667) * f3
    interp2 = f + F64(0.5) * f2 - F64(0.5) * f3
    interp0 = F64(-0.3333333333) * f + F64(0.5) * f2 - F64(0.1666666667) * f3
    interp1 = F64(np.float32(1.0)) - interp3 - interp2 - interp0
    return (interp0 * table[ind] + interp1 * table[ind + 1]
            + interp2 * table[ind + 2] + interp3 * table[ind + 3])


def _sinc(cutoff_f32: np.float32, x_f32: np.ndarray, N: int,
          window: str) -> np.ndarray:
    x = x_f32.astype(F32)
    cutoff = F32(cutoff_f32)
    xx = (x * cutoff).astype(F32)
    ax = np.abs(x.astype(F64))
    pi_xx = F64(math.pi) * xx.astype(F64)
    with np.errstate(divide="ignore", invalid="ignore"):
        core = cutoff.astype(F64) * np.sin(pi_xx) / pi_xx
    win_arg = np.abs(F64(2.0) * x.astype(F64) / F64(N)).astype(F32)
    val = core * _compute_func(win_arg, window)
    out = np.where(ax < 1e-6, cutoff.astype(F64),
                   np.where(ax > 0.5 * N, F64(0.0), val))
    return out.astype(F32)


def cubic_coef(frac_f32: np.ndarray) -> np.ndarray:
    """``cubic_coef`` of the float build: [..., 4] float32, interp2 as
    double 1.0 less the others."""
    frac = np.asarray(frac_f32, dtype=F32)
    c16, c05 = F32(0.16667), F32(0.5)
    i0 = (F32(-0.16667) * frac + ((c16 * frac) * frac) * frac).astype(F32)
    i1 = (frac + ((c05 * frac) * frac)
          - (((c05 * frac) * frac) * frac)).astype(F32)
    i3 = (F32(-0.33333) * frac + ((c05 * frac) * frac)
          - (((c16 * frac) * frac) * frac)).astype(F32)
    i2 = (F64(1.0) - i0.astype(F64) - i1.astype(F64)
          - i3.astype(F64)).astype(F32)
    return np.stack([i0, i1, i2, i3], axis=-1)


def design(in_rate: int, out_rate: int, quality: int) -> Design:
    """``update_filter`` of the float build for a (rate, rate, quality)."""
    g = math.gcd(in_rate, out_rate)
    num, den = in_rate // g, out_rate // g
    base, oversample, down_bw, up_bw, window = QUALITY_MAP[quality]
    filt_len = base
    if num > den:
        cutoff = F32(F32(down_bw) * F32(den) / F32(num))
        filt_len = _multiply_frac(filt_len, num, den)
        filt_len = ((filt_len - 1) & ~0x7) + 8
        for k in (2, 4, 8, 16):
            if k * den < num:
                oversample >>= 1
        oversample = max(oversample, 1)
    else:
        cutoff = F32(up_bw)
    use_direct = (filt_len * den <= filt_len * oversample + 8
                  and (2**31 - 1) // 4 // den >= filt_len)
    if use_direct:
        j = np.arange(filt_len, dtype=np.int64)
        i = np.arange(den, dtype=np.int64)
        base_x = (j - filt_len // 2 + 1).astype(F32)[None, :]
        frac_i = (i.astype(F32) / F32(den)).astype(F32)[:, None]
        table = _sinc(cutoff, (base_x - frac_i).astype(F32), filt_len,
                      window).reshape(-1)
    else:
        i = np.arange(-4, oversample * filt_len + 4, dtype=np.int64)
        x = (i.astype(F32) / F32(oversample)).astype(F32) - F32(filt_len // 2)
        table = _sinc(cutoff, x.astype(F32), filt_len, window)
    return Design(num=num, den=den, quality=quality, filt_len=filt_len,
                  oversample=oversample, use_direct=use_direct,
                  sinc_table=table)


def phase_filters(d: Design, phases: np.ndarray) -> np.ndarray:
    """float64 [len(phases), filt_len]: the taps that output phase
    ``samp_frac_num`` = f applies to its window.  Direct path: the table's
    row.  Interpolated path: the four table columns that the C loop sums
    into ``accum[0..3]``, mixed by ``cubic_coef`` (float32, as C computes
    it) in float64, which equals C's mix of the four sums up to the
    rounding of its own accumulators."""
    f = np.asarray(phases, dtype=np.int64)
    N = d.filt_len
    if d.use_direct:
        return d.sinc_table.reshape(d.den, N)[f].astype(F64)
    prod = f * d.oversample
    offset = prod // d.den
    frac = ((prod % d.den).astype(F32) / F32(d.den)).astype(F32)
    interp = cubic_coef(frac).astype(F64)                       # [n, 4]
    j = np.arange(N, dtype=np.int64)
    base = 4 + (j + 1)[None, :] * d.oversample - offset[:, None] - 2
    idx = base[:, :, None] + np.arange(4)[None, None, :]        # [n, N, 4]
    return np.einsum("fjc,fc->fj", d.sinc_table.astype(F64)[idx], interp)
