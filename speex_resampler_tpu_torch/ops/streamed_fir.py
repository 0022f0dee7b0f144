"""Phase-tiled polyphase FIR launch: the kernels of both phase-tiled
geometries.

Counterpart of ``resample_conv_tm_pallas_v4`` and ``_v3`` in
``speex_resampler_tpu/ops/pallas_fir.py``, schemes ``"highest"``,
``"int8"``, ``"fixed"`` (``n_accum`` 1 or 4) and ``"split5"``.  One
launcher serves both geometries of ``parallel/batch.py``: the "tiled" one
(small weight cycles, e.g. 44.1 kHz -> 48 kHz) and the "streamed" one
(weight cycles too large for it: every 48 kHz -> 44.1 kHz conversion, P =
147, 44.1 kHz -> 16 kHz at q7, P = 20, and, in the fixed universe, those
whose int16 column sets pass the 6 MB fixed tiled cap).  "Streamed" names
how its kernels read the weights: a tile at a time through shared memory,
beside x.

Output block k (R rows) reads K rows of the virtual axis ``hist ++ x`` from
the closed-form origin of ``_kernel_v4``

    v0(k) = floor16((f0 + k*R*num) // den + shift)

and applies the weights of block phase ``k % P``.  ``shift`` is
``H - (filt_len - 1)``; ``v0`` equals the tiled geometry's
``(k // P) * S + offsets[k % P]``, so no offset table is needed.

Device weights are ``tiled_fir.device_weights``'s
(:func:`device_weights_streamed` gives a streamed step's): a tiled step's
K is the phase-tiled weights' own (the int8 and fixed planes padded to a
multiple of 32), a streamed step's ``K_pad``, a multiple of 128, as the
JAX package pads them.  A tiled "int8" step whose widest band fits the
resident kernel's shared memory keeps ``(planes, bias, slices, taps)``,
``slices`` an int, and launches it (``csrc/tiled_fir.cu``,
``tiled_fir_int8_kernel``: a row tile's digit band held across the output
tiles that share it); every other int8 step carries ``(planes, bias,
bands, taps)``, ``bands`` the ``tiled_fir.BandWidths`` of its tap table,
and launches the streamed kernel (:func:`int8_launch_weights` makes that
choice once, when the step is built; the type of the third entry tells
the two apart).

The JAX package streams ``[P, R, K_pad]`` (``[P, D, R, K_pad]`` planes;
fixed: int8 ``[P, 2, C, K_pad]`` planes and an int32 bias; split5: bf16
``[P, 3, R, K_pad]``); ``parallel/batch.weights_from_jax`` converts.  The
tap table skips the zero rows of each tile's columns (64; fixed:
``tiled_fir.FIXED_ROWS``), the K_pad padding among them.

:func:`resample_streamed` launches the CUDA kernel
(``csrc/streamed_fir.cu``, or the resident one) for CUDA tensors and runs
:func:`resample_streamed_reference`, its plain PyTorch version, for CPU
tensors.  It never falls back from one to the other.
"""

from __future__ import annotations

import bisect
import ctypes
import functools
import itertools

import torch

from ..utils.profiling import count, span
from . import _build
from . import tiled_fir as tf
from .tiled_fir import K_PERM, int8_k_major, int8_n_major

__all__ = ["device_weights_streamed", "int8_launch_weights", "origins",
           "resample_streamed", "resample_streamed_reference", "K_PERM",
           "int8_k_major", "int8_n_major"]

#: Launches of each CUDA kernel in this process, by scheme, the resident
#: int8 kernel's under "int8_resident"; only resample_streamed adds to it,
#: once per launch.  Callers reset the counts to count one run.
launches = {"highest": 0, "int8": 0, "int8_resident": 0, "fixed": 0,
            "split5": 0}
#: the port's counters (``utils/profiling.count``) of the fixed launches,
#: the CTAs they launched (persistent CTAs walk many output tiles each),
#: their output tiles (block, row tile, 64-lane tile) and the band loads
#: of the persistent CTAs that hold each (phase, row tile) weight band
#: resident (:func:`resident_bands`; 0 for a launch on the streamed walk):
#: tiles over CTAs is the tiles a CTA walked, tiles over bands the tiles
#: a band load served
FIXED_LAUNCHES = "speex.kernel.fixed.launches"
FIXED_CTAS = "speex.kernel.fixed.ctas"
FIXED_TILES = "speex.kernel.fixed.tiles"
FIXED_BANDS = "speex.kernel.fixed.bands"
#: lanes of a fixed or int8 output tile (``csrc/int8_wgmma.cuh``'s kLanes)
TILE_LANES = 64
#: the port's counters of the streamed int8 kernel's launches (K2b, both
#: geometries; not the tiled resident kernel's), as the fixed ones: its
#: CTAs, its output tiles (block, 64-row tile, 64-lane tile) and the band
#: loads of the persistent CTAs that hold each band resident (0 where a
#: CTA takes one tile, its band streamed with x)
INT8_LAUNCHES = "speex.kernel.int8.launches"
INT8_CTAS = "speex.kernel.int8.ctas"
INT8_TILES = "speex.kernel.int8.tiles"
INT8_BANDS = "speex.kernel.int8.bands"


def device_weights_streamed(w, scheme: str, device, *,
                            k_major: bool = False) -> tuple:
    """Host weights -> a streamed step's device weights: the tiled
    conversion (``tiled_fir.device_weights``, ``k_major`` as there),
    applied to the K_pad-padded set, the "int8" tuple the streamed
    kernel's (:func:`_streamed_int8`)."""
    w = tf.device_weights(w, scheme, device, k_major=k_major)
    return _streamed_int8(w) if scheme == "int8" else w


def _streamed_int8(w: tuple) -> tuple:
    """The int8 device weights ``(planes, bias, slices, taps)`` -> the
    streamed kernel's ``(planes, bias, bands, taps)``: the slice count
    replaced by the tap table's ``tiled_fir.BandWidths``, from which the
    kernel's CTAs hold each band resident and balance their runs."""
    return (w[0], w[1], tf.band_widths(w[3].cpu().numpy()), w[3])


def int8_launch_weights(w: tuple) -> tuple:
    """A tiled step's int8 device weights ``(planes, bias, slices, taps)``
    as it launches them: as they are where the widest band fits the
    resident kernel (``tiled_fir_int8_max_slices`` of the planes' digit
    count), else the streamed kernel's ``(planes, bias, bands, taps)``.
    Asks the library, so CUDA weights only."""
    D, slices = w[0].shape[0], w[2]
    if slices <= _build.load().tiled_fir_int8_max_slices(D):
        return w
    return _streamed_int8(w)


def origins(n_blocks: int, R: int, *, shift: int, num: int, den: int,
            f0: int, device=None) -> torch.Tensor:
    """int64[n_blocks]: each block's patch origin on the virtual axis."""
    t = f0 + torch.arange(n_blocks, dtype=torch.int64, device=device) \
        * (R * num)
    return torch.div(t // den + shift, 16, rounding_mode="floor") * 16


def _check(hist, x, w, n_blocks, shift, num, den, f0, scheme, scales,
           n_accum):
    """Validate one launch; returns (P, K, R, resident): whether an int8
    launch takes the tiled resident kernel (its weights carry a slice
    count, an int, where the streamed kernel's carry their band
    widths)."""
    if scheme == "int8" and (len(w) != 4
                             or type(w[2]) not in (int, tf.BandWidths)):
        raise ValueError("int8 weights must be (planes, bias, bands, taps) "
                         "for the streamed kernel, bands a BandWidths, or "
                         "(planes, bias, slices, taps) for the resident "
                         "one, slices an int")
    P, K, R = tf.check_launch(hist, x, w, scheme, scales, n_accum)
    if n_blocks <= 0 or n_blocks % P or shift < 0 or num <= 0 \
            or not 0 <= f0 < den:
        raise ValueError(f"n_blocks {n_blocks}, P {P}, shift {shift}, "
                         f"num/den {num}/{den}, f0 {f0}")
    resident = scheme == "int8" and type(w[2]) is int
    if scheme == "int8" and not resident \
            and (len(w[2].slices) != P * (R // tf.ROW_TILE)
                 or w[2].widest > K // 32):
        raise ValueError("streamed int8 weights must carry their tap "
                         "table's BandWidths, each band in [1, K / 32] "
                         "K-slices")
    if resident:
        if not 0 <= w[2] <= K // 32:
            raise ValueError(f"slices {w[2]!r}: an int in [0, K / 32]")
        if (P * R * num) % den or (P * R * num // den) % 16:
            raise ValueError(f"P*R*num / den = {P * R * num / den}: the "
                             "resident kernel takes a period of a whole "
                             "multiple of 16 rows")
    return P, K, R, resident


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

    A fixed n_accum 4 launch whose widest band (the weights'
    ``tiled_fir.BandWidths``) fits the persistent CTA's two band buffers,
    and whose bands are each shared by enough tiles, holds each band
    resident, its CTAs' runs balanced by the bands' widths
    (``csrc/fixed_wgmma.cuh``'s ``fir_tiles``); the library decides from
    the widest band and the launch's shape, and the others stream the
    weights with x.  A streamed int8 launch (K2b) does the same with one
    band buffer where its digits pair up (``csrc/int8_wgmma.cuh``'s
    ``fir_tiles``), else a CTA takes one tile.

    Rows of the virtual axis at or past H + T_c read as zero.  CUDA
    tensors launch the kernel on the current stream (asynchronously; a
    launch error raises); CPU tensors run the plain version.  A fixed
    launch adds 1, its CTAs, its output tiles and its band loads to the
    counters ``FIXED_LAUNCHES``, ``FIXED_CTAS``, ``FIXED_TILES`` and
    ``FIXED_BANDS``, a streamed int8 launch (K2b) to ``INT8_LAUNCHES``,
    ``INT8_CTAS``, ``INT8_TILES`` and ``INT8_BANDS``."""
    P, K, R, resident = _check(hist, x, w, n_blocks, shift, num, den, f0,
                               scheme, scales, n_accum)
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
    if y.numel() == 0:
        return y
    with torch.cuda.device(x.device):
        stream = _build.stream_handle(x.device)
        geo = (H, x.shape[0], B, R, K, P, n_blocks, shift, num, den, f0,
               stream)
        head = (hist.data_ptr(), x.data_ptr(), y.data_ptr(),
                w[-1].data_ptr())
        s = tuple(scales) + (0.0,) * (4 - len(scales))
        if scheme == "highest":
            err = lib.streamed_fir_f32(*head, w[0].data_ptr(), *geo)
        elif scheme == "split5":
            err = lib.streamed_fir_split5(*head, w[0].data_ptr(), *geo)
        elif scheme == "fixed":
            coef = w[2].data_ptr() if n_accum == 4 else None
            ctas, band_tiles = ctypes.c_int(0), ctypes.c_int(0)
            err = lib.streamed_fir_fixed(*head, w[0].data_ptr(),
                                         w[1].data_ptr(), coef, n_accum,
                                         w[-2].widest, *geo,
                                         ctypes.byref(ctas),
                                         ctypes.byref(band_tiles))
        elif resident:
            err = lib.tiled_fir_int8(*head, w[0].data_ptr(), w[1].data_ptr(),
                                     len(scales), *s, w[2], *geo)
        else:
            ctas, band_tiles = ctypes.c_int(0), ctypes.c_int(0)
            err = lib.streamed_fir_int8(*head, w[0].data_ptr(),
                                        w[1].data_ptr(), len(scales), *s,
                                        w[2].widest, *geo, ctypes.byref(ctas),
                                        ctypes.byref(band_tiles))
    if err:
        raise RuntimeError("phase-tiled FIR kernel launch failed: "
                           + lib.streamed_fir_error_string(err).decode())
    launches["int8_resident" if resident else scheme] += 1
    if scheme == "fixed":
        count_fixed(ctas.value, fixed_tiles(n_blocks, R, B, n_accum),
                    resident_bands(w[-2], band_tiles.value, ctas.value))
    elif scheme == "int8" and not resident:
        count_int8(ctas.value, int8_tiles(n_blocks, R, B),
                   resident_bands(w[2], band_tiles.value, ctas.value))
    return y


def fixed_tiles(n_blocks: int, R: int, B: int, n_accum: int) -> int:
    """The output tiles (block, row tile, 64-lane tile) of a fixed launch
    of ``n_blocks`` blocks of R rows over B lanes."""
    return n_blocks * (R // tf.FIXED_ROWS[n_accum]) * -(-B // TILE_LANES)


def int8_tiles(n_blocks: int, R: int, B: int) -> int:
    """The output tiles (block, 64-row tile, 64-lane tile) of a streamed
    int8 launch of ``n_blocks`` blocks of R rows over B lanes."""
    return n_blocks * (R // tf.ROW_TILE) * -(-B // TILE_LANES)


def resident_runs(bands: tf.BandWidths, band_tiles: int, ctas: int) -> list:
    """Each CTA's run ``(first, last)`` of the output tiles of a persistent
    launch that holds its bands resident (the fixed n_accum 4 kernel's and
    the streamed int8 kernel's, both ``csrc/int8_wgmma.cuh``'s
    ``balanced_run``): the tiles in band-major order, ``band_tiles`` a
    band, a tile of band b weighing its ``bands.slices[b]`` K-slices; CTA
    c takes the tiles whose work starts in ``[c W / ctas, (c + 1) W /
    ctas)``, W the launch's, so the runs take as many K-slices, give or
    take a tile."""
    slices = bands.slices
    ends = list(itertools.accumulate(band_tiles * s for s in slices))
    work = ends[-1]

    def start(t: int) -> int:
        if t <= 0:
            return 0
        b = bisect.bisect_left(ends, t)
        at = ends[b] - band_tiles * slices[b]
        return b * band_tiles + -(-(t - at) // slices[b])

    bounds = [start(c * work // ctas) for c in range(ctas + 1)]
    return list(zip(bounds, bounds[1:]))


@functools.lru_cache(maxsize=64)
def resident_bands(bands: tf.BandWidths, band_tiles: int, ctas: int) -> int:
    """The band loads of a persistent launch that holds its bands resident
    (fixed or streamed int8): each CTA loads each band its run
    (:func:`resident_runs`) meets once.  0 where ``band_tiles`` is 0: the
    launch walked its weights streamed."""
    if band_tiles <= 0:
        return 0
    return sum((last - 1) // band_tiles - first // band_tiles + 1
               for first, last in resident_runs(bands, band_tiles, ctas)
               if last > first)


def count_fixed(ctas: int, tiles: int, bands: int = 0) -> None:
    """One fixed launch of ``ctas`` CTAs over ``tiles`` output tiles that
    loaded ``bands`` resident bands, into the port's counters."""
    count(FIXED_LAUNCHES)
    count(FIXED_CTAS, ctas)
    count(FIXED_TILES, tiles)
    count(FIXED_BANDS, bands)


def count_int8(ctas: int, tiles: int, bands: int = 0) -> None:
    """One streamed int8 launch of ``ctas`` CTAs over ``tiles`` output
    tiles that loaded ``bands`` resident bands, into the port's
    counters."""
    count(INT8_LAUNCHES)
    count(INT8_CTAS, ctas)
    count(INT8_TILES, tiles)
    count(INT8_BANDS, bands)


def resample_streamed_reference(hist: torch.Tensor, x: torch.Tensor,
                                w: tuple, *, n_blocks: int, shift: int,
                                num: int, den: int, f0: int = 0,
                                scheme: str = "highest", scales: tuple = (),
                                n_accum: int = 1) -> torch.Tensor:
    """Plain PyTorch version of :func:`resample_streamed` (same contract),
    on the tensors' own device: each block's patch is gathered by index
    from its closed-form origin, then one batched product over all blocks
    (``tiled_fir.apply_weights``): "highest" an f32 matmul with TF32 off;
    "split5" the five f32 matmuls of bf16-valued operands;
    "int8" the exact float64 digit dots, then the kernel's f32 epilogue in
    the same order; "fixed" the exact float64 int16 dots wrapped to int32,
    then the Q15 epilogue (the int8 planes back in tap order first,
    :func:`int8_n_major`; the fixed int16 taps rebuilt,
    ``tiled_fir.fixed_taps16``)."""
    P, K, R, _ = _check(hist, x, w, n_blocks, shift, num, den, f0, scheme,
                        scales, n_accum)
    v0 = origins(n_blocks, R, shift=shift, num=num, den=den, f0=f0,
                 device=x.device)
    if scheme == "int8":
        w = (int8_n_major(w[0]), w[1])
    return tf.apply_weights(hist, x, w, v0, scheme, scales, n_accum)
