"""The resident fixed walk's witness: what the persistent fixed kernel's
CTAs did, read from the card.

The served walk (``csrc/fixed_wgmma.cuh``'s ``fir_tiles``, K1e's and K2d's
where their bands fit) is built here with a witness that records, for
each CTA, its run of band-major output tiles and the bands it loaded
(``csrc/probes/fixed_walk.cu``).  :func:`walk` launches it on a fixed
n_accum 4 launch and returns its output with that record, which tests
hold against the host's model of the walk: ``streamed_fir.resident_runs``
and ``resident_bands``, whose count the port's counter
``speex.kernel.fixed.bands`` adds up.  CPU tensors run the plain version:
the plain output and the model's record.
"""

from __future__ import annotations

import torch

from ..ops import _build
from ..ops import streamed_fir as sf
from ..ops import tiled_fir as tf

__all__ = ["walk", "walk_reference", "model_record"]


def _check(hist, x, w, n_blocks: int, ctas: int) -> tuple:
    P, K, R = tf.check_launch(hist, x, w, "fixed", (), 4)
    if n_blocks <= 0 or n_blocks % P or ctas < 1:
        raise ValueError(f"n_blocks {n_blocks}, P {P}, ctas {ctas}")
    return P, K, R


def model_record(bands: tf.BandWidths, band_tiles: int,
                 ctas: int) -> torch.Tensor:
    """The host's model of the record: int32[ctas, 3] of each CTA's run
    ``(first, last)`` (``streamed_fir.resident_runs``) and the bands it meets,
    each loaded once."""
    rows = [(first, last, (last - 1) // band_tiles - first // band_tiles + 1
             if last > first else 0)
            for first, last in sf.resident_runs(bands, band_tiles, ctas)]
    return torch.tensor(rows, dtype=torch.int32)


def walk_reference(hist, x, w, *, n_blocks: int, shift: int, num: int,
                   den: int, f0: int = 0, ctas: int) -> tuple:
    """Plain version of :func:`walk`: the plain launch's output
    (``streamed_fir.resample_streamed_reference``) and
    :func:`model_record` on the launch's tiles a band."""
    P, _, _ = _check(hist, x, w, n_blocks, ctas)
    y = sf.resample_streamed_reference(
        hist, x, w, n_blocks=n_blocks, shift=shift, num=num, den=den, f0=f0,
        scheme="fixed", n_accum=4)
    band_tiles = n_blocks // P * -(-x.shape[1] // sf.TILE_LANES)
    return y, model_record(w[-2], band_tiles, ctas)


def walk(hist, x, w, *, n_blocks: int, shift: int, num: int, den: int,
         f0: int = 0, ctas: int) -> tuple:
    """One fixed n_accum 4 launch (``streamed_fir.resample_streamed``'s
    arguments) on the resident walk over ``ctas`` CTAs: (int16[n_blocks *
    R, B], int32[ctas, 3] of each CTA's first and last tile and its band
    loads).  The launch must be one the served launcher walks resident
    (at least 6 tiles a band, its widest band within shared memory), else
    it raises.  Synchronizes."""
    if x.device.type == "cpu":
        return walk_reference(hist, x, w, n_blocks=n_blocks, shift=shift,
                              num=num, den=den, f0=f0, ctas=ctas)
    P, K, R = _check(hist, x, w, n_blocks, ctas)
    lib = _build.load_probes()
    H, B = hist.shape
    y = torch.empty((n_blocks * R, B), dtype=torch.int16, device=x.device)
    record = torch.full((ctas, 3), -1, dtype=torch.int32, device=x.device)
    err = lib.probe_fixed_walk(
        hist.data_ptr(), x.data_ptr(), y.data_ptr(), w[-1].data_ptr(),
        w[0].data_ptr(), w[1].data_ptr(), w[2].data_ptr(), w[-2].widest, H,
        x.shape[0], B, R, K, P, n_blocks, shift, num, den, f0, ctas,
        record.data_ptr(), _build.stream_handle(x.device))
    if err:
        raise RuntimeError("fixed walk probe failed: "
                           + lib.probe_error_string(err).decode())
    torch.cuda.synchronize(x.device)
    return y, record.cpu()
