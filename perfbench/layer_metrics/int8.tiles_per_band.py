"""``int8.tiles_per_band`` (tiles): the output tiles a band load served in
the port's streamed int8 kernel (``streamed_fir_int8_kernel``, K2b), where
its persistent CTAs hold each (phase, row tile) digit band resident in
shared memory and stage only x: the output tiles over the band loads of
the streamed int8 launches, from the totals of the port's counters
(``speex.kernel.int8.tiles`` / ``.bands`` in ``utils.profiling.
counter_totals``), since every launch of a cell is the same; ``run.py``
runs one cell a process.  None where the view has no device operations,
where no band was loaded (a CTA a tile, its band streamed with x) or
where the program keeps no such counters."""

TILES = "speex.kernel.int8.tiles"
BANDS = "speex.kernel.int8.bands"


def read(view):
    if not view.calls or not view.device:
        return None
    try:
        from speex_resampler_tpu_torch.utils.profiling import counter_totals
    except ImportError:
        return None
    totals = counter_totals()
    tiles, bands = totals.get(TILES, 0), totals.get(BANDS, 0)
    if tiles <= 0 or bands <= 0:
        return None
    return tiles / bands
