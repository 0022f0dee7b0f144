"""``fixed.tiles_per_band`` (tiles): the output tiles a band load served
in the port's persistent fixed kernel (``streamed_fir_fixed_kernel<4,
...>``, both phase-tiled geometries), where its CTAs hold each (phase,
row tile) weight band resident in shared memory and stream only x: the
output tiles over the band loads of the fixed launches, from the totals
of the port's counters (``speex.kernel.fixed.tiles`` / ``.bands`` in
``utils.profiling.counter_totals``), since every launch of a cell is the
same; ``run.py`` runs one cell a process.  None where the view has no
device operations, where no band was loaded (the streamed walk) or where
the program keeps no such counters."""

TILES = "speex.kernel.fixed.tiles"
BANDS = "speex.kernel.fixed.bands"


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
