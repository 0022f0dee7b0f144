"""``gather.cta_tile_us`` (us): a resident CTA's device time a tile of the
port's band and stream gather kernels (``csrc/gather_fir.cu``): the port
kernels' device seconds in the traced calls over the calls (one launch a
call), times the CTAs the card holds at once over the launch's (output
tile, 64-lane tile) units.  Both come from the totals of the port's
counters (``speex.kernel.gather.resident`` / ``.tiles`` in ``utils.
profiling.counter_totals``), since every launch of a cell is the same;
``run.py`` runs one cell a process.  None where the view has no device
operations or the program keeps no such counters."""

RESIDENT = "speex.kernel.gather.resident"
TILES = "speex.kernel.gather.tiles"


def read(view):
    kernel_s = view.op_seconds(port=True)
    if not view.calls or not view.device or kernel_s <= 0:
        return None
    try:
        from speex_resampler_tpu_torch.utils.profiling import counter_totals
    except ImportError:
        return None
    totals = counter_totals()
    resident, tiles = totals.get(RESIDENT, 0), totals.get(TILES, 0)
    if resident <= 0 or tiles <= 0:
        return None
    return 1e6 * kernel_s / view.calls * resident / tiles
