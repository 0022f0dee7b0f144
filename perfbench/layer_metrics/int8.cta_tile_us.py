"""``int8.cta_tile_us`` (us): a CTA's device time a tile of the port's
streamed int8 kernel (``streamed_fir_int8_kernel``, K2b): the port
kernels' device seconds in the traced calls over the calls (one launch a
call), times the CTAs a launch over the output tiles a launch.  Both come
from the totals of the port's counters (``speex.kernel.int8.ctas`` /
``.tiles`` in ``utils.profiling.counter_totals``), since every launch of a
cell is the same; ``run.py`` runs one cell a process.  None where the view
has no device operations or the program keeps no such counters."""

CTAS = "speex.kernel.int8.ctas"
TILES = "speex.kernel.int8.tiles"


def read(view):
    kernel_s = view.op_seconds(port=True)
    if not view.calls or not view.device or kernel_s <= 0:
        return None
    try:
        from speex_resampler_tpu_torch.utils.profiling import counter_totals
    except ImportError:
        return None
    totals = counter_totals()
    ctas, tiles = totals.get(CTAS, 0), totals.get(TILES, 0)
    if ctas <= 0 or tiles <= 0:
        return None
    return 1e6 * kernel_s / view.calls * ctas / tiles
