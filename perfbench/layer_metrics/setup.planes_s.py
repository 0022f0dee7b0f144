"""``setup.planes_s`` (s): the host seconds the port spent building its
steps' host weights (the phase-tiled tables, the scheme's certificate and
digit planes) in this run's process, from the port's own span table
(``speex.setup.planes`` in ``utils.profiling.span_totals``); ``run.py``
runs one cell a process.  None where the view has no device operations
or the program keeps no such span."""

SPAN = "speex.setup.planes"


def read(view):
    if not view.device:
        return None
    try:
        from speex_resampler_tpu_torch.utils.profiling import span_totals
    except ImportError:
        return None
    total = span_totals().get(SPAN)
    return None if total is None else float(total[1])
