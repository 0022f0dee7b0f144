"""``setup.upload_s`` (s): the host seconds the port spent putting its
steps' weights on the device in this run's process (the process's first
device allocation, so the CUDA context's creation falls in it), from the
port's own span table (``speex.setup.upload`` in ``utils.profiling.
span_totals``).  None where the view has no device operations or the
program keeps no such span."""

SPAN = "speex.setup.upload"


def read(view):
    if not view.device:
        return None
    try:
        from speex_resampler_tpu_torch.utils.profiling import span_totals
    except ImportError:
        return None
    total = span_totals().get(SPAN)
    return None if total is None else float(total[1])
