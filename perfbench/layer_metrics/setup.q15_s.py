"""``setup.q15_s`` (s): the host seconds the port spent on the set-up work
that only its fixed (Q15) universe does, in this run's process: a fixed
step's int16 accumulator column sets and Q15 cubic coefficients, and the
balanced int8 split of its taps, from the port's own span table
(``speex.setup.q15`` in ``utils.profiling.span_totals``, nested in
``speex.setup.planes`` and ``speex.setup.upload``); ``run.py`` runs one
cell a process.  None where the view has no device operations or the
program keeps no such span."""

SPAN = "speex.setup.q15"


def read(view):
    if not view.device:
        return None
    try:
        from speex_resampler_tpu_torch.utils.profiling import span_totals
    except ImportError:
        return None
    total = span_totals().get(SPAN)
    return None if total is None else float(total[1])
