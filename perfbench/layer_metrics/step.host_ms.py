"""``step.host_ms`` (ms): the port's own host time a traced call of its
stream step: the length of each ``speex.step`` span (the port's span
around one call of ``make_stream_fn``'s step) less the parts of it that
CUDA runtime and driver calls (``cuda*`` / ``cu*`` host events) and the
full command buffer's wait cover, summed over the spans and divided by
the traced calls.  In a cell the device paces, the launch queue is full
and a launch waits for a slot inside the runtime; taking the runtime's
calls out leaves the host work that the port itself does a call.  None
where the view has no device operations or the program records no
``speex.step`` span."""

import bisect
import re

STEP_SPAN = "speex.step"
_RUNTIME = re.compile(r"cu(da)?[A-Z]")
_BUFFER_FULL = "command buffer full"


def is_runtime(name: str) -> bool:
    """A CUDA runtime or driver call, or the full command buffer's wait."""
    return bool(_RUNTIME.match(name)) or \
        name.replace("_", " ").lower() == _BUFFER_FULL


def _merged(spans) -> list:
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def own_seconds(view, name: str) -> tuple:
    """(count, seconds) of the host spans ``name`` in ``view``, each less
    the parts of it that runtime calls cover."""
    spans = [(s, e) for n, s, e in view.host if n == name]
    runtime = _merged((s, e) for n, s, e in view.host if is_runtime(n))
    starts = [s for s, _ in runtime]
    own = 0.0
    for s, e in spans:
        covered = 0.0
        i = max(bisect.bisect_right(starts, s) - 1, 0)
        while i < len(runtime) and runtime[i][0] < e:
            covered += max(0.0, min(e, runtime[i][1])
                           - max(s, runtime[i][0]))
            i += 1
        own += (e - s) - covered
    return len(spans), own


def read(view):
    if not view.calls or not view.device:
        return None
    n, own = own_seconds(view, STEP_SPAN)
    return 1e3 * own / view.calls if n else None
