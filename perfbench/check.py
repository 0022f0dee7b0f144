"""Whether the timed path's outputs are correct.

During the window :class:`CallSample` keeps the outputs of the calls to
be checked: the stream's first call (fresh history: the zero padding of
a new stream), its last, and ``k`` more drawn from the seed by reservoir
sampling over all the others.  It keeps a reference to each output
tensor the program returned and copies nothing, so the window's work is
unchanged.  Once the window has closed, the cell's entry
(``entries/<entry>.py``, its ``compare``) works every kept call out
again with the configuration's plain reference, from the inputs alone,
and :func:`judge` holds each number it reads against the configuration's
limit.
"""

from __future__ import annotations

import random


class CallSample:
    """The calls of a window whose outputs are checked (module
    docstring)."""

    def __init__(self, seed: int, k: int):
        self._rng = random.Random(f"perfbench-calls-{seed}")
        self.k = k
        self.first = None
        self.last = None
        self._reservoir: list = []
        self._seen = 0

    def offer(self, i: int, y) -> None:
        """Call ``i``'s output ``y`` (calls offered in order from 0)."""
        if i == 0:
            self.first = (i, y)
            return
        self.last = (i, y)
        self._seen += 1
        if len(self._reservoir) < self.k:
            self._reservoir.append((i, y))
        else:
            r = self._rng.randrange(self._seen)
            if r < self.k:
                self._reservoir[r] = (i, y)

    def kept(self) -> list:
        """[(call index, output)], by index, each call once."""
        calls = dict(self._reservoir)
        for item in (self.first, self.last):
            if item is not None:
                calls[item[0]] = item[1]
        return sorted(calls.items())


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) for every limit the
    configuration sets; a reading missing counts as a failure."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = readings.get(name)
        checks[name] = {"value": value, "limit": limit}
        ok = ok and value is not None and value <= limit
    return ok, checks
