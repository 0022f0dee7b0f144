"""Shared engine-level zero-fill degradation.

The reference degrades to the zero-output resampler on alloc failure so
callers ignoring error codes can't deadlock: resampler_basic_zero emits
zeros while advancing state identically (resample.c:561-591), installed by
the fn-ptr swap at :785-791.  At engine scale the analogous failure is a
device fault in a launch: an error raised while the launch is queued, or
an asynchronous one that surfaces where its result is read back.  This
mixin holds the one implementation ``BatchedResampler`` and
``FleetResampler`` share (the JAX package's ``utils/degrade.py``).

Healthy, ``self._hist`` is a tensor, or a list of tensors, one a lane
shard, under a ``BatchedResampler`` mesh (``parallel/mesh.py``); a
meshed launch's result is a list too, joined on lanes here.  Host state
contract while degraded: ``self._hist`` is a NumPy array of every lane,
every launch consumes and produces its exact sample counts as zeros, and
degradation is sticky like the C fn-ptr swap.

A fault is never hidden: entering the degraded mode stores the cause in
``degraded_cause``, logs it once at ERROR and emits a ``RuntimeWarning``;
``degraded_launches`` counts the launches served as zeros.  Only errors of
a launch or a readback degrade: a CUDA engine builds its kernel library in
its constructor, so a build failure raises there and can never be caught
here.

Requires on the subclass: ``_degraded`` (bool), ``_hist``, ``B``,
``_step.hist_rows``, ``bspec.in_per_launch`` / ``bspec.out_per_launch``.
"""

from __future__ import annotations

import logging
import warnings

import numpy as np
import torch

from ..parallel.mesh import join_lanes
from .host import Readback, to_host

__all__ = ["ZeroFillDegradation"]

_log = logging.getLogger(__name__)


class ZeroFillDegradation:
    """Mixin: engine-level zero-output degradation with exact accounting."""

    _degraded = False
    #: the exception that degraded the engine (None while healthy, and
    #: after a degraded checkpoint was loaded)
    degraded_cause: BaseException | None = None
    #: launches served by the zero-output path
    degraded_launches = 0

    @property
    def degraded(self) -> bool:
        """True once a device failure swapped in the zero-output path."""
        return self._degraded

    def _enter_degraded(self, exc: BaseException | None = None) -> None:
        """Swap onto the host zero-output path (resample.c:785-791).
        Sticky: like the C core, reset_mem does not reinstall the real
        resampler.  A history on the CPU is kept; one on a CUDA device is
        not read (after a fault such as an illegal address every CUDA call
        raises) and becomes zeros; a meshed history is kept where every
        shard is on the CPU.  Degraded output is all zeros either way, so
        the sample accounting, the only remaining contract, is
        unaffected."""
        if self._degraded:
            return
        self._degraded = True
        self.degraded_cause = exc
        _log.error("%s degraded to zero-fill output after a device fault: "
                   "%r", type(self).__name__, exc)
        warnings.warn(f"{type(self).__name__} degraded to zero-fill output "
                      f"after a device fault: {exc!r}", RuntimeWarning,
                      stacklevel=3)
        h = self._hist
        if isinstance(h, list) and all(t.device.type == "cpu" for t in h):
            h = join_lanes(h)
        if isinstance(h, torch.Tensor) and h.device.type == "cpu":
            self._hist = h.numpy().copy()
        elif isinstance(h, np.ndarray):
            self._hist = h.astype(np.int16, copy=True)
        else:
            self._hist = np.zeros((self._step.hist_rows, self.B),
                                  dtype=np.int16)

    def _adopt_degraded(self) -> None:
        """Enter the degraded mode from a loaded checkpoint that was
        taken degraded (no cause here; the warning still shows it)."""
        if self._degraded:
            return
        self._degraded = True
        warnings.warn(f"{type(self).__name__} loaded a degraded checkpoint: "
                      f"serving zero-fill output", RuntimeWarning,
                      stacklevel=3)

    def _hist_host(self) -> np.ndarray:
        """Blocking host view of the filter history; a device failure
        surfacing here degrades the engine instead of raising out of a
        control-path operation (flush/skip_zeros/state_dict)."""
        if self._degraded:
            return np.array(self._hist)
        try:
            h = self._hist
            if isinstance(h, list):
                h = join_lanes(h, "cpu")
            return h.detach().cpu().numpy().copy()
        except Exception as exc:
            self._enter_degraded(exc)
            return np.array(self._hist)

    def _result_shape(self) -> tuple:
        """Shape of one launch's host result (time-major here)."""
        return (self.bspec.out_per_launch, self.B)

    def _zero_result(self) -> np.ndarray:
        """One launch's result served as zeros (counted)."""
        self.degraded_launches += 1
        return np.zeros(self._result_shape(), dtype=np.int16)

    def _recv(self, y) -> np.ndarray:
        """Blocking readback of a dispatched launch result: a host array
        (returned as it is), a tensor, a queued pinned readback
        (``utils/host.Readback``), or a list of tensors or readbacks, one a
        lane shard, joined on lanes.  An asynchronous device failure
        surfacing here, on any shard, degrades the engine and substitutes
        the exact count of zero samples."""
        if isinstance(y, np.ndarray):
            return y
        try:
            if isinstance(y, list):
                return np.concatenate([_wait(p) for p in y], axis=1)
            return _wait(y)
        except Exception as exc:
            self._enter_degraded(exc)
            return self._zero_result()

    def _advance_degraded_hist(self, chunk: np.ndarray) -> np.ndarray:
        """History advance identical to the healthy step: last H rows of
        hist ++ chunk[:q] (resampler_basic_zero advances state while
        writing zeros)."""
        q = self.bspec.in_per_launch
        H = self._step.hist_rows
        return np.concatenate([self._hist, chunk[:q]], axis=0)[-H:]


def _wait(y) -> np.ndarray:
    """A tensor or a queued pinned readback, on the host."""
    return y.wait() if isinstance(y, Readback) else to_host(y)
