"""Host transfer helpers."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["to_host", "to_host_into", "Readback"]


def to_host(x: torch.Tensor) -> np.ndarray:
    """Copy ``x`` to host memory and return it as a NumPy array.  For a
    CUDA tensor this waits for the work queued on its stream, so a kernel
    fault surfaces here as an exception."""
    return x.detach().cpu().numpy()


def to_host_into(y: torch.Tensor, out_pinned: torch.Tensor,
                 stream: torch.cuda.Stream) -> torch.cuda.Event:
    """Queue the readback of the CUDA tensor ``y`` into the caller-owned
    pinned host tensor ``out_pinned`` (same shape and dtype) on ``stream``,
    after the work queued so far on ``y``'s current stream; returns the
    event recorded after the copy.

    ``out_pinned`` is not readable until ``event.synchronize()`` returns,
    and that call is where an asynchronous kernel fault surfaces.  ``y`` is
    marked as used by ``stream``, so its memory is not reused before the
    copy ends."""
    if out_pinned.shape != y.shape or out_pinned.dtype != y.dtype:
        raise ValueError(f"readback buffer {tuple(out_pinned.shape)} "
                         f"{out_pinned.dtype} for {tuple(y.shape)} {y.dtype}")
    y = y.contiguous()
    stream.wait_stream(torch.cuda.current_stream(y.device))
    with torch.cuda.stream(stream):
        out_pinned.copy_(y, non_blocking=True)
        event = torch.cuda.Event()
        event.record(stream)
    y.record_stream(stream)
    return event


class Readback:
    """A readback queued by :func:`to_host_into`: ``wait()`` synchronizes
    its event and returns the pinned buffer's NumPy view."""

    __slots__ = ("event", "host")

    def __init__(self, event: torch.cuda.Event, host: np.ndarray):
        self.event, self.host = event, host

    def wait(self) -> np.ndarray:
        self.event.synchronize()
        return self.host
