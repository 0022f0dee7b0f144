"""Host transfer helper."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["to_host"]


def to_host(x: torch.Tensor) -> np.ndarray:
    """Copy ``x`` to host memory and return it as a NumPy array.  For a
    CUDA tensor this waits for the work queued on its stream, so a kernel
    fault surfaces here as an exception."""
    return x.detach().cpu().numpy()
