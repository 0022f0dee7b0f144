"""Sample-format conversion with exact reference rounding semantics.

The float build of the reference keeps internal samples as float32 **on the
±32768 int16 scale** (not normalized): s16 input is copied verbatim into the
float filter memory (resample.c:1000-1006) and converted back with WORD2INT
(arch.h:208-209) on output (resample.c:1018-1023).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["word2int", "word2int_np"]


def word2int(x: torch.Tensor) -> torch.Tensor:
    """WORD2INT (arch.h:208-209):
        x < -32767.5 → -32768 ; x > 32766.5 → 32767 ;
        else int16(floor(0.5 + x)).
    ``floor(0.5 + x)`` is round-half-up, NOT round-to-nearest-even; it must
    be spelled out (torch.round would tie-to-even).  Computed in x's dtype.
    """
    y = torch.floor(0.5 + x)
    y = torch.where(x < -32767.5, torch.full_like(x, -32768.0), y)
    y = torch.where(x > 32766.5, torch.full_like(x, 32767.0), y)
    return y.to(torch.int16)


def word2int_np(x: np.ndarray) -> np.ndarray:
    """NumPy twin of ``word2int`` for host code.  Semantics identical:
    floor(0.5+x) in x's dtype with the -32767.5/32766.5 clamp thresholds
    (arch.h:208-209)."""
    x = np.asarray(x)
    y = np.floor(x.dtype.type(0.5) + x)
    y = np.where(x < x.dtype.type(-32767.5), x.dtype.type(-32768.0), y)
    y = np.where(x > x.dtype.type(32766.5), x.dtype.type(32767.0), y)
    return y.astype(np.int16)
