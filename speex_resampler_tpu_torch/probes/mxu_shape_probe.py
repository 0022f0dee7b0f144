"""The tensor-core rate over block height, depth and lane width (P4).

Counterpart of ``experiments/mxu_shape_probe.py``: its ``CASES`` (dtype, C,
K, LB) through the resident-operand kernel (:mod:`.tc_rate`), which on the
TPU asked which axis buys the int8 rate back at C = 128 blocks.  The same
kernel as :mod:`.mxu_peak`, with the lane width a parameter;
``tools/tc_probes.py`` writes the results to
``build/torch_probes/mxu_shape_probe.json``.
"""

from __future__ import annotations

from . import tc_rate as tr
from .mxu_peak import _line

__all__ = ["CASES", "measure", "run"]

#: experiments/mxu_shape_probe.py:87
CASES = [
    # flagship block, lane-width sweep
    ("int8", 128, 264, 128), ("int8", 128, 264, 256),
    ("int8", 128, 264, 512), ("int8", 128, 264, 1024),
    # height sweep at flagship depth
    ("int8", 256, 264, 128), ("int8", 256, 264, 256),
    ("int8", 512, 264, 256),
    # widened-R flagship geometry (R=256 -> K ~ 380)
    ("int8", 256, 384, 128), ("int8", 256, 384, 256),
    # bf16 ratio references
    ("bf16", 128, 264, 128), ("bf16", 128, 264, 256),
    ("bf16", 256, 264, 256),
]


def measure(dtype: str, C: int, K: int, LB: int, seed: int = 0) -> dict:
    return tr.measure(dtype, C, K, LB, seed=seed)


def run(log=print) -> dict:
    out = {}
    for dtype, C, K, LB in CASES:
        r = measure(dtype, C, K, LB)
        out[f"{dtype}_{C}x{K}_lb{LB}"] = r
        log(_line(r))
    return out
