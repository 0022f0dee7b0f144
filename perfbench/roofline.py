"""The yardstick of the kernels: the chip's published peaks and the work
one call of a stream stage needs, counted the same whatever scheme or
kernel implements it.

Bytes: the call's input, the filter history it reads, the filter table
of the Speex design and its output, each counted once.  Operations: two
(a multiply and an add) for each tap of each output sample.  The least
time is the larger of bytes over the memory bandwidth and operations
over the highest dense rate of the chip.
"""

from __future__ import annotations

import dataclasses

#: published peaks, by a substring of ``torch.cuda.get_device_name()``:
#: NVIDIA's data sheet for the H100 SXM, dense rates, at its 700 W limit
PEAKS = {
    "H100": {"hbm_bytes_s": 3.35e12, "dense_ops_s": 1979e12},
}

SAMPLE_BYTES = 2    # int16 samples in and out


def peaks_of(device_name: str) -> dict | None:
    """The peaks of a card, or None for a card the table lacks."""
    for key, peaks in PEAKS.items():
        if key in device_name:
            return peaks
    return None


@dataclasses.dataclass(frozen=True)
class CallWork:
    """What one call of the stage needs."""
    ops: float          # 2 x taps x output samples
    bytes: float        # input + history + table + output
    out_samples: int    # output frames x lanes

    def least_s(self, peaks: dict) -> float:
        """The least time of the call on a chip with ``peaks``."""
        return max(self.bytes / peaks["hbm_bytes_s"],
                   self.ops / peaks["dense_ops_s"])


def stage_call_work(filt_len: int, table_bytes: int, n_in: int, n_out: int,
                    lanes: int) -> CallWork:
    """The work of one call of ``n_in`` -> ``n_out`` frames on ``lanes``
    lanes, a filter of ``filt_len`` taps whose table takes
    ``table_bytes``."""
    out_samples = n_out * lanes
    moved = (n_in + (filt_len - 1) + n_out) * lanes * SAMPLE_BYTES
    return CallWork(ops=2.0 * filt_len * out_samples,
                    bytes=float(moved + table_bytes),
                    out_samples=out_samples)
