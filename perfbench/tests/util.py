"""Cells narrowed so that a run fits a test on the CPU."""

from __future__ import annotations

import dataclasses

from perfbench import manifest

#: lanes of a test run (the traffic's are 2048)
LANES = 8


def small_cell(name: str, root=manifest.ROOT) -> manifest.Cell:
    """The cell ``name`` with LANES lanes and an input pool of 1 MiB."""
    c = manifest.cell(name, root)
    streams = LANES // c.config["channels"]
    return dataclasses.replace(c, traffic={
        **c.traffic, "streams": streams, "pool_min_bytes": 1 << 20})
