"""The reader of ``fixed.tiles_per_band``: the port's fixed output tiles
over its band loads, from the counters' totals, and None where there is
nothing to read."""

from __future__ import annotations

import pytest

from perfbench import manifest
from perfbench.tracing import TraceView

KERNEL = ("void (anonymous namespace)::streamed_fir_fixed_kernel<4, true>"
          "(fir::Launch, Origin, int, int, signed char const*, int const*, "
          "int const*)")


def _view(calls: int = 2) -> TraceView:
    dev = [(KERNEL, 1e-3 * c, 1e-3 * c + 4e-4) for c in range(calls)]
    return TraceView(calls=calls, device=dev, host=[], work=None,
                     peaks=None)


@pytest.fixture
def totals(monkeypatch):
    """The port's counter totals, as the reader sees them."""
    profiling = pytest.importorskip(
        "speex_resampler_tpu_torch.utils.profiling")
    table = {}
    monkeypatch.setattr(profiling, "counter_totals", lambda: dict(table))
    return table


def test_reads_tiles_over_band_loads(totals):
    read = manifest.reader("fixed.tiles_per_band")
    totals.update({"speex.kernel.fixed.tiles": 2 * 17920,
                   "speex.kernel.fixed.bands": 2 * 208})
    assert read(_view()) == pytest.approx(17920 / 208)
    totals.update({"speex.kernel.fixed.tiles": 18816,
                   "speex.kernel.fixed.bands": 708})
    assert read(_view()) == pytest.approx(18816 / 708)


@pytest.mark.parametrize("table", [
    {}, {"speex.kernel.fixed.tiles": 17920},
    {"speex.kernel.fixed.tiles": 17920, "speex.kernel.fixed.bands": 0}],
    ids=["no-counters", "no-band-counter", "streamed-walk"])
def test_none_where_no_band_was_loaded(totals, table):
    totals.update(table)
    assert manifest.reader("fixed.tiles_per_band")(_view()) is None


def test_none_without_device_operations(totals):
    totals.update({"speex.kernel.fixed.tiles": 17920,
                   "speex.kernel.fixed.bands": 208})
    read = manifest.reader("fixed.tiles_per_band")
    assert read(TraceView(0, [], [], None, None)) is None
