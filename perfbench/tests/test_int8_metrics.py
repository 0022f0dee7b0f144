"""The readers of ``int8.tiles_per_band`` and ``int8.cta_tile_us``: the
port's streamed int8 output tiles over its band loads, and a CTA's device
time a tile, from the counters' totals and the trace, and None where there
is nothing to read."""

from __future__ import annotations

import pytest

from perfbench import manifest
from perfbench.tracing import TraceView

KERNEL = ("void (anonymous namespace)::streamed_fir_int8_kernel<4, true, "
          "false>(fir::Launch, Origin, int, int, signed char const*, float "
          "const*, float4)")
TILES, CTAS, BANDS = ("speex.kernel.int8.tiles", "speex.kernel.int8.ctas",
                      "speex.kernel.int8.bands")


def _view(calls: int = 2, seconds: float = 4e-4) -> TraceView:
    dev = [(KERNEL, 1e-3 * c, 1e-3 * c + seconds) for c in range(calls)]
    return TraceView(calls=calls, device=dev, host=[], work=None,
                     peaks=None)


@pytest.fixture
def totals(monkeypatch):
    """The port's counter totals, as the readers see them."""
    profiling = pytest.importorskip(
        "speex_resampler_tpu_torch.utils.profiling")
    table = {}
    monkeypatch.setattr(profiling, "counter_totals", lambda: dict(table))
    return table


def test_tiles_per_band_reads_tiles_over_band_loads(totals):
    read = manifest.reader("int8.tiles_per_band")
    totals.update({TILES: 2 * 9408, BANDS: 2 * 426})
    assert read(_view()) == pytest.approx(9408 / 426)
    totals.update({TILES: 9408, BANDS: 294})
    assert read(_view()) == pytest.approx(32.0)


def test_cta_tile_us_reads_a_ctas_time_a_tile(totals):
    read = manifest.reader("int8.cta_tile_us")
    totals.update({CTAS: 2 * 132, TILES: 2 * 9408})
    assert read(_view(seconds=4.5e-4)) == pytest.approx(
        1e6 * 4.5e-4 * 132 / 9408)
    # a CTA a tile (the streamed walk): the call's device time
    totals.update({CTAS: 2 * 9408, TILES: 2 * 9408})
    assert read(_view(seconds=6.45e-4)) == pytest.approx(645.0)


@pytest.mark.parametrize("metric,table", [
    ("int8.tiles_per_band", {}),
    ("int8.tiles_per_band", {TILES: 9408}),
    ("int8.tiles_per_band", {TILES: 9408, BANDS: 0}),
    ("int8.cta_tile_us", {}),
    ("int8.cta_tile_us", {TILES: 9408}),
    ("int8.cta_tile_us", {CTAS: 0, TILES: 9408})],
    ids=["bands-no-counters", "bands-no-band-counter", "bands-streamed-walk",
         "cta-no-counters", "cta-no-cta-counter", "cta-zero-ctas"])
def test_none_where_a_counter_is_missing_or_zero(totals, metric, table):
    totals.update(table)
    assert manifest.reader(metric)(_view()) is None


@pytest.mark.parametrize("metric", ["int8.tiles_per_band",
                                    "int8.cta_tile_us"])
def test_none_without_device_operations(totals, metric):
    totals.update({TILES: 9408, BANDS: 294, CTAS: 132})
    assert manifest.reader(metric)(TraceView(0, [], [], None, None)) is None
