"""The benchmark's Q15 deployments: Speex's fixed-point build at 48 ->
44.1 kHz, quality 10, on the port's streamed fixed step
(``stage.q10.fixed``, K2d), and at 44.1 -> 48 kHz, quality 7, on its tiled
fixed step (``stage.q7.fixed``, K1e).

On the CPU: the cells' plain reference (``perfbench/reference/
speex_fixed.py``) equals the port's step bit for bit over calls with the
history carried, its int16 table equals the port's, and its outputs equal
the JAX package's fixed host route (a witness that is not the port's
code); in each cell a limit of 0 passes the port and fails the bfloat16
control, the float reference and each fault; the span ``speex.setup.q15``
opens in a fixed step's set-up alone and its reader reads it; each cell
resolves to its fixed kernel instance; the port's counters of the fixed
launches' CTAs and tiles reset, add up and count no other launch, and the
reader ``fixed.cta_tile_us`` reads them; the reference loads neither
package nor JAX.
"""

import dataclasses
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import manifest, signals
from perfbench.cell import run_cell
from perfbench.reference import speex_float
from perfbench.reference import speex_fixed as sx
from perfbench.tests.util import small_cell
from perfbench.tracing import TraceView
from speex_resampler_tpu_torch.functional import make_stream_fn
from speex_resampler_tpu_torch.ops import filter_design as fd
from speex_resampler_tpu_torch.parallel.batch import (_launch_geometry,
                                                      clear_step_cache,
                                                      make_batched_step)
from speex_resampler_tpu_torch.ops import streamed_fir as sf
from speex_resampler_tpu_torch.utils.launches import (fixed_counts,
                                                      fixed_instance,
                                                      reset_launches)
from speex_resampler_tpu_torch.utils.profiling import (counter_totals,
                                                       reset_counters,
                                                       reset_spans,
                                                       span_totals)

REPO = Path(__file__).resolve().parent.parent
CELL = "stage.q10.fixed"
#: each fixed cell's resolved step: geometry, call frames, the shapes of
#: its planes, bias and coefficients, (taps, table bytes) of its filter,
#: its kernel instance and its output tiles at the cell's 2048 lanes
CELLS = {
    "stage.q10.fixed": ("streamed", (20480, 18816), (
        (2, 147, 512, 512), (147, 512), (147, 4, 128)),
        (280, 2 * (32 * 280 + 8)), "streamed_fir_fixed_kernel<4, false>",
        18816),
    "stage.q7.fixed": ("tiled", (16464, 17920), (
        (2, 20, 512, 288), (20, 512), (20, 4, 128)),
        (128, 2 * (16 * 128 + 8)), "streamed_fir_fixed_kernel<4, true>",
        17920),
}
SEED = 2**31 + 4243
LANES = 8
STAGE = manifest.entry("stream_stage")
Q15 = "speex.setup.q15"


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _wrap_lane(ref, x: torch.Tensor, lane: int) -> int:
    """Writes 32767 * sign(taps) over the window of the first output whose
    window lies wholly in ``x`` (the call's input), for its accumulator
    with the largest sum |taps|, into ``x[:, lane]``; returns that exact
    accumulator, sum |taps| * 32767."""
    d = ref.d
    j = next(j for j in range(ref.n_out)
             if j * d.num // d.den >= d.filt_len - 1)
    taps, _ = sx.phase_rows(d, ref.table, [j * d.num % d.den])
    col = taps[0, np.abs(taps[0].astype(np.int64)).sum(axis=1).argmax()]
    row0 = j * d.num // d.den - (d.filt_len - 1)
    x[row0:row0 + d.filt_len, lane] = torch.from_numpy(
        (32767 * np.sign(col)).astype(np.int16))
    return int(np.abs(col.astype(np.int64)).sum()) * 32767


def _calls(rates, n_calls: int = 3):
    """(port step, reference, inputs int16 [n_in, LANES] of n_calls calls
    from the stage mix's signals, lane 1 of the second call driving an
    accumulator past 2^31)."""
    rs = make_stream_fn(*rates, target_in_frames=1, fixed_point=True,
                        device="cpu")
    ref = sx.CallReference(*rates, rs.in_frames, rs.out_frames, "cpu")
    pool, walk = signals.make_pool(small_cell(CELL).traffic, rs.in_frames,
                                   LANES, rates[0], SEED, "cpu")
    xs = [pool[walk[k % len(walk)]].clone() for k in range(n_calls)]
    assert _wrap_lane(ref, xs[1], 1) > 2**31
    return rs, ref, xs


@pytest.mark.parametrize("rates", [(48000, 44100, 10), (44100, 48000, 7)],
                         ids=["48k-44k1-q10", "44k1-48k-q7"])
def test_reference_equals_the_port_step_bit_for_bit(rates):
    """Three calls with the history carried, one lane wrapping its int32
    accumulator: the port's CPU step (its kernels' plain versions) and
    the reference agree on every output."""
    rs, ref, xs = _calls(rates)
    assert rs.scheme == "fixed"
    hist, prev = rs.init(LANES), None
    for x in xs:
        hist, y = rs.step(hist, x)
        want = ref(prev, x)
        assert y.dtype == want.dtype == torch.int16
        assert torch.equal(y, want)
        prev = x


@pytest.mark.parametrize("rates", [(48000, 44100, 10), (44100, 48000, 7),
                                   (16000, 44100, 6), (22050, 48000, 9)])
def test_reference_table_equals_the_ports(rates):
    """The fixed sinc table, built by the reference alone, equals the
    port's ``design_filter(..., fixed_point=True)`` table bit for bit."""
    d, table = sx.fixed_table(*rates)
    g = math.gcd(rates[0], rates[1])
    spec = fd.design_filter(rates[0] // g, rates[1] // g, rates[2],
                            fixed_point=True)
    assert table.dtype == spec.sinc_table.dtype == np.int16
    assert np.array_equal(table, spec.sinc_table)
    assert (d.filt_len, d.oversample) == (spec.filt_len, spec.oversample)


def test_reference_equals_the_jax_packages_fixed_route():
    """The JAX package's fixed host route (``ops.fir_fixed``, its NumPy
    semantics of resample.c's Q15 loop) on the same input, the second
    call with its wrapping lane, gives the reference's outputs."""
    from speex_resampler_tpu.ops import filter_design as jfd
    from speex_resampler_tpu.ops.fir_fixed import fixed_output_slice
    rates = (48000, 44100, 10)
    _, ref, xs = _calls(rates, n_calls=2)
    d = ref.d
    spec = jfd.design_filter(d.num, d.den, rates[2], fixed_point=True)
    X = torch.cat([xs[0][-(d.filt_len - 1):], xs[1]]).t().numpy()
    j = np.arange(ref.n_out, dtype=np.int64)
    got = np.concatenate([
        fixed_output_slice(X, j[s] * d.num // d.den, j[s] * d.num % d.den,
                           spec)
        for s in np.array_split(np.arange(ref.n_out), 16)], axis=1)
    assert np.array_equal(got.T, ref(xs[0], xs[1]).numpy())


def test_reference_refuses_the_direct_path_and_off_phase_calls():
    with pytest.raises(ValueError, match="direct"):
        sx.fixed_table(48000, 16000, 5)
    with pytest.raises(ValueError, match="phase 0"):
        sx.CallReference(48000, 44100, 10, 20480, 18815, "cpu")


def _control(config, device):
    return STAGE.control(config, manifest.reference(config), device)


def _float_reference(config, device):
    return STAGE.ReferenceStep(config, speex_float, device, torch.float64)


PROGRAMS = {"port": None, "control_bfloat16": _control,
            "float_reference": _float_reference, **STAGE.FAULTS}


#: programs whose fault shows only from a stream's second call on
#: (their windows run long enough for several calls)
CARRIED = ("port", "state_unchanged")


@pytest.mark.parametrize("name", sorted(PROGRAMS))
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_limit_of_zero_passes_the_port_alone(cell, name):
    """On the cell narrowed to 8 lanes, two quanta and one warm-up call:
    the port is correct with 0 / 0; the reference in bfloat16, the float
    build's reference and each fault in the program's place are not."""
    c = small_cell(cell)
    c = dataclasses.replace(c, traffic={**c.traffic, "pool_min_bytes": 0,
                                        "warmup_calls": 1})
    r = run_cell(c, SEED, 2.5 if name in CARRIED else 0.1, False,
                 device="cpu", program=PROGRAMS[name])
    assert r["attempted"] >= (2 if name in CARRIED else 1)
    checks = {k: c["value"] for k, c in r["checks"].items()}
    assert {c["limit"] for c in r["checks"].values()} == {0}
    if name == "port":
        assert r["correct"] is True and r["failed"] == 0
        assert checks == {"max_err_lsb": 0, "off_share": 0.0}
    else:
        assert r["correct"] is False and r["failed"] >= 1
        assert checks["max_err_lsb"] > 0 and checks["off_share"] > 0


def _fixed_step(geometry: str):
    """(spec, bspec) of a fixed step of the geometry."""
    if geometry == "tiled":
        spec = fd.design_filter(147, 160, 7, fixed_point=True)
        return spec, _launch_geometry(spec, 600)
    if geometry == "streamed":
        spec = fd.design_filter(160, 147, 10, fixed_point=True)
        return spec, _launch_geometry(spec, 20480)
    spec = fd.design_filter(147, 160, 3, fixed_point=True)   # voip, 20 ms
    return spec, _launch_geometry(spec, 882, max_in_frames=882)


def _spans(prof, name: str) -> list:
    return [(e.time_range.start, e.time_range.end) for e in prof.events()
            if e.name == name]


@pytest.mark.parametrize("geometry", ["tiled", "streamed", "dense"])
def test_q15_span_opens_in_a_fixed_steps_set_up_alone(geometry):
    """Building a fixed step opens ``speex.setup.q15`` twice, once inside
    ``speex.setup.planes`` (its Q15 host weights) and once inside
    ``speex.setup.upload`` (the int8 split); a step-cache hit opens it
    never, nor does a float step of the same geometry."""
    spec, bspec = _fixed_step(geometry)
    assert bspec.kernel == geometry
    clear_step_cache()
    reset_spans()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step = make_batched_step(spec, bspec, device="cpu")
    assert step.scheme == "fixed"
    totals = span_totals()
    assert totals[Q15][0] == 2 and totals[Q15][1] > 0.0
    q15 = _spans(prof, Q15)
    assert len(q15) == 2
    for parent, inner in zip(("speex.setup.planes", "speex.setup.upload"),
                             sorted(q15)):
        (s0, e0), = _spans(prof, parent)
        assert s0 <= inner[0] and inner[1] <= e0, parent
    reset_spans()
    assert make_batched_step(spec, bspec, device="cpu") is step
    assert Q15 not in span_totals()
    fspec = fd.design_filter(spec.num, spec.den, spec.quality)
    fbspec = (_launch_geometry(fspec, 882, max_in_frames=882)
              if geometry == "dense"
              else _launch_geometry(fspec, bspec.in_per_launch))
    assert fbspec.kernel == geometry
    clear_step_cache()
    reset_spans()
    make_batched_step(fspec, fbspec, device="cpu", scheme="highest")
    totals = span_totals()
    assert "speex.setup.planes" in totals and Q15 not in totals


def test_q15_reader_reads_the_span_and_none_without_it(monkeypatch):
    from speex_resampler_tpu_torch.utils import profiling
    read = manifest.reader("setup.q15_s")
    view = TraceView(calls=1, device=[("k", 0.0, 1e-4)], host=[], work=None,
                     peaks=None)
    monkeypatch.setattr(profiling, "span_totals", lambda: {
        "speex.setup.planes": (1, 0.75), Q15: (2, 0.5)})
    assert read(view) == pytest.approx(0.5)
    assert read(TraceView(1, [], [], None, None)) is None
    monkeypatch.setattr(profiling, "span_totals", lambda: {
        "speex.setup.planes": (1, 0.75)})
    assert read(view) is None


def _cell_step(cell: str):
    """(configuration, bspec, CPU step) of a cell's program."""
    cfg = manifest.cell(cell).config
    g = math.gcd(cfg["in_rate"], cfg["out_rate"])
    spec = fd.design_filter(cfg["in_rate"] // g, cfg["out_rate"] // g,
                            cfg["quality"], fixed_point=True)
    bspec = _launch_geometry(spec, cfg["target_in_frames"])
    return cfg, bspec, make_batched_step(spec, bspec, device="cpu",
                                         scheme=cfg["scheme"])


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_cell_resolves_to_the_streamed_fixed_kernel(cell):
    """Each fixed cell's step: its geometry at n_accum 4, its call, its
    weights' shapes and the instance of ``streamed_fir_fixed_kernel``
    it launches (both geometries run it; the CTA order by the planes'
    bytes), and its per-layer metrics, the fixed ones last."""
    kernel, frames, shapes, size, instance, _ = CELLS[cell]
    c = manifest.cell(cell)
    cfg, bspec, step = _cell_step(cell)
    assert (cfg["numeric"], cfg["limits"]) == (
        "fixed", {"max_err_lsb": 0, "off_share": 0})
    assert manifest.reference(cfg).NUMERICS == ("fixed",)
    assert [m["name"] for m in c.per_layer][-3:] == [
        "setup.q15_s", "fixed.cta_tile_us", "fixed.tiles_per_band"]
    assert (step.kernel, step.scheme, step.kernel_kw["n_accum"]) == (
        kernel, "fixed", 4)
    assert (bspec.in_per_launch, bspec.out_per_launch) == frames
    assert tuple(tuple(t.shape) for t in step.w[:3]) == shapes
    assert fixed_instance(step) == instance
    assert sx.filter_size(cfg) == size


def test_fixed_counters_reset_and_add_up():
    """The port's counters of the fixed launches add each launch's CTAs,
    tiles and band loads; ``reset_counters`` and ``utils/launches.
    reset_launches`` set them to 0, ``reset_spans`` (the span table's)
    leaves them."""
    reset_counters()
    assert fixed_counts() == (0, 0, 0, 0) and counter_totals() == {}
    sf.count_fixed(132, 18816, 708)
    sf.count_fixed(4, 4)
    assert fixed_counts() == (2, 136, 18820, 708)
    assert counter_totals() == {sf.FIXED_LAUNCHES: 2, sf.FIXED_CTAS: 136,
                                sf.FIXED_TILES: 18820, sf.FIXED_BANDS: 708}
    reset_spans()
    assert fixed_counts() == (2, 136, 18820, 708)
    reset_counters()
    assert fixed_counts() == (0, 0, 0, 0)
    sf.count_fixed(1, 1, 1)
    reset_launches()
    assert fixed_counts() == (0, 0, 0, 0)


def test_fixed_counts_of_a_tiled_and_a_streamed_launch():
    """The launch of each fixed cell's step at its 2048 lanes as the
    wrapper counts it: n_blocks x row tiles of 32 x lane tiles of 64
    output tiles (17,920 at q7, 18,816 at q10), on the CTAs the library
    reports (an H100's 132 SMs: ~135.8 and ~142.5 tiles a CTA), each
    (phase, row tile) band shared by n_blocks / P x 32 tiles (224 at q7,
    32 at q10) and loaded 210 and 716 times on the CTAs' balanced runs
    (~85.3 and ~26.3 tiles a load); the widest band of 6 and 9 K-slices,
    the mean 5.125 and 8.91."""
    reset_launches()
    want = []
    for cell, per_band, widest, mean, bands in (
            ("stage.q7.fixed", 224, 6, 5.125, 210),
            ("stage.q10.fixed", 32, 9, 8.913, 716)):
        _, bspec, step = _cell_step(cell)
        kw = step.kernel_kw
        tiles = sf.fixed_tiles(kw["n_blocks"], bspec.R, 2048, kw["n_accum"])
        assert tiles == CELLS[cell][5]
        assert kw["n_blocks"] // bspec.P * 32 == per_band
        widths = step.w[-2]
        assert len(widths.slices) * per_band == tiles
        assert widths.widest == max(widths.slices) == widest
        assert np.mean(widths.slices) == pytest.approx(mean, abs=5e-4)
        assert sf.resident_bands(widths, per_band, 132) == bands
        sf.count_fixed(min(tiles, 132), tiles, bands)
        want.append(tiles)
    assert fixed_counts() == (2, 264, sum(want), 210 + 716)
    assert want[0] / 132 == pytest.approx(135.76, abs=0.01)
    assert want[1] / 132 == pytest.approx(142.55, abs=0.01)
    reset_launches()


@pytest.mark.parametrize("geometry", ["tiled", "streamed", "dense"])
def test_no_fixed_count_without_a_fixed_launch(geometry):
    """Counted at a launch of the phase-tiled fixed kernel alone: a call
    of a fixed step on the CPU (its plain version, no launch), of a float
    step of the same geometry, and of a fixed dense step add nothing."""
    spec, bspec = _fixed_step(geometry)
    fspec = fd.design_filter(spec.num, spec.den, spec.quality)
    fbspec = (_launch_geometry(fspec, 882, max_in_frames=882)
              if geometry == "dense"
              else _launch_geometry(fspec, bspec.in_per_launch))
    reset_launches()
    for s, b, scheme in ((spec, bspec, "auto"), (fspec, fbspec, "highest")):
        step = make_batched_step(s, b, device="cpu", scheme=scheme)
        B = 4
        hist = torch.zeros((step.hist_rows, B), dtype=torch.int16)
        x = torch.randint(-3000, 3000, (b.in_per_launch, B),
                          dtype=torch.int16,
                          generator=torch.Generator().manual_seed(7))
        _, y = step.fn(hist, x, step.w)
        assert y.shape == (b.out_per_launch, B)
    assert fixed_counts() == (0, 0, 0, 0)
    assert counter_totals() == {}


def _fixed_view(calls: int, kernel_s: float):
    """A traced view of ``calls`` calls, each one launch of K1e of
    ``kernel_s`` seconds and the next history's copy."""
    dev, t = [], 0.0
    for _ in range(calls):
        dev.append(("void (anonymous namespace)::streamed_fir_fixed_kernel"
                    "<4, true>(fir::Launch, Origin, signed char const*, "
                    "int const*, int const*)", t, t + kernel_s))
        dev.append(("Memcpy DtoD (Device -> Device)", t + kernel_s,
                    t + kernel_s + 1.4e-6))
        t += kernel_s + 5e-6
    return TraceView(calls=calls, device=dev, host=[], work=None,
                     peaks=None)


def test_cta_tile_reader_reads_the_counters_and_none_without(monkeypatch):
    """``fixed.cta_tile_us``: the port kernels' device time a call times
    CTAs over tiles, from the counters' totals; None with no device
    operation, with no fixed launch counted, and where the program keeps
    no such counters (an earlier port's ``utils/profiling``)."""
    from speex_resampler_tpu_torch.utils import profiling
    read = manifest.reader("fixed.cta_tile_us")
    view = _fixed_view(3, 0.58e-3)
    reset_launches()
    assert read(view) is None
    for _ in range(5):
        sf.count_fixed(132, 17920)
    assert read(view) == pytest.approx(580.0 * 132 / 17920)
    assert read(TraceView(0, [], [], None, None)) is None
    monkeypatch.delattr(profiling, "counter_totals")
    assert read(view) is None
    reset_launches()


def test_tiles_per_band_reader_reads_the_counters_and_none_without(
        monkeypatch):
    """``fixed.tiles_per_band``: the output tiles over the band loads of
    the fixed launches, from the counters' totals (~86 at the q7 cell's
    launch, 17,920 tiles over 210 loads); None with no device operation,
    where no band was loaded (the streamed walk, or a port that keeps no
    band counter) and where the program keeps no counters."""
    from speex_resampler_tpu_torch.utils import profiling
    read = manifest.reader("fixed.tiles_per_band")
    view = _fixed_view(3, 0.4e-3)
    reset_launches()
    assert read(view) is None
    sf.count_fixed(132, 18816)
    assert read(view) is None
    for _ in range(5):
        sf.count_fixed(132, 17920, 210)
    assert read(view) == pytest.approx((18816 + 5 * 17920) / (5 * 210))
    reset_launches()
    sf.count_fixed(132, 17920, 210)
    assert read(view) == pytest.approx(17920 / 210)
    assert read(TraceView(0, [], [], None, None)) is None
    monkeypatch.delattr(profiling, "counter_totals")
    assert read(view) is None
    reset_launches()


def test_the_reference_loads_no_jax_and_neither_package():
    code = ("import sys; import perfbench.reference.speex_fixed as r; "
            "assert r.NUMERICS == ('fixed',); "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'speex_resampler_tpu', "
            "'speex_resampler_tpu_torch')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
