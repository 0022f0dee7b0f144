"""The benchmark's clock-drift deployment: Speex's float build at 44.1 ->
44.101 kHz, quality 7 (``stage.drift``), on the port's gather step and its
float band kernel.

On the CPU: the cell resolves to the gather geometry, the band plan and
``gather_fir_f64mma_kernel<short>``; the cell's plain reference
(``perfbench/reference/speex_float.py``) is within 1 LSB of the port's
step over calls with the history carried, and of the JAX package's gather
route (a witness that is not the port's code); the cell's limits pass the
port and fail the bfloat16 control and each fault; the port's counters of
the band and stream gather launches' CTAs, resident CTAs and tiles reset,
add up and count no other launch, and the reader ``gather.cta_tile_us``
reads them.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from perfbench import manifest, signals
from perfbench.cell import run_cell
from perfbench.reference import speex_float as sf_ref
from perfbench.tests.util import small_cell
from perfbench.tracing import TraceView
from speex_resampler_tpu_torch.functional import make_stream_fn
from speex_resampler_tpu_torch.ops import filter_design as fd
from speex_resampler_tpu_torch.ops import fir_matmul as fm
from speex_resampler_tpu_torch.ops import streamed_fir as sf
from speex_resampler_tpu_torch.parallel.batch import (_gather_starts,
                                                      _launch_geometry,
                                                      make_batched_step)
from speex_resampler_tpu_torch.utils.launches import (fixed_counts,
                                                      gather_counts,
                                                      reset_launches,
                                                      step_kernel)
from speex_resampler_tpu_torch.utils.profiling import (counter_totals,
                                                       reset_counters,
                                                       reset_spans)

CELL = "stage.drift"
SEED = 2**31 + 6151
STAGE = manifest.entry("stream_stage")
#: the drift band launch at the cell's 2048 lanes: its plan, its band's
#: shape, its (64-output, 64-lane) tiles and, on an H100 (132 SMs, one
#: 128 KB CTA an SM), its CTAs and resident CTAs
PLAN = fm.GatherPlan(outputs=64, taps=144, rows=192, form="band")
BAND = (44112, 144)
TILES, CTAS, RESIDENT = 22080, 2760, 132


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cell_step(device="cpu"):
    """(configuration, spec, bspec, step) of the cell's program."""
    cfg = manifest.cell(CELL).config
    g = math.gcd(cfg["in_rate"], cfg["out_rate"])
    spec = fd.design_filter(cfg["in_rate"] // g, cfg["out_rate"] // g,
                            cfg["quality"])
    bspec = _launch_geometry(spec, cfg["target_in_frames"])
    return cfg, spec, bspec, make_batched_step(spec, bspec, device=device,
                                               scheme=cfg["scheme"])


def test_the_cell_resolves_to_the_float_band_gather():
    """The cell's step: one 44100 -> 44101 block on the gather geometry,
    scheme highest, 127 history rows, the band plan (64 outputs a CTA,
    144 taps, 192 staged rows) and its f64 band, the kernel
    ``gather_fir_f64mma_kernel<short>``, 22,080 tiles at 2048 lanes; the
    configuration's float reference, limits and per-layer metrics (the
    gather one last, no fixed one)."""
    c = manifest.cell(CELL)
    cfg, spec, bspec, step = _cell_step()
    assert (cfg["numeric"], cfg["limits"]["max_err_lsb"]) == ("float", 1)
    assert 0 < cfg["limits"]["off_share"] < 0.05
    assert manifest.reference(cfg).NUMERICS == ("float",)
    assert sf_ref.filter_size(cfg) == (128, 4 * (16 * 128 + 8))
    assert (spec.num, spec.den, spec.use_direct) == (44100, 44101, False)
    assert (bspec.kernel, bspec.n_blocks) == ("gather", 1)
    assert (bspec.in_per_launch, bspec.out_per_launch) == (44100, 44101)
    assert (step.kernel, step.scheme, step.hist_rows) == (
        "gather", "highest", 127)
    assert step.kernel_kw["plan"] is None          # a CPU step: plain
    assert step_kernel(step) == (("gather", "highest_band"),
                                 "gather_fir_f64mma_kernel<short>")
    starts, _ = _gather_starts(spec, bspec)
    plan = fm.gather_plan(starts, spec.filt_len)
    assert plan == PLAN
    band = fm.gather_band(step.w[0], starts, plan)
    assert band.w.dtype == torch.float64 and tuple(band.w.shape) == BAND
    assert fm.gather_tiles(plan, bspec.out_per_launch, 2048) == TILES
    names = [m["name"] for m in c.per_layer]
    assert names[-1] == "gather.cta_tile_us"
    assert not any(n.startswith("fixed.") or n == "setup.q15_s"
                   for n in names)
    rs = make_stream_fn(cfg["in_rate"], cfg["out_rate"], cfg["quality"],
                        target_in_frames=cfg["target_in_frames"],
                        device="cpu")
    assert (rs.in_frames, rs.out_frames, rs.scheme) == (
        44100, 44101, "highest")


def test_reference_meets_the_port_step_within_one_lsb():
    """Three calls of the cell's stream, history carried, on the mix's
    signals plus a lane of full-scale square waves: the port's CPU step
    (the gather's plain version) within 1 LSB of the reference, on a
    share of the outputs under the cell's limit."""
    cfg = small_cell(CELL).config
    rs = make_stream_fn(cfg["in_rate"], cfg["out_rate"], cfg["quality"],
                        target_in_frames=cfg["target_in_frames"],
                        device="cpu")
    ref = sf_ref.CallReference(cfg["in_rate"], cfg["out_rate"],
                               cfg["quality"], rs.in_frames, rs.out_frames,
                               "cpu")
    pool, walk = signals.make_pool(small_cell(CELL).traffic, rs.in_frames,
                                   4, cfg["in_rate"], SEED, "cpu")
    pool[:, ::64, 0] = 32767
    pool[:, 32::64, 0] = -32768
    hist, prev = rs.init(4), None
    for k in range(3):
        x = pool[walk[k % len(walk)]]
        hist, y = rs.step(hist, x)
        err = (y.int() - ref(prev, x).int()).abs()
        assert int(err.max()) <= 1
        assert float((err != 0).float().mean()) <= cfg["limits"]["off_share"]
        prev = x


def test_reference_meets_the_jax_packages_gather_route():
    """The JAX package's gather route (``ops.fir_matmul.resample_gather``,
    an f32 HIGHEST einsum over its own design's phase rows) on the same
    two calls, the second after the first's input: within 1 LSB of the
    reference on every output, on few of them off."""
    import jax.numpy as jnp
    from speex_resampler_tpu.ops import filter_design as jfd
    from speex_resampler_tpu.ops.fir_matmul import resample_gather
    cfg = manifest.cell(CELL).config
    ref = sf_ref.CallReference(cfg["in_rate"], cfg["out_rate"],
                               cfg["quality"], 44100, 44101, "cpu")
    d = ref.d
    spec = jfd.design_filter(d.num, d.den, cfg["quality"])
    pool, walk = signals.make_pool(small_cell(CELL).traffic, ref.n_in, 3,
                                   cfg["in_rate"], SEED + 1, "cpu")
    xs = [pool[walk[k % len(walk)]] for k in range(2)]
    j = np.arange(ref.n_out, dtype=np.int64)
    taps = jnp.asarray(spec.phase_rows(j * d.num % d.den))
    starts = jnp.asarray((j * d.num // d.den).astype(np.int32))
    for prev, x in ((None, xs[0]), (xs[0], xs[1])):
        head = (torch.zeros((d.filt_len - 1, 3), dtype=torch.int16)
                if prev is None else prev[-(d.filt_len - 1):])
        X = jnp.asarray(torch.cat([head, x]).t().numpy())
        got = np.asarray(resample_gather(X, taps, starts,
                                         tile=ref.n_out)).T
        err = np.abs(got.astype(np.int32)
                     - ref(prev, x).numpy().astype(np.int32))
        assert err.max() <= 1
        assert (err != 0).mean() < 1e-3


def _control(config, device):
    return STAGE.control(config, manifest.reference(config), device)


PROGRAMS = {"port": None, "control_bfloat16": _control, **STAGE.FAULTS}
#: programs whose fault shows only from a stream's second call on
CARRIED = ("port", "state_unchanged")


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_the_limits_pass_the_port_alone(name):
    """On the cell narrowed to 8 lanes, two quanta and one warm-up call:
    the port is correct under the cell's limits; the reference in
    bfloat16 and each fault in the program's place are not."""
    c = small_cell(CELL)
    c = dataclasses.replace(c, traffic={**c.traffic, "pool_min_bytes": 0,
                                        "warmup_calls": 1})
    r = run_cell(c, SEED, 2.0 if name in CARRIED else 0.1, False,
                 device="cpu", program=PROGRAMS[name])
    assert r["attempted"] >= (2 if name in CARRIED else 1)
    checks = {k: c["value"] for k, c in r["checks"].items()}
    if name == "port":
        assert r["correct"] is True and r["failed"] == 0
        assert checks["max_err_lsb"] <= 1
    else:
        assert r["correct"] is False and r["failed"] >= 1
        assert checks["max_err_lsb"] > 1


class _Library:
    """The library's CTA query as a launch of each form would answer it
    on an H100: the band CTA one an SM, the stream CTAs (256 threads, 75
    KB) three; every query recorded."""

    def __init__(self):
        self.asked = []

    def gather_fir_launch_ctas(self, form, n_accum, x_bytes, n_out, B, K,
                               rows, ctas, resident):
        self.asked.append((form, n_accum, x_bytes, n_out, B, K, rows))
        lanes = -(-B // 64)
        if form == 0:
            G = 64 if n_accum in (0, 1) else 32
            grid = -(-n_out // G) * -(-lanes // (8 if n_accum == 0 else 16))
            slots = 132
        else:
            grid = -(-n_out // 16) * -(-B // 256) * 5
            slots = 3 * 132
        ctas._obj.value, resident._obj.value = grid, min(grid, slots)
        return 0


def test_gather_counters_reset_and_add_up():
    """The port's counters of the band and stream launches add each
    launch's CTAs, resident CTAs and tiles; the library is asked once a
    launch shape; ``reset_counters`` and ``utils/launches.reset_launches``
    set them to 0, ``reset_spans`` leaves them; the fixed launches' own
    counters are apart."""
    lib = _Library()
    fm.launch_ctas.cache_clear()
    reset_counters()
    assert gather_counts() == (0, 0, 0, 0) and counter_totals() == {}
    for _ in range(3):
        fm.count_gather(lib, 0, PLAN, None, 2, 44101, 2048)
    assert gather_counts() == (3, 3 * CTAS, 3 * RESIDENT, 3 * TILES)
    assert lib.asked == [(0, 0, 2, 44101, 2048, 144, 192)]
    fixed_band = fm.GatherPlan(32, 160, 0, "band")
    steep = fm.GatherPlan(16, 15104, 0, "stream")
    fm.count_gather(lib, 0, fixed_band, 4, 2, 44101, 2048)
    fm.count_gather(lib, 0, steep, None, 2, 401, 2048)
    fm.count_gather(lib, 1, PLAN, None, 2, 44101, 2048)
    assert len(lib.asked) == 4           # another device asks anew
    assert gather_counts() == (
        6, 4 * CTAS + 1379 * 2 + 26 * 8 * 5, 4 * RESIDENT + 132 + 396,
        4 * TILES + 1379 * 32 + 26 * 32)
    assert fixed_counts() == (0, 0, 0, 0)
    sf.count_fixed(132, 17920, 210)
    assert gather_counts()[0] == 6
    reset_spans()
    assert gather_counts()[0] == 6
    reset_counters()
    assert gather_counts() == (0, 0, 0, 0)
    fm.count_gather(lib, 0, PLAN, None, 2, 44101, 2048)
    reset_launches()
    assert gather_counts() == (0, 0, 0, 0)
    fm.launch_ctas.cache_clear()


def test_gather_tiles_are_each_forms_own():
    """A launch's (output tile, 64-lane tile) units: the float band's
    64-output CTA tile, a fixed band group (32 outputs interpolated, 64
    direct), a stream form's band tile (16 float and fixed interpolated,
    32 fixed direct), each over ceil(B / 64) lane tiles."""
    assert fm.gather_tiles(PLAN, 44101, 2048) == 690 * 32
    assert fm.gather_tiles(fm.GatherPlan(32, 160, 0, "band"), 44101,
                           130) == 1379 * 3
    assert fm.gather_tiles(fm.GatherPlan(64, 96, 0, "band"), 44101,
                           64) == 690
    assert fm.gather_tiles(fm.GatherPlan(16, 15104, 0, "stream"), 401,
                           2048) == 26 * 32
    assert fm.gather_tiles(fm.GatherPlan(32, 15104, 0, "stream"), 401,
                           2) == 13


@pytest.mark.parametrize("fixed", [False, True], ids=["float", "fixed"])
def test_no_gather_count_without_a_band_or_stream_launch(fixed):
    """Counted at a band or stream launch on the card alone: a call of a
    gather step on the CPU (its plain version, no launch) and of a
    phase-tiled step add nothing."""
    reset_launches()
    spec = fd.design_filter(44100, 44101, 7, fixed_point=fixed)
    tspec = fd.design_filter(147, 160, 7, fixed_point=fixed)
    for s, b, scheme in ((spec, _launch_geometry(spec, 44100), "auto"),
                         (tspec, _launch_geometry(tspec, 2352),
                          "auto" if fixed else "highest")):
        step = make_batched_step(s, b, device="cpu", scheme=scheme)
        hist = torch.zeros((step.hist_rows, 2), dtype=torch.int16)
        x = torch.randint(-3000, 3000, (b.in_per_launch, 2),
                          dtype=torch.int16,
                          generator=torch.Generator().manual_seed(7))
        _, y = step.fn(hist, x, step.w)
        assert y.shape == (b.out_per_launch, 2)
    assert gather_counts() == (0, 0, 0, 0)
    assert counter_totals() == {}


def _gather_view(calls: int, kernel_s: float):
    """A traced view of ``calls`` calls, each one launch of the float band
    gather of ``kernel_s`` seconds and the next history's copy."""
    dev, t = [], 0.0
    for _ in range(calls):
        dev.append(("void (anonymous namespace)::gather_fir_f64mma_kernel"
                    "<short>(Gather, F64Band, int)", t, t + kernel_s))
        dev.append(("Memcpy DtoD (Device -> Device)", t + kernel_s,
                    t + kernel_s + 1.4e-6))
        t += kernel_s + 5e-6
    return TraceView(calls=calls, device=dev, host=[], work=None,
                     peaks=None)


def test_cta_tile_reader_reads_the_counters_and_none_without(monkeypatch):
    """``gather.cta_tile_us``: the port kernels' device time a call times
    resident CTAs over tiles, from the counters' totals (~4.4 us at a
    0.73 ms drift launch); None with no device operation, with no gather
    launch counted, and where the program keeps no such counters (an
    earlier port's ``utils/profiling``)."""
    from speex_resampler_tpu_torch.utils import profiling
    read = manifest.reader("gather.cta_tile_us")
    view = _gather_view(3, 0.73e-3)
    fm.launch_ctas.cache_clear()
    reset_launches()
    assert read(view) is None
    sf.count_fixed(132, 17920, 210)
    assert read(view) is None
    lib = _Library()
    for _ in range(5):
        fm.count_gather(lib, 0, PLAN, None, 2, 44101, 2048)
    assert read(view) == pytest.approx(730.0 * RESIDENT / TILES)
    assert read(view) == pytest.approx(4.364, abs=1e-3)
    assert read(TraceView(0, [], [], None, None)) is None
    monkeypatch.delattr(profiling, "counter_totals")
    assert read(view) is None
    reset_launches()
    fm.launch_ctas.cache_clear()


@pytest.mark.parametrize("rates", [(44100, 44101, 7)])
def test_design_copy_equals_the_ports(rates):
    """The benchmark's frozen design copy builds the port's float tables
    bit for bit at the drift ratio (44101 phases, the interpolated
    table)."""
    from perfbench.reference.speex_design import design
    d = design(*rates)
    g = math.gcd(rates[0], rates[1])
    spec = fd.design_filter(rates[0] // g, rates[1] // g, rates[2])
    assert (d.filt_len, d.oversample, d.use_direct) == (
        spec.filt_len, spec.oversample, spec.use_direct) == (128, 16, False)
    assert np.array_equal(d.sinc_table, spec.sinc_table)


def _run_small(program=None, seconds=2.0):
    """The harness's run of the cell at 8 lanes on the CPU."""
    return run_cell(small_cell(CELL), SEED, seconds, False, device="cpu",
                    program=program)


def test_sound_run_is_correct():
    """The harness's run of the cell at 8 lanes, its pool and warm-up as
    the traffic gives them: correct over at least two calls, both checks
    and both end-to-end metrics, each positive."""
    r = _run_small()
    assert r["correct"] is True and r["failed"] == 0
    assert r["attempted"] >= 2
    assert list(r)[-1] == "checks"
    assert set(r["checks"]) == {"max_err_lsb", "off_share"}
    assert r["checks"]["max_err_lsb"]["value"] <= 1
    assert set(r["metrics"]) == {"out_rate", "setup_s"}
    assert all(m["value"] > 0 for m in r["metrics"].values())


def test_control_in_bfloat16_is_not_correct():
    """The reference in bfloat16, put in the program's place, fails both
    of the cell's limits by far."""
    r = _run_small(program=_control, seconds=0.1)
    assert r["correct"] is False
    assert r["checks"]["max_err_lsb"]["value"] > 10
    assert r["checks"]["off_share"]["value"] > 0.5


@pytest.mark.gpu
def test_command_on_the_card():
    """The cell's command for 2 s on the card: correct, both metrics."""
    import json
    import subprocess
    import sys
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", CELL, "--seed",
         str(SEED), "--seconds", "2", "--trace", "0"],
        cwd=manifest.ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] is True
    assert set(r["metrics"]) == {"out_rate", "setup_s"}
