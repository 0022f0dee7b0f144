"""The benchmark's Q15 deployment, ``stage.q10.fixed``: Speex's fixed-point
build at 48 -> 44.1 kHz, quality 10, on the port's streamed fixed step.

On the CPU: the cell's plain reference (``perfbench/reference/
speex_fixed.py``) equals the port's step bit for bit over calls with the
history carried, its int16 table equals the port's, and its outputs equal
the JAX package's fixed host route (a witness that is not the port's
code); a limit of 0 passes the port and fails the bfloat16 control, the
float reference and each fault; the span ``speex.setup.q15`` opens in a
fixed step's set-up alone and its reader reads it; the cell resolves to
the streamed fixed kernel; the reference loads neither package nor JAX.
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
from speex_resampler_tpu_torch.functional import make_stream_fn
from speex_resampler_tpu_torch.ops import filter_design as fd
from speex_resampler_tpu_torch.parallel.batch import (_launch_geometry,
                                                      clear_step_cache,
                                                      make_batched_step)
from speex_resampler_tpu_torch.utils.profiling import reset_spans, span_totals

REPO = Path(__file__).resolve().parent.parent
CELL = "stage.q10.fixed"
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
def test_a_limit_of_zero_passes_the_port_alone(name):
    """On the cell narrowed to 8 lanes, two quanta and one warm-up call:
    the port is correct with 0 / 0; the reference in bfloat16, the float
    build's reference and each fault in the program's place are not."""
    c = small_cell(CELL)
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
    from perfbench.tracing import TraceView
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


def test_the_cell_resolves_to_the_streamed_fixed_kernel():
    c = manifest.cell(CELL)
    cfg = c.config
    assert (cfg["numeric"], cfg["limits"]) == (
        "fixed", {"max_err_lsb": 0, "off_share": 0})
    assert manifest.reference(cfg).NUMERICS == ("fixed",)
    assert [m["name"] for m in c.per_layer][-1] == "setup.q15_s"
    g = math.gcd(cfg["in_rate"], cfg["out_rate"])
    spec = fd.design_filter(cfg["in_rate"] // g, cfg["out_rate"] // g,
                            cfg["quality"], fixed_point=True)
    bspec = _launch_geometry(spec, cfg["target_in_frames"])
    step = make_batched_step(spec, bspec, device="cpu", scheme=cfg["scheme"])
    assert (step.kernel, step.scheme, step.kernel_kw["n_accum"]) == (
        "streamed", "fixed", 4)
    assert (bspec.in_per_launch, bspec.out_per_launch) == (20480, 18816)
    planes, bias, coef = step.w[:3]
    assert (tuple(planes.shape), tuple(bias.shape), tuple(coef.shape)) == (
        (2, 147, 512, 512), (147, 512), (147, 4, 128))
    assert sx.filter_size(cfg) == (280, 2 * (32 * 280 + 8))


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
