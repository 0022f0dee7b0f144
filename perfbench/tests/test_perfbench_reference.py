"""The plain reference against the port's CPU step (its kernels' plain
versions), its filter design against the port's, and against a witness
that is not the port's code: the closed form of resample.c's taps."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from perfbench import signals
from perfbench.reference.speex_design import design
from perfbench.reference.speex_float import CallReference, word2int
from speex_resampler_tpu_torch.functional import make_stream_fn
from speex_resampler_tpu_torch.ops import filter_design as fd

from .util import small_cell

CELLS = ("stage.q7", "stage.q10")


@pytest.mark.parametrize("rates", [(44100, 48000, 7), (48000, 44100, 10),
                                   (16000, 48000, 5), (48000, 16000, 3),
                                   (44100, 22050, 4)])
def test_design_copy_equals_the_ports(rates):
    """The frozen copy builds the port's float tables bit for bit."""
    d = design(*rates)
    g = math.gcd(rates[0], rates[1])
    spec = fd.design_filter(rates[0] // g, rates[1] // g, rates[2])
    assert (d.filt_len, d.oversample, d.use_direct) == (
        spec.filt_len, spec.oversample, spec.use_direct)
    assert np.array_equal(d.sinc_table, spec.sinc_table)


def test_word2int_saturates_and_rounds_half_up():
    y = torch.tensor([-40000.0, -32767.6, -32767.5, -0.5, 0.49, 0.5,
                      32766.5, 32766.6, 1e9])
    assert word2int(y).tolist() == [-32768, -32768, -32767, 0, 0, 1,
                                     32767, 32767, 32767]


@pytest.mark.parametrize("name", CELLS)
def test_reference_meets_the_port_step_within_one_lsb(name):
    """Three calls of each configuration's stream, history carried, on
    the mix's signals plus a lane of full-scale square waves: the port's
    CPU step within 1 LSB of the reference, on few outputs."""
    cfg = small_cell(name).config
    rs = make_stream_fn(cfg["in_rate"], cfg["out_rate"], cfg["quality"],
                        target_in_frames=cfg["target_in_frames"],
                        device="cpu")
    ref = CallReference(cfg["in_rate"], cfg["out_rate"], cfg["quality"],
                        rs.in_frames, rs.out_frames, "cpu")
    pool, walk = signals.make_pool(small_cell(name).traffic, rs.in_frames,
                                   6, cfg["in_rate"], 7, "cpu")
    pool[:, ::64, 0] = 32767
    pool[:, 32::64, 0] = -32768
    hist, prev = rs.init(6), None
    for k in range(3):
        x = pool[walk[k % len(walk)]]
        hist, y = rs.step(hist, x)
        err = (y.int() - ref(prev, x).int()).abs()
        assert int(err.max()) <= 1
        assert float((err != 0).float().mean()) <= cfg["limits"]["off_share"]
        prev = x


def test_reference_history_spans_only_the_previous_call():
    """A call worked out from the previous call's input equals the same
    outputs of one long call over both (a fresh stream)."""
    ref1 = CallReference(44100, 48000, 7, 147 * 4, 160 * 4, "cpu")
    ref2 = CallReference(44100, 48000, 7, 147 * 8, 160 * 8, "cpu")
    x = torch.randint(-20000, 20000, (147 * 8, 3), dtype=torch.int16)
    whole = ref2(None, x)
    assert torch.equal(ref1(None, x[:588]), whole[:640])
    assert torch.equal(ref1(x[:588], x[588:]), whole[640:])


# A witness of the design copy that is not the port's code: the float64
# closed form of resample.c's taps, sinc(cutoff, x) x Kaiser(|2x / N|),
# with each configuration's length, oversampling, cutoff and window
# worked out by hand from resample.c's quality_map and update_filter.
# KAISERn is a Kaiser window of beta n that compute_func interpolates
# cubically from a table of WINDOW_OVERSAMPLE[n] points a unit.
WINDOW_OVERSAMPLE = {12: 64, 10: 32, 8: 32, 6: 32}
#: (in, out, quality): filt_len, oversample, cutoff, Kaiser beta
WITNESS = {
    # upsampling: cutoff = upsample_bandwidth; 160 N > 16 N + 8: table
    (44100, 48000, 7): (128, 16, 0.950, 10),
    # downsampling: cutoff = 0.975 x 147 / 160; N = 256 x 160 / 147 =
    # 278, rounded up to a multiple of 8; 2 x 147 >= 160 keeps 32
    (48000, 44100, 10): (280, 32, 0.975 * 147 / 160, 12),
    # 1/3: 3 N <= 16 N + 8, the direct path (a row a phase)
    (16000, 48000, 5): (80, 16, 0.940, 10),
}
#: float32's step at 1: the copy's taps are float32
ULP = float(np.spacing(np.float32(1.0)))
#: everywhere: Speex's cubic interpolation of its window tables departs
#: from the closed form by up to 3.3e-6 (q5 direct) / 2.5e-6 (q7) /
#: 2.4e-7 (q10); a 0.1 % cutoff error reads 9e-4
WINDOW_INTERP_TOL = 5e-6


def _kaiser(beta: float, x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    out = np.zeros_like(x)
    inside = x <= 1
    out[inside] = (np.i0(beta * np.sqrt(1 - x[inside] ** 2))
                   / np.i0(beta))
    return out


def _sinc(cutoff, x, N, beta):
    with np.errstate(divide="ignore", invalid="ignore"):
        v = (cutoff * np.sin(np.pi * x * cutoff) / (np.pi * x * cutoff)
             * _kaiser(beta, 2 * x / N))
    return np.where(np.abs(x) < 1e-6, cutoff,
                    np.where(np.abs(x) > N / 2, 0.0, v))


def _closed_form(rates, N, oversample, cutoff, beta, shift=0.0):
    """(x of each table entry, its float64 tap) in the C table's layout."""
    g = math.gcd(rates[0], rates[1])
    den = rates[1] // g
    if N * den <= N * oversample + 8:
        i = np.arange(den)[:, None]
        x = ((np.arange(N)[None, :] - N // 2 + 1) - i / den).reshape(-1)
    else:
        x = np.arange(-4, oversample * N + 4) / oversample - N // 2
    x = x + shift
    return x, _sinc(cutoff, x, N, beta)


@pytest.mark.parametrize("table,beta", [("_KAISER12", 12), ("_KAISER10", 10),
                                        ("_KAISER8", 8), ("_KAISER6", 6)])
def test_window_tables_are_kaiser_windows(table, beta):
    """Each window table of the copy is I0(beta sqrt(1 - x^2)) / I0(beta)
    at x = -1/os, 0, 1/os, ..., 1, to its 8 printed decimals."""
    from perfbench.reference import speex_design
    t = getattr(speex_design, table)
    os_ = WINDOW_OVERSAMPLE[beta]
    x = (np.arange(os_ + 2) - 1) / os_
    assert np.abs(t[:os_ + 2] - _kaiser(beta, x)).max() < 1e-8


@pytest.mark.parametrize("rates", sorted(WITNESS))
def test_design_copy_meets_the_closed_form(rates):
    """The copy's table against the closed form: within a float32 step
    where the window's argument falls on a node of its table (cubic
    interpolation is exact there), and within the interpolation's own
    error everywhere; length, oversampling and path as worked out by
    hand."""
    N, oversample, cutoff, beta = WITNESS[rates]
    d = design(*rates)
    assert (d.filt_len, d.oversample) == (N, oversample)
    assert d.use_direct == (rates == (16000, 48000, 5))
    x, want = _closed_form(rates, N, oversample, cutoff, beta)
    assert d.sinc_table.shape == want.shape
    diff = np.abs(d.sinc_table.astype(np.float64) - want)
    arg = np.abs(2 * x / N) * WINDOW_OVERSAMPLE[beta]
    node = np.abs(arg - np.round(arg)) < 1e-9
    assert node.sum() >= 16
    assert diff[node].max() <= ULP
    assert diff.max() <= WINDOW_INTERP_TOL


@pytest.mark.parametrize("fault", ["cutoff", "window", "length", "phase"])
@pytest.mark.parametrize("rates", sorted(WITNESS))
def test_the_closed_form_tells_a_wrong_design(rates, fault):
    """A design off by a 0.1 % cutoff, the next Kaiser window, 8 taps or
    a table step would fail the comparison above."""
    N, oversample, cutoff, beta = WITNESS[rates]
    d = design(*rates)
    kw = {"cutoff": dict(cutoff=cutoff * 1.001),
          "window": dict(beta=beta - 2),
          "length": dict(N=N + 8),
          "phase": dict(shift=1.0 / oversample)}[fault]
    args = dict(N=N, oversample=oversample, cutoff=cutoff, beta=beta)
    args.update({k: v for k, v in kw.items() if k != "shift"})
    _, want = _closed_form(rates, **args, shift=kw.get("shift", 0.0))
    if fault == "length":   # the table's size tells it
        assert want.shape != d.sinc_table.shape
    else:
        assert np.abs(d.sinc_table - want).max() > 10 * WINDOW_INTERP_TOL
