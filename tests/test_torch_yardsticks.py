"""The exact library yardsticks of ``chip_smoke.py``'s int8 and fixed rows,
on the CPU.

``chip_smoke.library_call`` times one PyTorch call that computes the same
function as a kernel.  For the tiled and streamed int8 and fixed kernels
that call is one float64 ``torch.bmm``: of the D digit planes stacked
along the output axis against the patches of x - 128 (int8), or of the
int16 taps against the patches (fixed).  Both are exact integer dots, so
after the kernel's epilogue (int8: the f32 digit sum and bias; fixed: the
int32 wrap and the Q15 epilogue) the result must equal the plain version
bit for bit, which the call checks itself.  Here the same calls run on CPU
tensors at chip_smoke's own paths, a few lanes wide, with full-scale rows
(int8) and the wrap input (fixed), and at the int8 probes' launches (P5's
five variants, P9a); P7's int16 forms take one float64 ``torch.mm`` of
their body, exact after the wrap to int32, and its i32 form none; P2's
rungs one float64 ``torch.mm`` of their four salted bodies, exact after
their epilogue; and a plain version moved by one LSB makes the check fail.
Nothing is timed.
"""

import dataclasses

import pytest
import torch

import chip_smoke as cs
import fixed_inputs
from speex_resampler_tpu_torch.ops import tiled_fir as tf
from speex_resampler_tpu_torch.parallel import batch as tb
from speex_resampler_tpu_torch.probes import fixed_interp_anatomy as pfa
from speex_resampler_tpu_torch.probes import mosaic_int_dot_bench as pid
from speex_resampler_tpu_torch.probes import v3_overhead_anatomy as pv3
from speex_resampler_tpu_torch.probes import v5_int8_bench as pv5

torch.set_num_threads(2)

LANES = 5

#: (path, requested scheme, geometry override, int8 digits D)
CASES = {
    "tiled-int8": (cs.FLAGSHIP, "int8", None, 3),
    "streamed-int8-auto": (cs.SLICE, "auto", None, 4),
    "tiled-fixed4": (cs.FIXED_FLAGSHIP, "auto", None, 0),
    "streamed-fixed4": (cs.FIXED_SLICE, "auto", None, 0),
    "tiled-fixed1": (cs.FIXED_DIRECT, "auto", None, 0),
    "streamed-fixed1": (cs.FIXED_DIRECT, "auto", "streamed", 0),
}


def _launch(name):
    path, scheme, kernel, D = CASES[name]
    bspec = path.geometry(0)
    if kernel is not None:
        bspec = dataclasses.replace(bspec, kernel=kernel)
    step = tb.make_batched_step(path.spec, bspec, device="cpu",
                                scheme=scheme)
    assert step.kernel == (kernel or path.kernel)
    assert step.scheme == ("fixed" if path.fixed else "int8")
    if D:
        assert step.w[0].shape[0] == D
    hist, x = fixed_inputs.launch_inputs(step, bspec.in_per_launch, LANES,
                                         seed=1, wrap=path.fixed)
    hist, x = torch.from_numpy(hist), torch.from_numpy(x)
    if not path.fixed:                 # full-scale rows, as chip_smoke's
        x[0:bspec.in_per_launch:97, 1] = -32768
        x[1:bspec.in_per_launch:89, 2] = 32767
    return step, bspec, hist, x


@pytest.mark.parametrize("name", list(CASES))
def test_library_call_equals_plain(name, capsys):
    """One float64 bmm, its epilogue outside the call, equals the plain
    version bit for bit; the call returns the product alone."""
    step, bspec, hist, x = _launch(name)
    fn = cs.library_call(step, bspec, hist, x, reps=1)
    printed = capsys.readouterr().out
    assert "float64 bmm" in printed and "mismatches=0" in printed, printed
    y = fn()
    rows = (step.w[0].shape[0] * step.w[0].shape[-2] if step.scheme == "int8"
            else tf.fixed_taps16(step.w[0]).shape[-1])
    assert y.dtype == torch.float64
    assert y.shape == (bspec.n_blocks, rows, LANES)
    assert torch.equal(y, torch.round(y))


@pytest.mark.parametrize("name", ["tiled-int8", "streamed-fixed4"])
def test_library_call_check_catches_one_lsb(name, monkeypatch):
    """A plain version moved by one LSB on one output: the library call's
    own check raises."""
    step, bspec, hist, x = _launch(name)
    plain = cs.plain

    def off_by_one(*args):
        y = plain(*args).clone()
        y[3, 1] += 1 if y[3, 1] < 32767 else -1
        return y

    monkeypatch.setattr(cs, "plain", off_by_one)
    with pytest.raises(AssertionError, match="library bmm: 1 mismatches"):
        cs.library_call(step, bspec, hist, x, reps=1)


@pytest.mark.parametrize("variant", list(pv3.VARIANTS) + ["v5 int8"])
def test_int8_probe_library_call_equals_plain(variant, capsys):
    """The int8 probes' library call (P5's variants at the flagship, the
    raw ones the summed planes' dots wrapped to int16; P9a without the
    halo) equals the probe's plain version bit for bit."""
    if variant == "v5 int8":
        g = pv5.geometry()
        w, kw = pv5.weights(g, "int8"), pv5.launch_kw(g, "int8")
        fn = cs.int8_probe_library_call("v5_bench", "int8", None,
                                        pv5.inputs(g, B=LANES), w, kw)
    else:
        g = pv3.geometry()
        hist, x = pv3.inputs(g, B=LANES)
        fn = cs.int8_probe_library_call("v3_anatomy", variant, hist, x,
                                        pv3.weights(g), pv3.launch_kw(g))
    printed = capsys.readouterr().out
    assert "float64 bmm" in printed and "mismatches=0" in printed, printed
    y = fn()
    assert y.dtype == torch.float64 and torch.equal(y, torch.round(y))


@pytest.mark.parametrize("form", ["i16i16", "i16i8", "i32i32"])
def test_int_dot_library_call(form):
    """P7's exact forms: the int16 ones' float64 mm of the body, wrapped to
    int32, equals the plain version's body; i32.i32 has none."""
    w, x = pid.inputs()
    fn = pid.library_call(w, x, form)
    if form == "i32i32":
        assert fn is None
        return
    assert torch.equal(tf.wrap_int32(fn()),
                       pid.int_dot_reference(w, x, form)[0])


@pytest.mark.parametrize("rung", list(pfa.RUNGS))
@pytest.mark.parametrize("seed", [0, 3])
def test_fixed_ladder_library_call(rung, seed):
    """P2's rungs: one float64 mm of the salted bodies, then the rung's
    epilogue outside it, equals the ladder's plain version bit for bit."""
    planes, bias, coef, xh, x16 = pfa.inputs(seed=seed)
    xr = pfa.rung_input(rung, xh, x16)
    y = pfa.library_call(rung, planes, bias, coef, xr)()
    assert y.dtype == torch.float64 and torch.equal(y, torch.round(y))
    assert torch.equal(pfa.library_epilogue(rung, y, bias, coef),
                       pfa.ladder_reference(rung, planes, bias, coef, xr))
