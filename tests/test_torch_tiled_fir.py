"""The port's tiled FIR launch against the JAX package's v3 Pallas kernel.

``resample_tiled_reference`` (the CUDA kernel's plain PyTorch version, and
what ``resample_tiled`` runs for CPU tensors) is held against
``resample_conv_tm_pallas_v3`` in interpret mode, reached through each
package's ``make_batched_step`` with the same history, slab and weights:
the flagship at f0 = 0 and at the phase a flush leaves, 44.1k->24k q5
(P = 10) and 24k->48k q5 (P = 1, R = 256), schemes highest and int8, with
B = 4 and B = 130 lanes (the JAX wrapper pads lanes to 128; the port
masks them).

Tolerance: "int8" is bit-identical (exact integer dots, the same f32
epilogue order); "highest" is within the LSB contract
(conftest.assert_lsb_close), its f32 sums running in another order.  The
CUDA kernel itself is held against the plain version by
tests/test_torch_gpu.py and chip_smoke.py on the card.
"""

import math

import numpy as np
import pytest
import torch

from speex_resampler_tpu.ops import filter_design as jfd
from speex_resampler_tpu.parallel import batch as jb
from speex_resampler_tpu_torch.ops import filter_design as tfd
from speex_resampler_tpu_torch.ops import phase as tph
from speex_resampler_tpu_torch.ops import tiled_fir as ttf
from speex_resampler_tpu_torch.parallel import batch as tb

from conftest import assert_lsb_close

torch.set_num_threads(1)

# (in_rate, out_rate, quality, target frames = 2 launch units, f0, B)
FLAGSHIP = (44100, 48000, 7, 4704)
CASES = [
    FLAGSHIP + ("0", 4), FLAGSHIP + ("0", 130),
    FLAGSHIP + ("flush", 4), FLAGSHIP + ("flush", 130),
    (44100, 24000, 5, 4704, "0", 4),
    (24000, 48000, 5, 2560, "0", 4),
]


def _steps(i, o, q, target, f0, scheme):
    g = math.gcd(i, o)
    js = jfd.design_filter(i // g, o // g, q)
    ts = tfd.design_filter(i // g, o // g, q)
    if f0 == "flush":   # the phase a flush of 3368 staged frames leaves
        m = tph.producible_outputs(3368, 0, 0, ts.num, ts.den)
        f0 = (m * ts.num) % ts.den
        assert f0 != 0
    f0 = int(f0)
    jspec = jb._launch_geometry(js, target, use_pallas=True, f0=f0)
    tspec = tb._launch_geometry(ts, target, f0=f0)
    assert tspec.kernel == "tiled" and tspec.n_blocks == jspec.n_blocks
    jstep = jb.make_batched_step(js, jspec, use_pallas=True,
                                 pallas_interpret=True, scheme=scheme)
    tstep = tb.make_batched_step(ts, tspec, device="cpu", scheme=scheme)
    assert jstep.scheme == tstep.scheme == scheme
    return jstep, tstep, tspec


def _inputs(step, n_in, B, seed):
    rng = np.random.default_rng(seed)
    hist = rng.integers(-32768, 32768, (step.hist_rows, B), dtype=np.int16)
    x = np.zeros((step.chunk_rows, B), dtype=np.int16)
    x[:n_in] = rng.integers(-32768, 32768, (n_in, B), dtype=np.int16)
    return hist, x


def _compare(got, want, scheme):
    if scheme == "int8":
        mismatches = int((got != want).sum())
        assert mismatches == 0, f"{mismatches} int8 mismatches"
    else:
        assert_lsb_close(got, want)


@pytest.mark.parametrize("scheme", ["highest", "int8"])
@pytest.mark.parametrize(
    "case", CASES, ids=lambda c: f"{c[0]}-{c[1]}-q{c[2]}-f0{c[4]}-B{c[5]}")
def test_reference_matches_jax_v3(case, scheme):
    i, o, q, target, f0, B = case
    jstep, tstep, tspec = _steps(i, o, q, target, f0, scheme)
    hist, x = _inputs(tstep, tspec.in_per_launch, B, seed=B + q)
    jh, jy = jstep.fn(hist, x, jstep.w)
    th, ty = tstep.fn(torch.from_numpy(hist), torch.from_numpy(x), tstep.w)
    assert ty.shape == (tspec.out_per_launch, B)
    _compare(ty.numpy(), np.asarray(jy), scheme)
    assert np.array_equal(th.numpy(), np.asarray(jh))
    # on CPU tensors the step launches the plain version
    kw = tstep.kernel_kw
    direct = ttf.resample_tiled_reference(
        torch.from_numpy(hist), torch.from_numpy(x), tstep.w, **kw)
    assert torch.equal(direct, ty)


def test_cpu_tensors_never_launch_a_kernel():
    """On CPU tensors the wrapper runs the plain version and counts no
    launch; a device without a kernel is refused."""
    _, tstep, tspec = _steps(*FLAGSHIP[:3], 2352, "0", "highest")
    hist, x = _inputs(tstep, tspec.in_per_launch, 3, seed=0)
    before = dict(ttf.launches)
    ttf.resample_tiled(torch.from_numpy(hist), torch.from_numpy(x),
                       tstep.w, **tstep.kernel_kw)
    assert ttf.launches == before
    with pytest.raises(NotImplementedError, match="K1c"):
        ttf.resample_tiled(torch.from_numpy(hist), torch.from_numpy(x),
                           tstep.w, **{**tstep.kernel_kw,
                                       "scheme": "split5"})
    meta = torch.empty((4,), device="meta")
    with pytest.raises(ValueError):
        ttf.resample_tiled(torch.from_numpy(hist), torch.from_numpy(x),
                           tstep.w, **{**tstep.kernel_kw, "offsets": meta})
