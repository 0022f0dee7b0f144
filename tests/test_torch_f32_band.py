"""What the "highest" kernel's sub-band skip relies on, on the CPU.

``csrc/f32_fir.cuh`` copies the union of a 64-row tile's nonzero tap
bands and lets each warp multiply only the 8-tap slices that meet its own
16 rows' band (``tiled_fir.f32_walk``).  The skip leaves every output's
FMA chain as it was only if every skipped product has a weight of exactly
0.  These tests pin that on the weights of the served "highest" launches:

- each weight column's nonzero taps form one run;
- the 16-row table (``tiled_fir.tap_ranges(.., SUB_ROWS)``) covers every
  nonzero weight, tightly, nests inside the 64-row band, and its union
  per tile is that band; the walked slices cover each sub-band;
- the table built from the port's weights equals the one built through
  ``weights_from_jax`` from the JAX package's step.

Configs: 44.1k->48k q7 (tiled), 48k->44.1k q10 at f0 = 0 and at the phase
a flush of 4040 frames leaves (streamed, K_pad = 512), 96k->8k q10 (tiled,
K 4600) and 44.1k->16k q7 (streamed).  No kernel runs here.
"""

import functools
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

torch.set_num_threads(1)

# (in, out, quality, target frames, frames a flush stages before the launch)
CASES = {"44k1-48k-q7": (44100, 48000, 7, 9408, 0),
         "48k-44k1-q10": (48000, 44100, 10, 20480, 0),
         "48k-44k1-q10-flush": (48000, 44100, 10, 20480, 4040),
         "96k-8k-q10": (96000, 8000, 10, 30720, 0),
         "44k1-16k-q7": (44100, 16000, 7, 7056, 0)}


def _reduced(i: int, o: int) -> tuple:
    g = math.gcd(i, o)
    return i // g, o // g


@functools.cache
def _port_step(case: str):
    i, o, q, target, staged = CASES[case]
    spec = tfd.design_filter(*_reduced(i, o), q)
    m = tph.producible_outputs(staged, 0, 0, spec.num, spec.den)
    f0 = (m * spec.num) % spec.den
    assert (f0 != 0) == (staged != 0)
    bspec = tb._launch_geometry(spec, target, f0=f0)
    return f0, tb.make_batched_step(spec, bspec, device="cpu",
                                    scheme="highest")


def _weights(case: str):
    _, step = _port_step(case)
    w, bands = (t.numpy() for t in step.w)
    return w, bands


@pytest.mark.parametrize("case", CASES)
def test_each_column_is_one_run(case):
    w, _ = _weights(case)
    nz = w != 0                                       # [P, K, R]
    K = nz.shape[1]
    count = nz.sum(axis=1)
    first = nz.argmax(axis=1)
    last = K - nz[:, ::-1, :].argmax(axis=1)
    assert count.min() > 0
    assert np.array_equal(count, last - first)


@pytest.mark.parametrize("case", CASES)
def test_sub_bands_cover_and_nest_in_the_row_tile_band(case):
    w, bands = _weights(case)
    P, K, R = w.shape
    per = ttf.ROW_TILE // ttf.SUB_ROWS
    assert bands.dtype == np.int32 and bands.shape == (P, R // ttf.SUB_ROWS,
                                                       2)
    assert np.array_equal(bands, ttf.tap_ranges(w != 0, ttf.SUB_ROWS))
    tiles = ttf.tap_ranges(w != 0)                    # [P, R / 64, 2]
    walk = ttf.f32_walk(bands)
    for m in range(P):
        for i in range(R // ttf.SUB_ROWS):
            lo, hi = bands[m, i]
            cols = w[m, :, i * ttf.SUB_ROWS:(i + 1) * ttf.SUB_ROWS]
            assert lo < hi and cols[lo].any() and cols[hi - 1].any()
            assert not cols[:lo].any() and not cols[hi:].any()
            t_lo, t_hi = tiles[m, i // per]
            assert t_lo <= lo and hi <= t_hi
            # whole 8-tap slices from the tile's band start cover [lo, hi)
            first = t_lo + (lo - t_lo) // ttf.K_SLICE * ttf.K_SLICE
            assert first <= lo and first + walk[m, i] >= hi
            assert walk[m, i] % ttf.K_SLICE == 0
            assert walk[m, i] < hi - lo + 2 * ttf.K_SLICE
        sub = bands[m].reshape(-1, per, 2)
        assert np.array_equal(sub[:, :, 0].min(axis=1), tiles[m, :, 0])
        assert np.array_equal(sub[:, :, 1].max(axis=1), tiles[m, :, 1])


@pytest.mark.parametrize("case", CASES)
def test_table_from_jax_weights_equals_the_port_table(case):
    i, o, q, target, _ = CASES[case]
    f0, tstep = _port_step(case)
    js = jfd.design_filter(*_reduced(i, o), q)
    jspec = jb._launch_geometry(js, target, use_pallas=True, f0=f0)
    assert jspec.kernel == tstep.kernel
    jstep = jb.make_batched_step(js, jspec, use_pallas=True,
                                 pallas_interpret=True, scheme="highest")
    got = tb.weights_from_jax(np.asarray(jstep.w), "highest", device="cpu",
                              kernel=tstep.kernel)
    assert len(got) == len(tstep.w) == 2
    for a, b in zip(got, tstep.w):
        assert a.dtype == b.dtype and torch.equal(a, b)
