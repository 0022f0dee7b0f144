"""The port's BatchedResampler.skip_zeros against the JAX package's.

``skip_zeros`` swallows the filter delay at any time, like the C API
(resample.c:1200-1206): before the first sample, with a sub-quantum
remainder staged (the engine drains it exactly, which moves the
fractional phase and rebuilds the step), and right at a launch boundary.
The port on the CPU (the kernels' plain versions) and the JAX engine in
interpret mode get the same ragged calls; int8 and fixed outputs must be
bit-identical, and the engines' skip, phase and staged state equal.
"""

import numpy as np
import pytest
import torch

from speex_resampler_tpu.parallel.batch import BatchedResampler as JaxEngine
from speex_resampler_tpu_torch import BatchedResampler

torch.set_num_threads(1)

S, C = 2, 2
RATES = (44100, 48000, 7)
TARGET = 2352


def _frames(n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-32768, 32768, (S, n, C), dtype=np.int16)


def _drive(eng):
    """skip_zeros first; 3000 frames (one launch, 648 staged); skip_zeros
    (drains the 648); 4059 frames (absorbs filt_len // 2, then exactly one
    launch, nothing staged); skip_zeros at the boundary; 2000 frames;
    flush."""
    outs, states = [], []
    eng.skip_zeros()
    for k, n in enumerate((3000, None, 4059, None, 2000)):
        if n is None:
            eng.skip_zeros()
            st = eng.state_dict()
            states.append((st["skip"], st["f0"], len(st["staged"])))
        else:
            outs.append(eng.process(_frames(n, 40 + k)))
    outs.append(eng.flush())
    return outs, states


@pytest.mark.parametrize("kind", ["int8", "fixed"])
def test_skip_zeros_anytime_matches_jax(kind):
    kw = (dict(fixed_point=True) if kind == "fixed"
          else dict(scheme="int8"))
    jax_eng = JaxEngine(S, C, *RATES, target_chunk_frames=TARGET,
                        use_pallas=True, pallas_interpret=True, **kw)
    port = BatchedResampler(S, C, *RATES, target_chunk_frames=TARGET,
                            device="cpu", **kw)
    want_out, want_states = _drive(jax_eng)
    got_out, got_states = _drive(port)
    assert port._step.scheme == kind
    assert got_states == want_states
    assert got_states[0][1] != 0            # the drain moved the phase
    assert got_states[1][2] == 0            # nothing staged at the boundary
    for g, w in zip(got_out, want_out):
        assert g.shape == w.shape and np.array_equal(g, w)
    assert sum(o.shape[1] for o in got_out) > 0
