"""Inputs that drive the fixed-point kernels' int32 accumulators past 2^31.

Shared by tests/test_torch_fixed.py (CPU, against the JAX package),
tests/test_torch_gpu.py (the CUDA kernels against their plain versions)
and chip_smoke.py.  Imports torch and the port only.
"""

import numpy as np

from speex_resampler_tpu_torch.ops import streamed_fir as sf
from speex_resampler_tpu_torch.ops import tiled_fir as tf


def block_origins(step) -> np.ndarray:
    """Each block's patch origin on the virtual axis hist ++ x, for a step
    of ``parallel/batch.make_batched_step`` (tiled and streamed:
    their closed-form origins; dense: a launch's n_in rows are n_in /
    stride blocks)."""
    kw = step.kernel_kw
    if step.kernel == "dense":
        return np.arange(step.chunk_rows // kw["stride"]) * kw["stride"]
    if step.scheme == "int8":                     # [D, P, R, K]
        R = step.w[0].shape[-2]
    elif step.scheme == "fixed":                  # [2, P, n_accum R, K]
        R = step.w[0].shape[-2] // kw["n_accum"]
    else:                                         # [.., K, R]
        R = step.w[0].shape[-1]
    return sf.origins(kw["n_blocks"], R, shift=kw["shift"], num=kw["num"],
                      den=kw["den"], f0=kw["f0"]).numpy()


def launch_inputs(step, n_in: int, B: int, seed: int, wrap: bool = True):
    """Random int16 history and chunk for one launch of ``step``: ``n_in``
    real chunk rows, zeros after them.  With ``wrap``, every third lane
    carries :func:`wrap_input`; raises AssertionError if its accumulator
    stays within int32."""
    rng = np.random.default_rng(seed)
    hist = rng.integers(-32768, 32768, (step.hist_rows, B), dtype=np.int16)
    x = np.zeros((step.chunk_rows, B), dtype=np.int16)
    x[:n_in] = rng.integers(-32768, 32768, (n_in, B), dtype=np.int16)
    if wrap and wrap_input(step, x, np.arange(0, B, 3)) <= 2 ** 31:
        raise AssertionError("the wrap input does not pass 2^31")
    return hist, x


def _wrap_window(step):
    """(first chunk row, taps int64[n]) of the output whose window lies
    wholly in the chunk and whose weight column (accumulator) has the
    largest sum |w|: a block's column for tiled, streamed and dense steps,
    an output's tap row for gather steps."""
    H = step.hist_rows
    if step.kernel == "gather":
        taps, starts = (t.cpu().numpy().astype(np.int64) for t in step.w[:2])
        taps = taps.reshape(taps.shape[0], -1, taps.shape[-1])  # [n, c, N]
        o = int(np.flatnonzero(starts >= H)[0])
        c = int(np.abs(taps[o]).sum(axis=1).argmax())
        return starts[o] - H, taps[o, c]
    w = step.w[0]
    if step.kernel != "dense":                    # int8 planes
        w = tf.fixed_taps16(w)
    w = w.cpu().numpy().astype(np.int64)
    w = w.reshape(-1, *w.shape[-2:])                      # [P, K, C]
    P = w.shape[0]
    v0 = block_origins(step)
    k = int(np.flatnonzero(v0 >= H)[0])
    col = int(np.abs(w[k % P]).sum(axis=0).argmax())
    return v0[k] - H, w[k % P, :, col]


def wrap_input(step, x: np.ndarray, lanes) -> int:
    """Write ``32767 * sign(w)`` over the window of the first output that
    lies wholly in the chunk, for its weight column with the largest
    sum |w|, into ``x[:, lanes]`` (int16 [chunk_rows, B], in place).  That
    output's exact accumulator is sum |w| * 32767, returned: over 2^31 at
    the real fixed configs, so the int32 sum wraps."""
    row0, taps = _wrap_window(step)
    return wrap_column(taps, x, lanes, row0)


def wrap_column(taps: np.ndarray, x: np.ndarray, lanes, row0: int = 0) -> int:
    """Write ``32767 * sign(taps)`` over rows ``row0 ..`` of ``x[:, lanes]``
    (int16, in place): the window of one weight column.  Returns its exact
    accumulator sum |taps| * 32767, past 2^31 (so the int32 sum wraps) for
    the real fixed filters and the tensor-core probes' random planes."""
    rows = row0 + np.arange(taps.shape[0])
    x[rows[:, None], np.asarray(lanes)[None, :]] = \
        (32767 * np.sign(taps)).astype(np.int16)[:, None]
    return int(np.abs(taps).sum()) * 32767
