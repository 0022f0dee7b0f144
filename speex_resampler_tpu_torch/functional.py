"""The pure step: the resampler as one stage of the caller's own torch
graph.

The stateful engines (``BatchedResampler``/``FleetResampler``) own
staging, accounting and degradation; this module gives the step under
them to users who want resampling inside their own device pipeline (an
audio data loader, a feature extractor, a model front end), as the JAX
package's ``functional.py`` does for ``jax.jit``.  Here the counterpart of
"jittable inside an outer jit" is "capturable in one CUDA graph": a call
makes no host synchronization, creates no tensor from host data and
allocates nothing whose size depends on the data, so a ``torch.cuda.graph``
around the step and the caller's own ops replays the whole stage as one
launch sequence (warm the step up once before capturing, as
``torch.cuda.graph`` asks of any code).

Semantics: ``step`` consumes EXACTLY ``in_frames`` input frames a call and
produces EXACTLY ``out_frames``.  The launch quantum is a multiple of the
reduced ratio's numerator, so the fractional phase returns to its start
after every call and one step with constant weights serves the stream
forever with static shapes.  Outputs equal the batched engine's on the
same frames (bit for bit: the same kernel launches), so they are within 1
LSB of the reference C core (bit-exact with ``fixed_point=True``); the
filter's leading delay is included, as with a fresh C state.

The step hands the caller's ``x`` to the kernel as it is, where it is
int16, contiguous and 16-byte aligned: the kernels read rows past its end
as zero, so no zero-tailed copy is made.  Any other ``x`` (another dtype,
a strided view, an unaligned start) is copied once into fresh memory, the
one call of the span ``speex.step.pad``.  The step never writes ``x``.

Example::

    import torch
    from speex_resampler_tpu_torch.functional import make_stream_fn

    rs = make_stream_fn(44100, 48000, quality=7)

    def pipeline(hist, pcm):              # pcm [rs.in_frames, B] int16
        hist, y = rs.step(hist, pcm)      # y   [rs.out_frames, B] int16
        rms = y.float().square().mean(0).sqrt()
        return hist, y, rms

    hist = rs.init(batch=16)
    # eager, or captured once in a torch.cuda.CUDAGraph on static
    # hist / pcm buffers and replayed a quantum at a time
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .ops import filter_design as fd
from .parallel.batch import (DEFAULT_DEVICE, BatchedResampler,
                             _launch_geometry, _placement, _serving_device,
                             make_batched_step)
from .parallel.mesh import shard_columns
from .utils.profiling import span

__all__ = ["StreamFn", "make_stream_fn", "resample_array"]


@dataclasses.dataclass(frozen=True)
class StreamFn:
    """A pure resampling step plus its shape contract.

    step(hist i16[hist_rows, B], x i16[in_frames, B])
        -> (hist' i16[hist_rows, B], y i16[out_frames, B])

    ``B`` is free: lanes = streams x channels, share-nothing, so any batch
    size works.  ``step`` launches on the current stream of the tensors'
    device and may be captured in a CUDA graph (module docstring).  Under
    a ``mesh`` hist, x and the results are lists, one tensor a lane shard
    (``parallel.mesh.split_lanes``), each [rows, B / len(mesh)] on its
    device.
    """
    step: object
    in_frames: int           # input frames consumed per call
    out_frames: int          # output frames produced per call
    hist_rows: int           # history rows carried between calls
    input_latency: int       # filter delay, input samples (filt_len/2)
    output_latency: int      # filter delay, output samples
    fixed_point: bool
    scheme: str              # resolved precision scheme
    device: torch.device | None   # None under a mesh
    mesh: tuple = ()         # the lane shards' devices

    def init(self, batch: int):
        """Fresh-stream history (zeros) for ``batch`` lanes: a tensor on
        ``device``, or under a mesh one a shard (``batch`` not divisible
        by the shard count raises INVALID_ARG)."""
        if not self.mesh:
            return torch.zeros((self.hist_rows, batch), dtype=torch.int16,
                               device=self.device)
        return [torch.zeros((self.hist_rows, hi - lo), dtype=torch.int16,
                            device=d)
                for (lo, hi), d in zip(shard_columns(batch, len(self.mesh)),
                                       self.mesh)]


def _launch_x(x: torch.Tensor, n_in: int) -> torch.Tensor:
    """``x`` as the kernel wrapper reads it: the caller's own tensor where
    it is int16, contiguous and 16-byte aligned, else one copy of it into
    fresh memory (the span ``speex.step.pad``).  Rows past its end read as
    zero (``BatchedStep``), so no zero tail is made."""
    if x.ndim != 2 or x.shape[0] != n_in:
        raise ValueError(f"step consumes exactly {n_in} frames/call, "
                         f"got {tuple(x.shape)}")
    if x.dtype == torch.int16 and x.is_contiguous() \
            and x.data_ptr() % 16 == 0:
        return x
    with span("speex.step.pad"):
        return torch.empty(x.shape, dtype=torch.int16,
                           device=x.device).copy_(x)


def make_stream_fn(in_rate: int, out_rate: int, quality: int = 7, *,
                   target_in_frames: int = 4096,
                   fixed_point: bool = False,
                   device=DEFAULT_DEVICE,
                   mesh=None,
                   scheme: str = "auto") -> StreamFn:
    """Build a pure step for one config.

    ``target_in_frames`` sizes the launch quantum (rounded to the
    geometry's unit); larger quanta amortize launch overhead, smaller ones
    cut availability latency: the engines' ``target_chunk_frames`` trade.
    The geometry and scheme are the JAX package's ``use_pallas=True``
    ones.  ``device``: "cuda" (the kernels; raises without a CUDA device)
    or "cpu" (their plain versions).  ``mesh``: a sequence of devices in
    place of ``device``, one lane shard each (``parallel/mesh.py``);
    passing both raises INVALID_ARG."""
    devices = _placement(device, mesh)
    for d in dict.fromkeys(devices):
        _serving_device(d)
    g = math.gcd(in_rate, out_rate)
    with span("speex.setup.design"):
        spec = fd.design_filter(in_rate // g, out_rate // g, quality,
                                fixed_point=fixed_point)
    bspec = _launch_geometry(spec, target_in_frames)
    if mesh is None:
        bstep = make_batched_step(spec, bspec, device=devices[0],
                                  scheme=scheme)
    else:
        bstep = make_batched_step(spec, bspec, mesh=devices, scheme=scheme)
    n_in = bspec.in_per_launch
    fn, w = bstep.fn, bstep.w

    if mesh is None:
        @span("speex.step")
        def step(hist, x):
            return fn(hist, _launch_x(x, n_in), w)
    else:
        @span("speex.step")
        def step(hist, x):
            return fn(hist, [_launch_x(s, n_in) for s in x], w)

    return StreamFn(
        step=step, in_frames=n_in, out_frames=bspec.out_per_launch,
        hist_rows=bstep.hist_rows,
        input_latency=spec.filt_len // 2,
        output_latency=((spec.filt_len // 2) * spec.den
                        + (spec.num >> 1)) // spec.num,
        fixed_point=fixed_point, scheme=bstep.scheme,
        device=devices[0] if mesh is None else None,
        mesh=devices if mesh is not None else ())


def resample_array(x: np.ndarray, in_rate: int, out_rate: int,
                   quality: int = 7, *, fixed_point: bool = False,
                   device=DEFAULT_DEVICE) -> np.ndarray:
    """One-shot host convenience: resample a whole finite signal.

    ``x``: int16, shape [n] (one mono stream), [n, C] (one stream), or
    [S, n, C] (a batch).  Returns every producible output frame including
    the flush tail, i.e. the stream processed to completion, like pushing
    the whole buffer through a ``BatchedResampler`` on ``device`` and
    flushing."""
    x = np.asarray(x, dtype=np.int16)
    squeeze = 0
    if x.ndim == 1:
        x, squeeze = x[None, :, None], 2
    elif x.ndim == 2:
        x, squeeze = x[None], 1
    elif x.ndim != 3:
        raise ValueError(f"expected [n], [n, C] or [S, n, C], got {x.shape}")
    S, n, C = x.shape
    eng = BatchedResampler(S, C, in_rate, out_rate, quality,
                           target_chunk_frames=min(max(n, 1), 1 << 16),
                           fixed_point=fixed_point, device=device)
    out = np.concatenate([eng.process(x), eng.flush()], axis=1)
    if squeeze == 2:
        return out[0, :, 0]
    return out[0] if squeeze else out
