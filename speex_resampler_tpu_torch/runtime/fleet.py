"""FleetResampler — the serving front end for many concurrent streams.

Combines the native host runtime (ragged per-stream staging,
``runtime/native.py``) with the lockstep batched device step
(``parallel/batch.py``): callers push bytes or frames per stream at their
own cadence; whenever every active stream has a full launch quantum
staged, ``poll()`` runs device launches and banks per-stream output PCM
for ``pull()``.  The port of the JAX package's ``runtime/fleet.py``, with
the same checkpoint format, so a fleet's state crosses between the two.

On CUDA the launch pipeline is:

- the stager gathers each launch into a lane-major pinned slab
  ``[B, chunk_rows]`` (contiguous per stream; ``pipeline_depth + 1`` slabs,
  each with a device twin whose zero tail is set once);
- the slab is uploaded on an upload stream, the step (with both transposes
  on the device, ``make_batched_step(lane_major=True)``) runs on the
  current stream, and its result is read back into a pinned
  ``[B, out_rows]`` buffer on a readback stream, the streams ordered by
  events;
- up to ``pipeline_depth`` launches are in flight before the oldest result
  is waited for, unpacked and banked.
"""

from __future__ import annotations

import collections
import math

import numpy as np
import torch

from ..ops import filter_design as fd
from ..ops import phase as ph
from ..parallel.batch import (_Slab, _adapt_hist, _launch_geometry,
                              _serving_device, make_batched_step)
from ..utils.degrade import ZeroFillDegradation
from ..utils.errors import ResamplerError, ResamplerErrorCode
from ..utils.host import Readback, to_host_into
from ..utils.profiling import LaunchStats, span
from .native import NativeStager, make_stager

__all__ = ["FleetResampler"]


class FleetResampler(ZeroFillDegradation):
    """S homogeneous streams (same rates/quality), independent cadence."""

    def __init__(self, n_streams: int, channels: int, in_rate: int,
                 out_rate: int, quality: int = 7, *,
                 target_chunk_frames: int = 4096,
                 device="cuda",
                 fixed_point: bool = False,
                 max_latency_ms: float | None = None,
                 max_staged_frames: int | None = None,
                 max_banked_frames: int | None = None,
                 pipeline_depth: int = 2,
                 device_consumer=None):
        """``device``: "cuda" (the kernels; raises without a CUDA device,
        and a kernel build failure raises here) or "cpu" (their plain
        versions).

        ``max_staged_frames`` / ``max_banked_frames`` are per-stream
        high-watermarks bounding host memory.  A push that would exceed
        the staging watermark raises ALLOC_FAILED (callers poll
        ``writable()`` to pause the producer instead); ``poll()`` stops
        launching while any active stream's banked output exceeds the
        banked watermark, so a consumer that never pulls stalls the
        pipeline instead of growing it.  ``None`` (default) = unbounded.

        ``pipeline_depth`` = launches kept in flight before the oldest
        result is read back.  Depth 2 (default) overlaps the device's
        upload, compute and readback with the next launch's host gather;
        depth 1 is dispatch-then-drain.

        ``device_consumer``: a callable on the launch's device output
        ``y i16[B, out_rows]`` (lane-major), run on the current stream
        after the step.  Only its result is read back, appended per launch
        to ``self.consumed`` as a NumPy array; ``pull()`` then yields
        nothing (the audio feeds a downstream device pipeline instead of
        returning to the host)."""
        if n_streams <= 0 or channels <= 0 or in_rate <= 0 or out_rate <= 0:
            raise ResamplerError(ResamplerErrorCode.INVALID_ARG)
        if (max_staged_frames is not None and max_staged_frames <= 0) or \
                (max_banked_frames is not None and max_banked_frames <= 0):
            raise ResamplerError(ResamplerErrorCode.INVALID_ARG)
        self.device = _serving_device(device)
        self.n_streams = n_streams
        self.channels = channels
        self.in_rate = in_rate
        self.out_rate = out_rate
        self.fixed_point = bool(fixed_point)
        self.B = n_streams * channels
        self._active = [True] * n_streams
        g = math.gcd(in_rate, out_rate)
        try:
            with span("speex.setup.design"):
                self.spec = fd.design_filter(in_rate // g, out_rate // g,
                                             quality,
                                             fixed_point=fixed_point)
        except fd.OverflowArgError:
            # C's init fails its INT_MAX guards with RESAMPLER_ERR_OVERFLOW
            # (resample.c:643-656)
            raise ResamplerError(ResamplerErrorCode.OVERFLOW)
        max_in = (None if max_latency_ms is None
                  else int(max_latency_ms * in_rate / 1000))
        self.bspec = _launch_geometry(self.spec, target_chunk_frames,
                                      max_in_frames=max_in)
        if max_staged_frames is not None \
                and max_staged_frames < self.bspec.in_per_launch:
            # a staging watermark below the launch quantum means lockstep
            # readiness can never be reached: a config error
            raise ResamplerError(ResamplerErrorCode.INVALID_ARG)
        self.max_staged_frames = max_staged_frames
        self.max_banked_frames = max_banked_frames
        self._banked = [0] * n_streams  # banked output frames per stream
        self._step = make_batched_step(self.spec, self.bspec,
                                       device=self.device, lane_major=True)
        self._w = self._step.w
        self._consumer = device_consumer
        self.consumed: list = []  # per-launch device_consumer results
        self._hist = torch.zeros((self._step.hist_rows, self.B),
                                 dtype=torch.int16, device=self.device)
        self._new_stager()
        # depth+1 persistent lane-major slabs: slab i is refilled only
        # after launch i's result was read back, depth dispatches later.
        # Columns [in_per_launch, chunk_rows) are the step's zero tail,
        # zeroed once here and never written by the lane-major fill.
        self._depth = max(1, int(pipeline_depth))
        self._slabs = [_Slab((self.B, self._step.chunk_rows), self.device)
                       for _ in range(self._depth + 1)]
        self._slab_i = 0
        if self.device.type == "cuda":
            self._upload_stream = torch.cuda.Stream(self.device)
            self._readback_stream = torch.cuda.Stream(self.device)
            # one pinned readback buffer per slab (pipeline slot)
            self._readback_bufs = [
                torch.empty((self.B, self.bspec.out_per_launch),
                            dtype=torch.int16, pin_memory=True)
                for _ in self._slabs]
        else:
            self._upload_stream = self._readback_stream = None
        self._out: list[list[np.ndarray]] = [[] for _ in range(n_streams)]
        self.stats = LaunchStats()
        # zero-fill degradation (resample.c:561-591, :785-791 analog): a
        # device failure swaps poll() onto a host zero-output dispatch
        # with exact sample accounting.  Sticky, like the C fn-ptr swap.
        self._degraded = False
        self._flushed = False  # flush() is terminal; see its docstring

    def _new_stager(self) -> None:
        self._stager = make_stager(self.n_streams, self.channels,
                                   self.bspec.in_per_launch)
        #: "native" (the C++ stager) or "numpy" (PyStager, the fallback
        #: when the library cannot be built)
        self.stager_kind = ("native" if isinstance(self._stager,
                                                   NativeStager)
                            else "numpy")

    # -- ingress ----------------------------------------------------------

    def push(self, stream: int, frames: np.ndarray) -> None:
        """frames: int16 [n, C] interleaved for one stream.

        Raises ALLOC_FAILED when accepting would cross the per-stream
        ``max_staged_frames`` watermark (backpressure; check
        ``writable()`` first to pause the producer instead)."""
        if self._flushed:
            # lane histories hold flush padding; resampling new audio
            # against them would be silently wrong
            raise ResamplerError(ResamplerErrorCode.INVALID_ARG)
        self._check_watermark(stream, np.asarray(frames).shape[0])
        self._stager.push(stream, frames)

    def push_bytes(self, stream: int, data: bytes) -> int:
        """Raw s16 PCM bytes; partial frames carry over (Transform-stream
        alignment semantics).  Watermark semantics as in ``push`` (the
        check counts whole frames the bytes complete, including the
        pending alignment carry)."""
        if self._flushed:
            raise ResamplerError(ResamplerErrorCode.INVALID_ARG)
        if self.max_staged_frames is not None:
            fb = self.channels * 2
            n = (self._stager.carry_size(stream) + len(data)) // fb
            self._check_watermark(stream, n)
        return self._stager.push_bytes(stream, data)

    def _check_watermark(self, stream: int, n_frames: int) -> None:
        if self.max_staged_frames is None:
            return
        if self._stager.staged_one(stream) + n_frames \
                > self.max_staged_frames:
            raise ResamplerError(ResamplerErrorCode.ALLOC_FAILED)

    def writable(self, stream: int, frames: int = 1) -> bool:
        """Transform-stream pause signal: True iff a push of ``frames``
        whole frames is guaranteed to be accepted (staged + frames stays
        within the watermark).  Always True when unbounded."""
        if self._flushed:
            return False  # push() always raises after terminal flush()
        if self.max_staged_frames is None:
            return True
        return (self._stager.staged_one(stream) + frames
                <= self.max_staged_frames)

    def staged(self) -> np.ndarray:
        return self._stager.staged()

    # -- execution --------------------------------------------------------

    def poll(self, max_launches: int | None = None) -> int:
        """Run up to ``max_launches`` ready device launches; returns count.

        Up to ``pipeline_depth`` launches are dispatched before the oldest
        result is read back, so the device's copies and compute overlap
        the next launch's host gather (dispatch only queues work; _recv
        blocks).  Every phase's host wall-clock is attributed in
        ``self.stats`` (gather / dispatch / readback / unpack).

        With ``max_banked_frames`` set, launching PAUSES while any active
        stream's banked output sits at/over the watermark."""
        n = self._stager.ready_launches()
        if max_launches is not None:
            n = min(n, max_launches)
        pending: collections.deque = collections.deque()
        ran = 0
        for _ in range(n):
            if self._output_paused():
                break
            i, slab = self._next_slab()
            with self.stats.phase("gather"):
                self._stager.fill_launch_lm(slab.host)
            pending.append(self._dispatch(i, slab))
            ran += 1
            if len(pending) >= self._depth:
                self._drain_one(pending)
        while pending:
            self._drain_one(pending)
        return ran

    def _next_slab(self) -> tuple:
        i = self._slab_i
        self._slab_i = (i + 1) % len(self._slabs)
        slab = self._slabs[i]
        slab.fill()
        return i, slab

    def _drain_one(self, pending) -> None:
        with self.stats.phase("readback"):
            y = self._recv(pending.popleft())
        if self._consumer is not None:
            # device-resident egress: y IS the consumer's result
            self.consumed.append(y)
            return
        with self.stats.phase("unpack"):
            self._bank(y, None)

    def _output_paused(self) -> bool:
        if self.max_banked_frames is None:
            return False
        return any(b >= self.max_banked_frames
                   for b, a in zip(self._banked, self._active) if a)

    def flush(self) -> None:
        """END-OF-STREAM drain: process ALL staged frames (zero-padding
        each stream's final partial quantum) and bank only the outputs
        whose windows start within real input.

        Terminal: the padding zeros advance lane filter histories, and
        streams whose staged counts differ leave lanes phase-divergent;
        further ``push`` raises.  For exact continuation use
        ``BatchedResampler.flush`` (lockstep streams)."""
        self.poll()
        # fill_flush caps each stream at one quantum per call; loop so a
        # stream with >1 quantum staged (lockstep readiness gated by an
        # emptier stream) drains completely.  Outputs keep composing: the
        # quantum consumes a multiple of num inputs.
        while True:
            chunk, staged = self._stager.fill_flush()
            if chunk is None:
                break
            y = self._recv(self._dispatch_chunk(chunk))
            if self._consumer is not None:
                # the final partial quantum is consumed on the device too
                self.consumed.append(y)
                continue
            per_stream = [ph.producible_outputs(int(f), 0, self.bspec.f0,
                                                self.spec.num, self.spec.den)
                          for f in staged]
            self._bank(y, per_stream)
        self._flushed = True

    # -- zero-fill degradation: shared machinery in utils/degrade.py ------

    def _degraded_dispatch(self, slab: np.ndarray):
        """Zero-output launch: consume q rows, emit n_out zero rows,
        advance history identically to the healthy step."""
        self._hist = self._advance_degraded_hist(slab)
        return self._zero_result()

    def _dispatch(self, i: int, slab: _Slab):
        """Queue one launch on a filled lane-major slab (slot ``i``)."""
        with self.stats.launch(self.bspec.in_per_launch * self.B,
                               self.bspec.out_per_launch * self.B), \
                self.stats.phase("dispatch"):
            if self._degraded:
                return self._degraded_dispatch(slab.host)
            try:
                x = slab.upload(self._upload_stream)
                hist, y = self._step.fn(self._hist, x, self._w)
                slab.release()
                if self._consumer is not None:
                    y = self._consumer(y)
                result = self._readback(i, y)
                self._hist = hist
                return result
            except Exception as exc:
                self._enter_degraded(exc)
                return self._degraded_dispatch(slab.host)

    def _readback(self, i: int, y: torch.Tensor):
        """CUDA: queue the copy of ``y`` into slot ``i``'s pinned buffer
        (a consumer's result: a pinned buffer of its own) on the readback
        stream; CPU: ``y`` itself."""
        if self._readback_stream is None:
            return y
        out = (self._readback_bufs[i] if self._consumer is None
               else torch.empty(y.shape, dtype=y.dtype, pin_memory=True))
        return Readback(to_host_into(y, out, self._readback_stream),
                        out.numpy())

    def _dispatch_chunk(self, chunk: np.ndarray):
        """Dispatch from a bare time-major [n_in, B] chunk (the flush
        slab, a terminal one-shot path, so the host transpose into the
        lane-major slab is paid once per stream lifetime)."""
        q = self.bspec.in_per_launch
        i, slab = self._next_slab()
        slab.host[:, :q] = chunk.T
        return self._dispatch(i, slab)

    # -- lane-major degradation overrides (base class is time-major) -------

    def _result_shape(self) -> tuple:
        return (self.B, self.bspec.out_per_launch)

    def _advance_degraded_hist(self, slab: np.ndarray) -> np.ndarray:
        q = self.bspec.in_per_launch
        H = self._step.hist_rows
        return np.concatenate([self._hist, np.asarray(slab[:, :q]).T],
                              axis=0)[-H:]

    def _bank(self, y: np.ndarray, per_stream) -> None:
        outs = self._stager.unpack_all_lm(y)  # [S, n_out, C]
        for s in range(self.n_streams):
            if not self._active[s]:
                # inactive lanes are zero-filled in slabs but their stale
                # history still convolves to nonzero rows: never bank them
                continue
            o = outs[s]
            if per_stream is not None:
                o = o[:per_stream[s]]
            if o.shape[0]:
                self._out[s].append(o)
                self._banked[s] += o.shape[0]

    # -- slot management (dynamic occupancy) -------------------------------

    def set_slot_active(self, slot: int, active: bool) -> None:
        """Inactive slots are excluded from lockstep readiness and
        zero-filled in launch slabs."""
        self._stager.set_active(slot, active)
        self._active[slot] = bool(active)

    def clear_slot(self, slot: int) -> None:
        """Reset one lane for reuse: zero filter history, drop banked
        output (staging is cleared by deactivation)."""
        c = self.channels
        lane = slot * c
        self._hist[:, lane:lane + c] = 0
        self._out[slot] = []
        self._banked[slot] = 0

    def seed_lane_history(self, slot: int, hist: np.ndarray) -> None:
        """Adopt filter memory for one lane (inverse of lane_history):
        hist [filt_len-1, C] becomes the lane's trailing history rows; the
        extra alignment rows in front are never read by the kernels."""
        c = self.channels
        N = self.spec.filt_len
        hist = np.asarray(hist, dtype=np.int16)
        if hist.shape != (N - 1, c):
            raise ResamplerError(ResamplerErrorCode.INVALID_ARG)
        H = self._step.hist_rows
        buf = np.zeros((H, c), dtype=np.int16)
        buf[H - (N - 1):] = hist
        lane = slot * c
        if self._degraded:
            self._hist[:, lane:lane + c] = buf
        else:
            self._hist[:, lane:lane + c] = torch.from_numpy(buf).to(
                self.device)

    def lane_history(self, slot: int) -> np.ndarray:
        """One lane's filter history, the trailing filt_len-1 rows of
        [hist_rows, C] (valid for hand-off at launch-quantum
        boundaries)."""
        c = self.channels
        h = self._hist_host()[:, slot * c:(slot + 1) * c]
        N = self.spec.filt_len
        return h[h.shape[0] - (N - 1):]

    def peek_staged(self, slot: int) -> np.ndarray:
        return self._stager.peek(slot)

    def lane_carry(self, slot: int) -> bytes:
        """One lane's byte-alignment carry (a pending partial frame from
        push_bytes): must be salvaged before deactivating the slot."""
        return self._stager.carry(slot)

    # -- checkpoint/resume ---------------------------------------------------

    def state_dict(self) -> dict:
        """Full serializable snapshot in the JAX package's format: filter
        history, per-stream staged input (and alignment-carry bytes),
        banked output."""
        return {
            "n_streams": self.n_streams, "channels": self.channels,
            "in_rate": self.in_rate, "out_rate": self.out_rate,
            "quality": self.spec.quality,
            "fixed_point": self.fixed_point,
            "active": list(self._active),
            "degraded": self._degraded,
            "flushed": self._flushed,
            "hist": self._hist_host(),
            "staged": [self._stager.peek(s) for s in range(self.n_streams)],
            "carry": [self._stager.carry(s) for s in range(self.n_streams)],
            "banked": [[o.copy() for o in self._out[s]]
                       for s in range(self.n_streams)],
        }

    def load_state_dict(self, state: dict):
        """Accepts this fleet's or the JAX package fleet's
        ``state_dict()``."""
        if (state["n_streams"], state["channels"]) != (self.n_streams,
                                                       self.channels) or \
                (state["in_rate"], state["out_rate"], state["quality"]) != \
                (self.in_rate, self.out_rate, self.spec.quality) or \
                state.get("fixed_point", False) != self.fixed_point:
            raise ResamplerError(ResamplerErrorCode.INVALID_ARG)
        if state.get("degraded", False):
            self._adopt_degraded()
        self._flushed = bool(state.get("flushed", False))
        hist_np = _adapt_hist(state["hist"], self._step.hist_rows,
                              self.spec.filt_len, self.B)
        # sticky: a healthy checkpoint loaded into a degraded engine keeps
        # the host history (the device may be dead)
        self._hist = (hist_np if self._degraded
                      else torch.from_numpy(hist_np).to(self.device))
        self._new_stager()
        # restore occupancy before staging (deactivation clears staging)
        for s, a in enumerate(state["active"]):
            self.set_slot_active(s, bool(a))
        for s in range(self.n_streams):
            if len(state["staged"][s]):
                self._stager.push(s, state["staged"][s])
            if state["carry"][s]:
                self._stager.push_bytes(s, state["carry"][s])
        self._out = [[np.array(o) for o in outs]
                     for outs in state["banked"]]
        self._banked = [sum(o.shape[0] for o in outs)
                        for outs in self._out]

    def close(self) -> None:
        """Release the fleet's device history, slabs (pinned and device
        twins), pinned readback buffers and stager now, not when the
        garbage collector finds the fleet (MultiFleet closes the fleet of
        an evicted bucket).  The step's weights stay in the step cache that
        engines of one config share.  A closed fleet is not used again."""
        self._slabs = []
        self._readback_bufs = []
        self._hist = None
        self._stager = None
        self._step = self._w = None
        self._upload_stream = self._readback_stream = None

    # -- egress -----------------------------------------------------------

    @property
    def launch_latency_ms(self) -> float:
        """Availability latency of the lockstep quantum (audio a stream
        must stage before its next launch can run)."""
        return self.bspec.in_per_launch / self.in_rate * 1000.0

    def pending(self, stream: int) -> int:
        return sum(o.shape[0] for o in self._out[stream])

    def pull(self, stream: int) -> np.ndarray:
        """Drain banked output for one stream: int16 [n, C]."""
        outs = self._out[stream]
        self._out[stream] = []
        self._banked[stream] = 0
        if not outs:
            return np.zeros((0, self.channels), dtype=np.int16)
        return np.concatenate(outs, axis=0)

    def pull_bytes(self, stream: int) -> bytes:
        return self.pull(stream).astype("<i2").tobytes()
