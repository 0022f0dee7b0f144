"""Stateful Speex-compatible resampler core: one stream, the C API surface.

The port of the JAX package's ``core/resampler.py``, with the same state,
accounting and checkpoint format.  Replaces the reference's C state
machine (SpeexResamplerState_, resample.c:116-146, and the process pipeline
:878-1082) with:

  - host-mirrored integer phase state (last_sample / samp_frac_num /
    magic_samples per channel) that evolves deterministically from chunk
    sizes — no device→host scalar syncs ever;
  - a float32 history/pending buffer per channel, exactly the dtype of the
    reference's ``mem`` (float build): s16 input enters it losslessly
    (resample.c:1000-1006) and the float-sample API
    (speex_resampler_process_float) stores floats verbatim;
  - per-call execution of *all* producible outputs at once: on the host
    route through the order-faithful native loops (ops/fir_exact.py,
    ops/fir_fixed.py), on the device route as one phase-indexed strided
    matmul (ops/fir_matmul.py) — the reference's 160-sample overlap-save
    bites (buffer_size, resample.c:835, :988-1030) are a CPU cache
    artifact; output values are chunking-invariant.

Lifecycle parity: set_rate_frac with samp_frac_num rescaling
(resample.c:1107-1145), set_quality (:1153-1163), magic-sample state
migration across filter-length changes (:727-782), skip_zeros (:1200-1206),
reset_mem (:1208-1220), latency getters (:1190-1198).
"""

from __future__ import annotations

import logging
import math

import numpy as np
import torch

from ..ops import filter_design as fd
from ..ops import phase as ph
from ..ops import fir_matmul as fm
from ..parallel.batch import _serving_device
from ..utils.errors import ResamplerError, ResamplerErrorCode
from ..utils.host import to_host

__all__ = ["ResamplerCore", "HOST_AUTO_MAX_CHANNELS"]

_log = logging.getLogger(__name__)

# ``engine="auto"`` crossover: float-universe cores at or below this many
# channels serve through the native host hot loops (bit-identical to the
# reference); above it the device route's one matmul a call wins.
# Interactive per-stream use (the reference's primary pattern,
# src/index.ts:50-116) therefore never pays a per-call device round trip.
# The value is the JAX package's, so both packages route a core alike;
# chip_smoke.py phase 7 times both routes at 2-64 channels on the card.
# Batched serving at scale goes through FleetResampler, which is
# device-native regardless of this knob.
HOST_AUTO_MAX_CHANNELS = 8


def _device_route_gathers(spec) -> bool:
    """Whether the device route runs ``spec`` on the gather kernel: the
    matmul route's padded f32 weights, (filt_len + group * num) rows of
    group * den columns, would pass ``fm.MAX_PADDED_WEIGHT_BYTES``."""
    group = fm.choose_group(spec.num, spec.den, spec.filt_len)
    return ((spec.filt_len + group * spec.num) * group * spec.den * 4
            > fm.MAX_PADDED_WEIGHT_BYTES)


class _WeightCache:
    """Per-instance cache of device-resident padded weight matrices."""

    def __init__(self, device: torch.device):
        self.device = device
        self._cache: dict = {}

    def get(self, spec: fd.FilterSpec, f0: int, group: int):
        k = (id(spec), f0, group)
        w = self._cache.get(k)
        if w is None:
            w_np = ph.build_padded_weights(spec.phase_table, spec.num,
                                           spec.den, f0, group)
            # pad rows to a multiple of stride so the kernel's reshape-based
            # patch construction applies (zero rows are inert in the matmul)
            stride = group * spec.num
            L_pad = -(-w_np.shape[0] // stride) * stride
            if L_pad != w_np.shape[0]:
                w_np = np.pad(w_np, ((0, L_pad - w_np.shape[0]), (0, 0)))
            w = torch.from_numpy(w_np).to(self.device)
            self._cache[k] = w
        return w

    def clear(self):
        self._cache.clear()


class ResamplerCore:
    """One stream's resampler state. Mirrors speex_resampler_init_frac
    (resample.c:799-866) + the full runtime API."""

    def __init__(self, nb_channels: int, ratio_num: int, ratio_den: int,
                 in_rate: int, out_rate: int, quality: int,
                 fixed_point: bool = False,
                 full_sinc_table: bool = False,
                 exact: bool = False,
                 engine: str = "auto",
                 device="cuda"):
        """``fixed_point=True`` selects the reference's OTHER numeric
        universe (-DFIXED_POINT, arch.h:39-67): spx_word16_t = int16, Q15
        integer hot loops, int16 ``mem``.  Outputs are bit-exact vs the
        fixed-build oracle (wrapping int32 sums are order-independent, see
        ops/fir_fixed.py).

        ``exact=True`` (float universe) serves through the order-faithful
        host hot loops (ops/fir_exact.resample_exact_state): outputs are
        BIT-IDENTICAL to the reference float build instead of <=1 LSB —
        at host speed (native C++ twins, runtime/native.py).  The fixed
        universe is exact everywhere already, so combining the flags is
        redundant (and rejected).

        ``engine`` places the FLOAT hot loops: ``"host"`` = the native
        order-faithful loops (same outputs as ``exact=True``),
        ``"device"`` = one f32 matmul a call (<=1 LSB), ``"auto"`` (default)
        = host at or below HOST_AUTO_MAX_CHANNELS channels, device above —
        so interactive single-stream use never pays a per-chunk device
        round trip while wide cores get the matmul's throughput.  A
        placement knob, not a state universe: checkpoints restore across
        engines (values may differ <=1 LSB after a host<->device move, like
        any reassociation).  The fixed universe ignores it: its loops run
        on the host (exact by construction).  ``exact=True`` with
        ``engine="device"`` is contradictory and rejected.

        The host route and the fixed universe run the native C++ loops
        (NumPy where the runtime cannot be built) on the host in both
        packages: that is the design, not a fallback.  ``device`` says
        where the DEVICE route runs: "cuda" (default; a core that takes
        the device route raises here without a CUDA device) or "cpu".  A
        device fault in a launch degrades the core to zero output with
        exact accounting (``degraded``, ``degraded_cause``, a logged
        warning), the reference's resampler_basic_zero swap."""
        if (nb_channels <= 0 or ratio_num <= 0 or ratio_den <= 0
                or quality > 10 or quality < 0):
            raise ResamplerError(ResamplerErrorCode.INVALID_ARG)
        if engine not in ("auto", "host", "device"):
            raise ResamplerError(ResamplerErrorCode.INVALID_ARG)
        self.fixed_point = bool(fixed_point)
        self.exact = bool(exact)
        self.engine = engine
        if self.exact and (self.fixed_point or engine == "device"):
            raise ResamplerError(ResamplerErrorCode.INVALID_ARG)
        self._host_route = (not self.fixed_point
                            and (self.exact or engine == "host"
                                 or (engine == "auto"
                                     and nb_channels
                                     <= HOST_AUTO_MAX_CHANNELS)))
        # the device route's gather launches a kernel: a CUDA core builds
        # the library here, so a build failure raises from the constructor
        self.device = (torch.device(device)
                       if self.fixed_point or self._host_route
                       else _serving_device(device))
        # RESAMPLE_FULL_SINC_TABLE compile-flag analog (resample.c:641-644)
        self.full_sinc_table = bool(full_sinc_table)
        self._mem_dtype = np.int16 if fixed_point else np.float32
        self.nb_channels = int(nb_channels)
        self.in_rate = 0
        self.out_rate = 0
        self.num = 0
        self.den = 0
        self.quality = -1
        self.started = False
        self._spec: fd.FilterSpec | None = None
        self._weights = _WeightCache(self.device)

        C = self.nb_channels
        self.last_sample = np.zeros(C, dtype=np.int64)
        self.samp_frac_num = np.zeros(C, dtype=np.int64)
        self.magic_samples = np.zeros(C, dtype=np.int64)
        # mem[c] = history (filt_len-1 samples) ++ pending magic samples
        # (dtype = spx_word16_t: f32 float build, int16 fixed build)
        self._history = [np.zeros(0, dtype=self._mem_dtype) for _ in range(C)]
        self._pending = [np.zeros(0, dtype=self._mem_dtype) for _ in range(C)]

        self.in_stride = 1   # resample.c:1170-1178
        self.out_stride = 1  # resample.c:1180-1188
        # C's mem allocation high-water mark: filt_len-1 + buffer_size(160),
        # grow-only (resample.c:709-720).  The process loops' input bite is
        # xlen = mem_alloc_size - (filt_len-1), so after a filter shrink the
        # bite EXCEEDS 160 — observable in consumed-input accounting when
        # the caller's output capacity binds.
        self._mem_alloc_size = 0
        # (magic/fresh out+consumed) of the most recent process call —
        # introspection for the consumed-accounting differential tests
        self.last_accounting = None
        # resample.c:561-591/:785-791 parity: after a device/allocation
        # failure the resampler degrades to emitting zeros while advancing
        # state identically, so callers ignoring errors cannot deadlock.
        self.degraded = False
        self.degraded_cause: BaseException | None = None
        self.set_quality(quality)
        self.set_rate_frac(ratio_num, ratio_den, in_rate, out_rate)
        self._update_filter()
        self.initialised = True

    # ------------------------------------------------------------------
    # Filter (re)design + state migration — update_filter equivalent.
    # ------------------------------------------------------------------

    def _update_filter(self):
        old_spec = self._spec
        try:
            spec = fd.design_filter(self.num, self.den, self.quality,
                                    fixed_point=self.fixed_point,
                                    full_sinc_table=self.full_sinc_table)
        except fd.OverflowArgError:
            raise ResamplerError(ResamplerErrorCode.OVERFLOW)
        self._spec = spec
        self._weights.clear()
        N = spec.filt_len
        # st->buffer_size = 160 (resample.c:835); alloc never shrinks
        self._mem_alloc_size = max(self._mem_alloc_size, N - 1 + 160)

        if not self.started or old_spec is None:
            for c in range(self.nb_channels):
                self._history[c] = np.zeros(N - 1, dtype=self._mem_dtype)
                self._pending[c] = np.zeros(0, dtype=self._mem_dtype)
                self.magic_samples[c] = 0
            return

        old_N = old_spec.filt_len
        if N == old_N:
            return
        # Replicate resample.c:727-782 in history+pending terms.  The C
        # ``mem`` at rest is [history(old_N-1) | pending(magic)].
        for c in range(self.nb_channels):
            hist = self._history[c]
            pend = self._pending[c]
            if N > old_N:
                # resample.c:727-765 — unpack magic as if already consumed,
                # then either zero-pad the front (still growing) or re-stash.
                olen = old_N + 2 * len(pend)
                # C shifts pending right by magic and zero-fills, giving a
                # buffer of olen-1 samples = [zeros(magic) | hist | pend]
                data = np.concatenate(
                    [np.zeros(len(pend), dtype=self._mem_dtype), hist, pend])
                self.magic_samples[c] = 0
                if N > olen:
                    # zero-pad front to N-1 history, bump last_sample
                    pad = np.zeros((N - 1) - (olen - 1),
                                   dtype=self._mem_dtype)
                    self._history[c] = np.concatenate([pad, data])
                    self._pending[c] = np.zeros(0, dtype=self._mem_dtype)
                    self.last_sample[c] += (N - olen) // 2
                else:
                    # still shrinking vs augmented length: stash magic
                    magic = (olen - N) // 2
                    self._history[c] = data[magic:magic + N - 1]
                    self._pending[c] = data[magic + N - 1:]
                    self.magic_samples[c] = len(self._pending[c])
            else:
                # resample.c:766-782 — shrink: first (old_N-N)/2 samples of
                # the old history become pending "magic" input, appended
                # before any existing pending samples... C shifts left by
                # magic over [0, N-1+magic+old_magic), i.e. the new layout is
                # [hist', pend'] = old[magic : ...], preserving order.
                magic = (old_N - N) // 2
                data = np.concatenate([hist, pend])
                data = data[magic:]
                self._history[c] = data[:N - 1]
                self._pending[c] = data[N - 1:]
                self.magic_samples[c] = len(self._pending[c])

    # ------------------------------------------------------------------
    # Rate / quality / reset APIs.
    # ------------------------------------------------------------------

    def set_rate(self, in_rate: int, out_rate: int):
        self.set_rate_frac(in_rate, out_rate, in_rate, out_rate)

    def set_rate_frac(self, ratio_num: int, ratio_den: int, in_rate: int,
                      out_rate: int):
        """resample.c:1107-1145."""
        if ratio_num <= 0 or ratio_den <= 0:
            raise ResamplerError(ResamplerErrorCode.INVALID_ARG)
        if (self.in_rate == in_rate and self.out_rate == out_rate
                and self.num == ratio_num and self.den == ratio_den):
            return
        old_den = self.den
        self.in_rate = in_rate
        self.out_rate = out_rate
        g = math.gcd(ratio_num, ratio_den)
        self.num = ratio_num // g
        self.den = ratio_den // g
        if old_den > 0:
            for c in range(self.nb_channels):
                try:
                    v = fd.multiply_frac(int(self.samp_frac_num[c]),
                                         self.den, old_den)
                except fd.OverflowArgError:
                    raise ResamplerError(ResamplerErrorCode.OVERFLOW)
                self.samp_frac_num[c] = min(v, self.den - 1)  # safety net
        if getattr(self, "initialised", False):
            self._update_filter()

    def set_quality(self, quality: int):
        """resample.c:1153-1163."""
        if quality > 10 or quality < 0:
            raise ResamplerError(ResamplerErrorCode.INVALID_ARG)
        if self.quality == quality:
            return
        self.quality = quality
        if getattr(self, "initialised", False):
            self._update_filter()

    def get_rate(self) -> tuple[int, int]:
        return self.in_rate, self.out_rate

    def set_input_stride(self, stride: int):
        """speex_resampler_set_input_stride (resample.c:1170-1173)."""
        if stride <= 0:
            raise ResamplerError(ResamplerErrorCode.INVALID_ARG)
        self.in_stride = int(stride)

    def get_input_stride(self) -> int:
        return self.in_stride

    def set_output_stride(self, stride: int):
        """speex_resampler_set_output_stride (resample.c:1180-1183)."""
        if stride <= 0:
            raise ResamplerError(ResamplerErrorCode.INVALID_ARG)
        self.out_stride = int(stride)

    def get_output_stride(self) -> int:
        return self.out_stride

    def destroy(self):
        """speex_resampler_destroy (resample.c:868-876): release buffers;
        further use is an error (mirrors C use-after-free being invalid)."""
        self._history = None
        self._pending = None
        self._weights.clear()
        self._spec = None
        self.initialised = False

    def get_ratio(self) -> tuple[int, int]:
        return self.num, self.den

    @property
    def filt_len(self) -> int:
        return self._spec.filt_len

    def input_latency(self) -> int:
        return self._spec.input_latency

    def output_latency(self) -> int:
        return self._spec.output_latency

    def skip_zeros(self):
        """resample.c:1200-1206."""
        self.last_sample[:] = self._spec.filt_len // 2

    def reset_mem(self):
        """resample.c:1208-1220."""
        self.last_sample[:] = 0
        self.samp_frac_num[:] = 0
        self.magic_samples[:] = 0
        N = self._spec.filt_len
        for c in range(self.nb_channels):
            self._history[c] = np.zeros(N - 1, dtype=self._mem_dtype)
            self._pending[c] = np.zeros(0, dtype=self._mem_dtype)

    def import_history(self, history: np.ndarray):
        """Adopt filter memory from an external engine (e.g. one lane of a
        batched/fleet engine at a launch-quantum boundary, where
        last_sample = samp_frac_num = 0 by construction).

        history: [filt_len-1, C] samples (int16 values or f32 scale).
        """
        N = self._spec.filt_len
        history = np.asarray(history, dtype=self._mem_dtype)
        if history.shape != (N - 1, self.nb_channels):
            raise ResamplerError(ResamplerErrorCode.INVALID_ARG)
        self.started = True
        self.last_sample[:] = 0
        self.samp_frac_num[:] = 0
        self.magic_samples[:] = 0
        for c in range(self.nb_channels):
            self._history[c] = np.ascontiguousarray(history[:, c])
            self._pending[c] = np.zeros(0, dtype=self._mem_dtype)

    # ------------------------------------------------------------------
    # Checkpoint / resume.  The streaming state IS a checkpoint (SURVEY.md
    # §5): per channel mem history, last_sample, samp_frac_num, pending
    # magic samples (SpeexResamplerState_, resample.c:134-139).
    # ------------------------------------------------------------------

    def state_dict(self) -> dict:
        """Serializable snapshot; restore with load_state_dict."""
        return {
            "nb_channels": self.nb_channels,
            "fixed_point": self.fixed_point,
            "exact": self.exact,
            "engine": self.engine,  # placement knob: NOT a restore gate
            "full_sinc_table": self.full_sinc_table,
            "in_rate": self.in_rate, "out_rate": self.out_rate,
            "num": self.num, "den": self.den, "quality": self.quality,
            "started": self.started,
            "mem_alloc_size": self._mem_alloc_size,
            "in_stride": self.in_stride, "out_stride": self.out_stride,
            "last_sample": self.last_sample.copy(),
            "samp_frac_num": self.samp_frac_num.copy(),
            "magic_samples": self.magic_samples.copy(),
            "history": [h.copy() for h in self._history],
            "pending": [p.copy() for p in self._pending],
        }

    def load_state_dict(self, state: dict):
        """Restore a snapshot taken by state_dict on a compatible core."""
        if (state["nb_channels"] != self.nb_channels
                or state.get("fixed_point", False) != self.fixed_point
                or state.get("exact", self.exact) != self.exact
                or state.get("full_sinc_table",
                             self.full_sinc_table) != self.full_sinc_table):
            raise ResamplerError(ResamplerErrorCode.INVALID_ARG)
        self.set_quality(int(state["quality"]))
        self.set_rate_frac(int(state["num"]), int(state["den"]),
                           int(state["in_rate"]), int(state["out_rate"]))
        self.started = bool(state["started"])
        # Restore the donor's high-water mark EXACTLY: xlen (the process
        # loops' input bite) is mem_alloc_size - (filt_len-1), so keeping a
        # larger local value would desync capacity-bound consumed-input
        # accounting from the snapshotted stream.  (The saved value is >=
        # this config's requirement by construction; snapshots predating
        # the key fall back to this core's own mark.)
        self._mem_alloc_size = int(state.get("mem_alloc_size",
                                             self._mem_alloc_size))
        self.in_stride = int(state["in_stride"])
        self.out_stride = int(state["out_stride"])
        self.last_sample[:] = state["last_sample"]
        self.samp_frac_num[:] = state["samp_frac_num"]
        self.magic_samples[:] = state["magic_samples"]
        self._history = [np.array(h, dtype=self._mem_dtype)
                         for h in state["history"]]
        self._pending = [np.array(p, dtype=self._mem_dtype)
                         for p in state["pending"]]

    # ------------------------------------------------------------------
    # Processing.
    # ------------------------------------------------------------------

    def _channels_in_lockstep(self) -> bool:
        return (np.all(self.last_sample == self.last_sample[0])
                and np.all(self.samp_frac_num == self.samp_frac_num[0])
                and np.all(self.magic_samples == self.magic_samples[0]))

    def process_interleaved(self, frames: np.ndarray,
                            out_capacity: int) -> np.ndarray:
        """frames: int16 [n_frames, C] → int16 [n_out, C].

        Equivalent to speex_resampler_process_interleaved_int
        (resample.c:1061-1082): every channel gets the same input/output
        budget.  Unconsumed input (when out_capacity binds) is NOT retained
        — mirroring the JS wrapper which drops it (src/index.ts ignores the
        returned in_len).  Channels in lockstep (the only state reachable
        through this API) are batched into one device launch.
        """
        frames = np.ascontiguousarray(frames, dtype=np.int16)
        return self._process_interleaved_any(frames, out_capacity,
                                             out_float=False)

    def process_interleaved_float(self, frames: np.ndarray,
                                  out_capacity: int) -> np.ndarray:
        """speex_resampler_process_interleaved_float (resample.c:1037-1059):
        float samples on the ±32768 scale in and out, no WORD2INT."""
        frames = np.ascontiguousarray(frames, dtype=np.float32)
        return self._process_interleaved_any(frames, out_capacity,
                                             out_float=True)

    def process_native_interleaved(self, frames: np.ndarray,
                                   out_capacity: int) -> np.ndarray:
        """Drive the engine through ONE magic drain + ONE native call —
        the speex_resampler_magic / process_native layer itself
        (resample.c:904-922, :878-902) — bypassing the public entry
        points' bite/ystack quantization (:929-1035).

        Not a reference entry point.  The staging entry (the float
        build's process_int) runs everything inside ``while (ilen &&
        olen)`` and therefore cannot drain pending magic samples when no
        fresh input is offered; consumption is also bite-quantized when
        the output capacity binds.  The MultiFleet rate-switch transition
        needs neither quirk — it requires the closed-form native
        consumption ``consumed = min(ls_after, n_in)`` so its retained-
        input bookkeeping composes — so it talks to the native layer
        directly.  Output VALUES are identical to the per-bite walk:
        produced counts and per-output dot products match exactly.

        frames: int16 [n_frames, C] → int16 [n_out, C] (WORD2INT in the
        float universe, native int16 in the fixed universe — the same
        output conversion as process_interleaved)."""
        frames = np.ascontiguousarray(frames, dtype=np.int16)
        if frames.ndim != 2 or frames.shape[1] != self.nb_channels:
            raise ResamplerError(ResamplerErrorCode.INVALID_ARG)
        assert self._channels_in_lockstep()
        spec = self._spec
        x = np.ascontiguousarray(frames.T)  # [C, n]
        chans = list(range(self.nb_channels))
        ls = int(self.last_sample[0])
        f = int(self.samp_frac_num[0])
        n_magic = int(self.magic_samples[0])
        cap = int(out_capacity)

        m_out, m_cons, ls, f = ph.native_step(n_magic, cap, ls, f,
                                              spec.num, spec.den)
        f_out = f_cons = 0
        # fresh input runs only once the stash fully drained (the
        # !st->magic_samples gate, resample.c:940) — with an unbound
        # capacity one magic step always fully consumes (ls_after >= n).
        if n_magic - m_cons == 0:
            f_out, f_cons, ls, f = ph.native_step(
                x.shape[1], cap - m_out, ls, f, spec.num, spec.den)
        if n_magic > 0 or (x.shape[1] > 0 and cap > 0):
            self.started = True  # process_native ran (resample.c:886)
        acct = ph.ProcessAccounting(m_out, m_cons, f_out, f_cons)
        y = self._run_acct(x, chans, acct, n_magic, out_float=False)
        return np.ascontiguousarray(y.T)

    def _process_interleaved_any(self, frames, out_capacity, *, out_float):
        if frames.ndim != 2 or frames.shape[1] != self.nb_channels:
            raise ResamplerError(ResamplerErrorCode.INVALID_ARG)
        if not self._channels_in_lockstep():
            outs = [self._process(frames[None, :, c], [c], out_capacity,
                                  out_float=out_float)[0]
                    for c in range(self.nb_channels)]
            n = min(len(o) for o in outs)
            return np.stack([o[:n] for o in outs], axis=1)
        x = np.ascontiguousarray(frames.T)  # [C, n]
        y = self._process(x, list(range(self.nb_channels)), out_capacity,
                          out_float=out_float)
        return np.ascontiguousarray(y.T)

    def process_channel(self, c: int, samples: np.ndarray,
                        out_capacity: int) -> np.ndarray:
        """Single-channel path (speex_resampler_process_int semantics).
        Honors the configured in/out strides (resample.c:1170-1188):
        ``samples`` is read at every in_stride-th position; output is
        written at every out_stride-th position of the returned buffer
        (gaps zero-filled)."""
        x = np.ascontiguousarray(
            np.asarray(samples, dtype=np.int16)[::self.in_stride])[None, :]
        y = self._process(x, [c], out_capacity)[0]
        return self._apply_out_stride(y)

    def process_channel_float(self, c: int, samples: np.ndarray,
                              out_capacity: int) -> np.ndarray:
        """speex_resampler_process_float (resample.c:924-963) semantics."""
        x = np.ascontiguousarray(
            np.asarray(samples, dtype=np.float32)[::self.in_stride])[None, :]
        y = self._process(x, [c], out_capacity, out_float=True)[0]
        return self._apply_out_stride(y)

    def _apply_out_stride(self, y: np.ndarray) -> np.ndarray:
        if self.out_stride == 1:
            return y
        out = np.zeros(len(y) * self.out_stride, dtype=y.dtype)
        out[::self.out_stride] = y
        return out

    def _process(self, x: np.ndarray, chans: list[int],
                 out_capacity: int, *, out_float: bool = False) -> np.ndarray:
        """Shared core: x [B, n_new] (int16 or float32) for channels
        ``chans`` (all in identical phase state).  Returns [B, n_out] —
        int16 through WORD2INT, or raw float32 when ``out_float``."""
        c0 = chans[0]
        spec = self._spec
        N = spec.filt_len

        # C flips ``started`` only inside process_native (resample.c:886),
        # which never runs when the input length or output capacity is
        # zero (the while(ilen && olen) gates, :941/:989).  An unstarted
        # resampler that only ever saw empty/capacity-0 calls must KEEP
        # zeroing its memory on the next filter change instead of stashing
        # magic samples — observable in consumed-input accounting after a
        # set_rate/set_quality (magic>0 implies started, so the magic-drain
        # native calls never flip it first).
        if x.shape[1] > 0 and out_capacity > 0:
            self.started = True

        # Derive the exact (produced, consumed) split for the magic drain
        # and the fresh chunk by walking the reference's per-call loops
        # (bite quantization, ystack slots, magic gates) in pure integer
        # math — see ph.process_accounting.  Which of the two C entry-point
        # shapes applies follows the #ifdef FIXED_POINT name swap
        # (resample.c:924-928/:965-969): the ystack (staging) entry is the
        # float build's process_int and the fixed build's process_float.
        n_magic = int(self.magic_samples[c0])
        acct = ph.process_accounting(
            n_magic, x.shape[1], int(out_capacity),
            int(self.last_sample[c0]), int(self.samp_frac_num[c0]),
            spec.num, spec.den,
            xlen=self._mem_alloc_size - (N - 1),
            ystack=(out_float == self.fixed_point))
        return self._run_acct(x, chans, acct, n_magic, out_float=out_float)

    def _run_acct(self, x: np.ndarray, chans: list[int],
                  acct: "ph.ProcessAccounting", n_magic: int, *,
                  out_float: bool) -> np.ndarray:
        """Execute a pre-derived (produced, consumed) split: the magic-drain
        launch then the fresh-chunk launch, with exact state/history/pending
        updates.  ``acct`` comes either from ph.process_accounting (the
        entry-point bite/ystack walk) or from direct native-call bookkeeping
        (process_native_interleaved)."""
        outs = []
        odt = np.float32 if out_float else np.int16
        self.last_accounting = acct  # introspection for differential tests

        # Phase A — drain pending magic samples (resample.c:904-922, :938-940)
        if n_magic and (acct.magic_out or acct.magic_consumed):
            pend = np.stack([self._pending[c] for c in chans])
            y = self._launch(chans, pend, acct.magic_out,
                             acct.magic_consumed, out_float)
            outs.append(y)
            for c in chans:
                self._pending[c] = self._pending[c][acct.magic_consumed:]
                self.magic_samples[c] = n_magic - acct.magic_consumed

        # Phase B — the chunk itself, only once magic fully drained
        # (the !st->magic_samples gate, resample.c:940, :999)
        if acct.fresh_out or acct.fresh_consumed:
            outs.append(self._launch(chans, x, acct.fresh_out,
                                     acct.fresh_consumed, out_float))

        if not outs:
            return np.zeros((len(chans), 0), dtype=odt)
        return np.concatenate(outs, axis=1)

    def _launch(self, chans: list[int], new: np.ndarray,
                n_out: int, consumed: int,
                out_float: bool = False) -> np.ndarray:
        """Run one device launch over ``new`` samples for channels ``chans``
        (lockstep state), producing exactly ``n_out`` outputs and consuming
        exactly ``consumed`` inputs (both pre-derived by
        ph.process_accounting so capacity-bound bite/slot quantization
        matches the reference), updating history + phase state.  Returns
        outputs [B, n_out] (int16, or float32 when ``out_float``).

        The final phase state is the closed-form composition of the
        reference's per-bite native calls: each call does
        ``last_sample = advance(o) - cons`` (resample.c:891-894) and the
        Euclidean steps compose, so advance(total_out) - total_consumed
        reproduces the walked state exactly (ls_after - consumed may stay
        positive when the capacity binds — the residual points into the
        dropped input tail)."""
        spec = self._spec
        N = spec.filt_len
        c0 = chans[0]
        ls0 = int(self.last_sample[c0])
        f0 = int(self.samp_frac_num[c0])

        ls_after, f_after = ph.advance(n_out, ls0, f0, spec.num, spec.den)

        hist = np.stack([self._history[c] for c in chans])
        if self.fixed_point:
            # fixed-build mem is int16; the float-sample API converts on
            # entry with the fixed WORD2INT (resample.c:1002)
            if new.dtype == np.float32:
                from ..ops.fixed_math import word2int_fixed
                new = word2int_fixed(new)
            X = np.concatenate([hist, new.astype(np.int16)], axis=1)
        else:
            X = np.concatenate([hist, new.astype(np.float32)], axis=1)

        odt = np.float32 if out_float else np.int16
        if n_out <= 0:
            y = np.zeros((len(chans), 0), dtype=odt)
        elif self.degraded:
            y = np.zeros((len(chans), n_out), dtype=odt)
        else:
            try:
                if self.fixed_point:
                    from ..ops.fir_fixed import resample_fixed
                    y = resample_fixed(X, ls0, f0, n_out, self._spec)
                    if out_float:
                        # fixed process_float output: int16 -> float store
                        # (resample.c:1019-1022, fixed branch), exact
                        y = y.astype(np.float32)
                elif self._host_route:
                    from ..ops.fir_exact import resample_exact_state
                    y = resample_exact_state(X, ls0, f0, n_out, self._spec,
                                             raw=out_float)
                else:
                    y = self._run_fir(X, ls0, f0, n_out, out_float)
            except (MemoryError, RuntimeError) as exc:
                # resampler_basic_zero swap (resample.c:561-591): emit zeros
                # with the exact sample accounting from here on
                self.degraded = True
                self.degraded_cause = exc
                _log.warning("ResamplerCore degraded to zero output: %r",
                             exc)
                y = np.zeros((len(chans), n_out), dtype=odt)

        # state update (resample.c:891-899)
        for i, c in enumerate(chans):
            self.last_sample[c] = ls_after - consumed
            self.samp_frac_num[c] = f_after
            self._history[c] = X[i, consumed:consumed + N - 1]
        return y

    # ------------------------------------------------------------------
    # Device route on ``self.device`` (the JAX package runs these as XLA
    # ops, outside any Pallas kernel): the matmul is plain torch, the
    # gather a kernel on the card (``fm.resample_gather``).
    # ------------------------------------------------------------------

    def _run_fir(self, X: np.ndarray, ls0: int, f0: int,
                 n_out: int, out_float: bool = False) -> np.ndarray:
        """X int16 [B, N-1+n_new]; window start for output k is
        ls0 + (f0+k*num)//den indexed from X[0] (history origin)."""
        spec = self._spec
        num, den, N = spec.num, spec.den, spec.filt_len
        if _device_route_gathers(spec):
            return self._run_fir_gather(X, ls0, f0, n_out, out_float)
        group = fm.choose_group(num, den, N)
        R = group * den
        stride = group * num
        L = N + stride

        # fold ls0 into the patch origin by dropping the first ls0 samples
        Xs = X[:, ls0:]
        nb = max(-(-n_out // R), 1)
        A = -(-L // stride)  # patch length in stride units (W rows padded)
        T = (nb + A) * stride
        xp = np.zeros((X.shape[0], T), dtype=np.float32)
        m = min(Xs.shape[1], T)
        xp[:, :m] = Xs[:, :m]
        w = self._weights.get(spec, f0, group)
        y = fm.resample_conv(torch.from_numpy(xp).to(self.device), w,
                             stride=stride, raw=out_float)
        return to_host(y[:, :n_out])

    def _run_fir_gather(self, X: np.ndarray, ls0: int, f0: int,
                        n_out: int, out_float: bool = False) -> np.ndarray:
        spec = self._spec
        num, den, N = spec.num, spec.den, spec.filt_len
        k = np.arange(n_out, dtype=np.int64)
        t = f0 + k * num
        p = (t % den).astype(np.int64)
        s = (ls0 + t // den).astype(np.int32)
        T = X.shape[1]
        s = np.minimum(s, max(T - N, 0)).astype(np.int32)  # masked tail lanes
        taps = spec.phase_rows(p)  # [n_out, N] host gather (lazy: huge-den
        # specs compute just these rows, never the full [den, N] table)
        dev = self.device
        # the rows form: plan and taps are made each call, where a band
        # would be built on the host too, and its zero taps would carry a
        # non-finite float sample into outputs whose windows miss it
        plan = (fm.gather_plan_rows(s, N, x_itemsize=X.dtype.itemsize)
                if dev.type == "cuda" else None)
        y = fm.resample_gather(torch.from_numpy(X).to(dev),
                               torch.from_numpy(taps).to(dev),
                               torch.from_numpy(s).to(dev), raw=out_float,
                               plan=plan)
        return to_host(y)
