"""Batched multi-stream serving engine on PyTorch: the port's main path.

S concurrent streams × C channels become one batch axis of B = S*C
independent lanes resampled in a single device launch.  Every launch
consumes a fixed quantum of input frames per lane that is a multiple of
``num``, so the fractional phase returns to its initial value after every
launch: one step with constant weights serves the engine until a flush
changes the phase (time-major buffers, lanes minor):

    step: (hist i16[H, B], x i16[chunk_rows, B]) -> (hist', y i16[n_out, B])

The launch geometry, weights and buffer contract are those of the JAX
package's ``speex_resampler_tpu/parallel/batch.py``, so the two engines can
be compared launch by launch.  Only the phase-tiled geometry in the float
universe is ported; every other path raises ``NotImplementedError`` naming
its ROADMAP.md item.  The kernel is ``ops/tiled_fir.resample_tiled``.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import threading

import numpy as np
import torch

from ..ops import filter_design as fd
from ..ops import phase as ph
from ..ops import tiled_fir as tf
from ..utils.errors import ResamplerError, ResamplerErrorCode
from ..utils.host import to_host

__all__ = ["BatchedResampler", "make_batched_step", "BatchSpec",
           "weights_from_jax"]


# Launch-geometry thresholds of the JAX package, kept identical so both
# engines pick the same launch quantum (they were sized for TPU VMEM; a
# Hopper retune is separate work).  Phase-tiled weights up to the first
# size take the tiled geometry; above it the streamed one (not ported).
_MAX_TILED_WEIGHT_BYTES = 4 * 1024 * 1024
_MAX_STREAMED_WEIGHT_BYTES = 256 * 1024 * 1024

# int8 scheme gates (worst-case certificate, s16 LSB): "auto" picks int8
# below the first; an explicit scheme="int8" is refused above the second
# (the <=1 LSB max-error contract itself would be at risk near 0.5).
_INT8_CERT_GATE = 0.20
_INT8_CERT_MAX = 0.35


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to PyTorch yet (ROADMAP.md {item})")


@dataclasses.dataclass(frozen=True)
class BatchSpec:
    """Static launch geometry for one (ratio, quality) config.

    Only kernel == "tiled" is ported: blocks of R outputs with cyclic
    phase weights; n_blocks is a multiple of P and n_blocks/P "periods"
    consume S inputs each.  The fields are the JAX package's (``group`` is
    its dense super-block factor, 1 here), so the two compare as equal.
    """
    num: int
    den: int
    quality: int
    filt_len: int
    group: int
    n_blocks: int       # R-blocks (mult of P)
    f0: int             # fractional phase at every launch start
    kernel: str = "tiled"
    S: int = 0          # inputs per P blocks
    P: int = 0          # weight cycle length
    R: int = 0          # outputs per block

    @property
    def in_per_launch(self) -> int:
        """Input frames consumed per lane per launch."""
        return (self.n_blocks // self.P) * self.S

    @property
    def out_per_launch(self) -> int:
        """Output frames produced per lane per launch."""
        return self.n_blocks * self.R


def _tiled_weight_bytes_estimate(spec: fd.FilterSpec, R: int = 128) -> int:
    """Size of the phase-tiled weight set WITHOUT building it (the probe
    itself would allocate GBs for pathological coprime ratios)."""
    g = math.gcd(R * spec.num, spec.den)
    P0 = spec.den // g
    S0 = P0 * R * spec.num // spec.den
    factor = 16 // math.gcd(max(S0, 1), 16)
    P = P0 * factor
    K = spec.filt_len + (R - 1) * spec.num // spec.den + 32
    return P * K * R * 4


def _v3_back(S: int, H: int) -> int:
    """How many S-blocks of look-back the history prefix spans."""
    return -(-H // S)


def _v3_views(S: int, K: int, H: int, offsets) -> int:
    """Number of S-row chunk windows a period's patches can touch (the
    TPU kernel's view count; it sizes chunk_rows identically here)."""
    back = _v3_back(S, H)
    off_max = int(max(offsets))
    return (back * S - H + off_max + K - 1) // S + 1


def _v3_periods_per_program(P: int) -> int:
    """Launch-quantum unit in periods: short weight cycles (P == 1) batch
    ~20 blocks per unit like the flagship's natural P."""
    return max(1, 20 // P)


def _resolve_scheme(w_cert: np.ndarray, scheme: str):
    """Returns (scheme, int8p, scales): "auto" -> int8 when the
    digit-escalating certificate clears the gate, else "highest" (the JAX
    package picks split5 there, which has no port yet: ROADMAP.md K1c); an
    explicit "int8" request is refused past the hard cap."""
    if scheme not in ("auto", "int8", "split5", "highest"):
        raise ResamplerError(ResamplerErrorCode.INVALID_ARG)
    if scheme == "split5":
        raise _unported('scheme="split5"', "K1c")
    int8p = None
    if scheme == "auto":
        int8p = tf.int8_weights_auto(w_cert, _INT8_CERT_GATE)
        scheme = "int8" if int8p is not None else "highest"
    scales = ()
    if scheme == "int8":
        if int8p is None:
            int8p = tf.int8_weights_auto(w_cert, _INT8_CERT_MAX)
            if int8p is None:
                raise ResamplerError(ResamplerErrorCode.INVALID_ARG)
        scales = int8p[2]
    return scheme, int8p, scales


def _next_hist(hist: torch.Tensor, x: torch.Tensor, n_in: int,
               H: int) -> torch.Tensor:
    """Last H rows of the virtual stream hist ++ x[:n_in], as a new tensor
    (x is a reused launch buffer).  When the launch quantum is smaller than
    the history window (n_in < H), part of the previous history survives
    into the next launch."""
    if n_in >= H:
        return x[n_in - H:n_in].clone()
    return torch.cat([hist[n_in:], x[:n_in]])


def _adapt_hist(hist, rows: int, filt_len: int, cols: int) -> np.ndarray:
    """Re-layout a checkpointed filter history to THIS engine's hist-row
    geometry.  Valid history always occupies the LAST filt_len-1 rows
    (leading rows are kernel-family alignment padding), so a checkpoint
    taken under a different kernel family restores losslessly.  A geometry
    that cannot be adapted raises INVALID_ARG."""
    hist = np.array(hist, dtype=np.int16)
    keep = filt_len - 1
    if hist.ndim != 2 or hist.shape[1] != cols or hist.shape[0] < keep:
        raise ResamplerError(ResamplerErrorCode.INVALID_ARG)
    if hist.shape[0] == rows:
        return hist
    out = np.zeros((rows, cols), dtype=np.int16)
    if keep:
        out[rows - keep:] = hist[hist.shape[0] - keep:]
    return out


def _hist_rows_tiled(filt_len: int) -> int:
    """History rows: filt_len-1 rounded up to 16, as in the JAX package
    (a TPU sublane tile; kept so weights and offsets stay identical)."""
    return -(-(filt_len - 1) // 16) * 16


def _tiled_R(spec: fd.FilterSpec) -> int:
    """Output-block height R: 128, doubled while a block's input span
    R*num/den stays under 96 rows, capped at 512 and at half the weight
    budget (the JAX package's rule for the float universe, kept for
    identical geometry)."""
    R = 128
    while R < 512 and (R * spec.num) // spec.den < 96:
        R2 = R * 2
        g = math.gcd(R2 * spec.num, spec.den)
        S0 = R2 * spec.num // g                   # per P0 = den/g blocks
        P = (spec.den // g) * (16 // math.gcd(S0, 16))
        K_est = (-(-(R2 * spec.num) // spec.den)) + spec.filt_len + 16
        if 4 * P * K_est * R2 > _MAX_TILED_WEIGHT_BYTES // 2:
            break
        R = R2
    return R


def _tiled_weights(spec: fd.FilterSpec, f0: int = 0):
    """Phase-tiled weight tables, cached ON the spec (at most 4 f0s; a
    flush rebuilds at a handful of phases).  design_filter is lru_cache'd,
    so the spec is shared across engines and the cache serializes on the
    spec's own lock."""
    with fd._spec_lock(spec):
        cache = getattr(spec, "_ptw_cache", None)
        if cache is None:
            cache = {}
            object.__setattr__(spec, "_ptw_cache", cache)
        if f0 not in cache:
            if len(cache) >= 4:
                cache.pop(next(iter(cache)))
            H = _hist_rows_tiled(spec.filt_len)
            cache[f0] = ph.build_phase_tiled_weights(
                spec.phase_table, spec.num, spec.den, f0, R=_tiled_R(spec),
                origin_shift=H - (spec.filt_len - 1))
        return cache[f0]


@dataclasses.dataclass(frozen=True)
class BatchedStep:
    """Steady-state step + its launch buffer contract.

    fn(hist i16[hist_rows, B], x i16[chunk_rows, B], w)
        -> (hist' i16[hist_rows, B], y i16[out_per_launch, B])
    x rows [0, in_per_launch) are the chunk; rows
    [in_per_launch, in_per_launch + zero_tail) must be zero; any further
    rows are don't-care padding.  ``w`` is the kernel's device weights
    (ops/tiled_fir.device_weights); ``kernel_kw`` the remaining arguments
    of its launch (``tf.resample_tiled(hist, x, w, **kernel_kw)``).
    """
    fn: object
    w: tuple
    hist_rows: int
    chunk_rows: int
    zero_tail: int
    scheme: str = "highest"   # resolved precision scheme
    kernel_kw: dict = dataclasses.field(default_factory=dict)


def _launch_geometry(spec: fd.FilterSpec, target_in_frames: int,
                     f0: int = 0,
                     max_in_frames: int | None = None) -> BatchSpec:
    """Static launch geometry.  ``max_in_frames`` is a HARD cap on the
    launch quantum (the engine's availability latency): a geometry whose
    rounding overflows it is re-quantized within the tiled family; a cap
    below one tiled unit needs the dense geometry (not ported).  Raises
    INVALID_ARG when even one period exceeds the cap."""
    if max_in_frames is None:
        return _launch_geometry_impl(spec, target_in_frames, f0)
    if spec.num > max_in_frames:
        raise ResamplerError(ResamplerErrorCode.INVALID_ARG)
    bspec = _launch_geometry_impl(spec, min(target_in_frames, max_in_frames),
                                  f0)
    if bspec.in_per_launch <= max_in_frames:
        return bspec
    unit = bspec.S * _v3_periods_per_program(bspec.P)
    if unit <= max_in_frames:
        b2 = _launch_geometry_impl(spec, (max_in_frames // unit) * unit, f0)
        if b2.in_per_launch <= max_in_frames:
            return b2
    raise _unported("a max_latency_ms cap below one tiled launch unit "
                    "(dense geometry)", "M8")


def _launch_geometry_impl(spec: fd.FilterSpec, target_in_frames: int,
                          f0: int) -> BatchSpec:
    if spec.fixed_point:
        raise _unported("the fixed-point universe", "M6")
    if _tiled_weight_bytes_estimate(spec) <= 2 * _MAX_STREAMED_WEIGHT_BYTES:
        ptw = _tiled_weights(spec, f0)
        if ptw.w.nbytes <= _MAX_TILED_WEIGHT_BYTES:
            gp = _v3_periods_per_program(ptw.P)
            n_periods = max(gp, round(target_in_frames / (ptw.S * gp)) * gp)
            return BatchSpec(num=spec.num, den=spec.den,
                             quality=spec.quality, filt_len=spec.filt_len,
                             group=1, n_blocks=n_periods * ptw.P, f0=f0,
                             kernel="tiled", S=ptw.S, P=ptw.P, R=ptw.R)
        if ptw.w.nbytes <= _MAX_STREAMED_WEIGHT_BYTES:
            raise _unported("the streamed geometry", "K2/M7")
    raise _unported("the dense and gather geometries", "K3/M8")


# Per-process memo for built steps (weights decomposed and uploaded once
# per config and device).  BatchedStep is frozen and its weights are never
# written, so instances are shared across engines.  LRU-bounded by entry
# count and total weight bytes.
_STEP_CACHE: "collections.OrderedDict[tuple, BatchedStep]" = \
    collections.OrderedDict()
_STEP_CACHE_LOCK = threading.Lock()
_STEP_CACHE_MAX_ENTRIES = 16
_STEP_CACHE_MAX_BYTES = 256 * 1024 * 1024


def _step_weight_bytes(step: BatchedStep) -> int:
    return sum(t.numel() * t.element_size() for t in step.w)


def make_batched_step(spec: fd.FilterSpec, bspec: BatchSpec, *,
                      device="cuda", scheme: str = "auto") -> BatchedStep:
    """Memoizing front-end for :func:`_build_batched_step`."""
    device = torch.device(device)
    key = (spec.num, spec.den, spec.quality, spec.fixed_point,
           spec.use_direct, spec.filt_len, spec.oversample, bspec, scheme,
           str(device))
    with _STEP_CACHE_LOCK:
        hit = _STEP_CACHE.get(key)
        if hit is not None:
            _STEP_CACHE.move_to_end(key)
            return hit
    # build outside the lock (duplicate builds of one key are benign)
    step = _build_batched_step(spec, bspec, device=device, scheme=scheme)
    with _STEP_CACHE_LOCK:
        if key not in _STEP_CACHE:
            _STEP_CACHE[key] = step
        _STEP_CACHE.move_to_end(key)
        total = sum(_step_weight_bytes(s) for s in _STEP_CACHE.values())
        while _STEP_CACHE and (
                len(_STEP_CACHE) > _STEP_CACHE_MAX_ENTRIES
                or total > _STEP_CACHE_MAX_BYTES):
            _, old = _STEP_CACHE.popitem(last=False)
            total -= _step_weight_bytes(old)
        return _STEP_CACHE.get(key, step)


def _build_batched_step(spec: fd.FilterSpec, bspec: BatchSpec, *,
                        device: torch.device,
                        scheme: str = "auto") -> BatchedStep:
    """Build the steady-state step on the tiled geometry.

    ``scheme``: "int8" (certificate-gated digit planes), "highest" (exact
    f32), or "auto" = int8 when the worst-case certificate clears the
    gate, else highest (see _resolve_scheme)."""
    if spec.fixed_point:
        raise _unported("the fixed-point universe", "M6")
    if bspec.kernel != "tiled":
        raise _unported(f"the {bspec.kernel} geometry", "K2/K3/M7/M8")
    ptw = _tiled_weights(spec, bspec.f0)
    assert (ptw.S, ptw.P, ptw.R) == (bspec.S, bspec.P, bspec.R)
    scheme, int8p, scales = _resolve_scheme(ptw.w, scheme)
    N = spec.filt_len
    H = _hist_rows_tiled(N)
    n_in, n_out = bspec.in_per_launch, bspec.out_per_launch
    n_periods = bspec.n_blocks // ptw.P
    V = (_v3_views(ptw.S, ptw.K, H, ptw.offsets)
         + _v3_periods_per_program(ptw.P) - 1)
    chunk_rows = (n_periods - _v3_back(ptw.S, H) + V) * ptw.S
    host_w = (int8p[0], int8p[1]) if scheme == "int8" else ptw.w
    w = tf.device_weights(host_w, scheme, device)
    kernel_kw = dict(
        offsets=torch.from_numpy(ptw.offsets.astype(np.int32)).to(device),
        S=ptw.S, n_blocks=bspec.n_blocks, scheme=scheme, scales=scales)

    def step(hist, x, w):
        y = tf.resample_tiled(hist, x, w, **kernel_kw)
        return _next_hist(hist, x, n_in, H), y[:n_out]

    return BatchedStep(fn=step, w=w, hist_rows=H, chunk_rows=chunk_rows,
                       zero_tail=ptw.K, scheme=scheme, kernel_kw=kernel_kw)


def weights_from_jax(w, scheme: str, device="cuda") -> tuple:
    """A JAX ``BatchedStep.w`` converted to numpy (an f32 [P, K, R] array
    for "highest", the ``(planes, bias)`` tuple for "int8") -> this
    package's device weights for the same step."""
    return tf.device_weights(w, scheme, torch.device(device))


class _HostFifo:
    """Staging FIFO of time-major [n, B] int16 rows, O(1) amortized per
    push (a deque of chunks + a consume offset into the head)."""

    def __init__(self, B: int):
        self.B = B
        self._parts: collections.deque[np.ndarray] = collections.deque()
        self._off = 0      # consumed rows of the head part
        self._n = 0

    def __len__(self) -> int:
        return self._n

    def push(self, x: np.ndarray, owned: bool = False) -> None:
        """``owned=True`` skips the defensive copy when the caller hands
        over a buffer nothing else aliases."""
        if not x.shape[0]:
            return
        if not owned:
            x = x.copy()
        self._parts.append(x)
        self._n += x.shape[0]

    def pop_into(self, out: np.ndarray, n: int) -> None:
        """Consume n rows directly into ``out[:n]`` (one copy, straight
        into the launch slab; rows past n are left untouched)."""
        assert self._n >= n, (self._n, n)
        w = 0
        while w < n:
            head = self._parts[0]
            take = min(head.shape[0] - self._off, n - w)
            out[w:w + take] = head[self._off:self._off + take]
            w += take
            self._off += take
            if self._off == head.shape[0]:
                self._parts.popleft()
                self._off = 0
        self._n -= n

    def pop_all(self) -> np.ndarray:
        """Consume everything as one array (cold paths: drain/flush)."""
        out = np.empty((self._n, self.B), dtype=np.int16)
        self.pop_into(out, self._n)
        return out

    def peek_all(self) -> np.ndarray:
        """Snapshot without consuming (checkpointing)."""
        if not self._parts:
            return np.zeros((0, self.B), dtype=np.int16)
        parts = list(self._parts)
        parts[0] = parts[0][self._off:]
        if len(parts) == 1:
            return parts[0].copy()
        return np.concatenate(parts, axis=0)


class BatchedResampler:
    """Resample S identical-config streams (C channels each) in lockstep.

    Same semantics as the JAX package's ``BatchedResampler`` for
    ``process``/``flush``/``reset_mem``/``state_dict``: each lane's output
    equals the reference's for that lane's samples within 1 LSB, and a
    checkpoint from either engine loads in the other.

    Parameters
    ----------
    n_streams, channels : lane geometry; B = n_streams * channels.
    target_chunk_frames : desired input frames per lane per launch; rounded
        to the launch quantum.
    device : "cuda" (the kernel; raises when no CUDA device exists) or
        "cpu" (the kernel's plain PyTorch version).
    scheme : "auto", "int8" or "highest".
    fixed_point, mesh : not ported yet (raise NotImplementedError).
    max_latency_ms : hard cap on the launch quantum.

    A launch or readback error raises; there is no degraded mode yet.
    """

    def __init__(self, n_streams: int, channels: int, in_rate: int,
                 out_rate: int, quality: int = 7, *,
                 target_chunk_frames: int = 4096,
                 device="cuda",
                 scheme: str = "auto",
                 fixed_point: bool = False,
                 max_latency_ms: float | None = None,
                 mesh=None):
        if n_streams <= 0 or channels <= 0:
            raise ResamplerError(ResamplerErrorCode.INVALID_ARG)
        if in_rate <= 0 or out_rate <= 0:
            raise ResamplerError(ResamplerErrorCode.INVALID_ARG)
        if max_latency_ms is not None and max_latency_ms <= 0:
            raise ResamplerError(ResamplerErrorCode.INVALID_ARG)
        if fixed_point:
            raise _unported("fixed_point=True", "M6")
        if mesh is not None:
            raise _unported("mesh= (multi-GPU lanes)", "M12")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but no CUDA device is "
                               "available")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        self.n_streams = n_streams
        self.channels = channels
        self.in_rate = in_rate
        self.out_rate = out_rate
        g = math.gcd(in_rate, out_rate)
        try:
            self.spec = fd.design_filter(in_rate // g, out_rate // g,
                                         quality)
        except fd.OverflowArgError:
            raise ResamplerError(ResamplerErrorCode.OVERFLOW)
        self.B = n_streams * channels
        self._target = target_chunk_frames
        self._max_in = (None if max_latency_ms is None
                        else int(max_latency_ms * in_rate / 1000))
        self._scheme = scheme
        self._f0 = 0
        #: kernel launches made by this engine
        self.launches = 0
        # steps keyed by f0 (a flush may move the phase; keep a few)
        self._step_cache: dict = {}
        self._build_step(0)
        self._hist = torch.zeros((self._step.hist_rows, self.B),
                                 dtype=torch.int16, device=self.device)
        self._skip = 0
        # staging FIFO of not-yet-launched input frames, [*, B] host int16
        self._staged = _HostFifo(self.B)
        # outputs banked by a partial drain, surfaced on the next
        # process()/flush()
        self._carry_out: list[np.ndarray] = []

    def _build_step(self, f0: int) -> None:
        """(Re)build the steady-state step at fractional phase ``f0``.  The
        launch quantum is f0-independent; only weights and offsets change."""
        cached = self._step_cache.get(f0)
        if cached is None:
            bspec = _launch_geometry(self.spec, self._target, f0=f0,
                                     max_in_frames=self._max_in)
            step = make_batched_step(self.spec, bspec, device=self.device,
                                     scheme=self._scheme)
            # persistent launch slab; rows past the quantum stay zero
            # (pop_into and _launch write only [:in_per_launch])
            slab = np.zeros((step.chunk_rows, self.B), dtype=np.int16)
            cached = (bspec, step, slab)
            if len(self._step_cache) >= 4:
                self._step_cache.pop(next(iter(self._step_cache)))
            self._step_cache[f0] = cached
        self.bspec, self._step, self._slab = cached
        self._f0 = f0

    # -- geometry --------------------------------------------------------

    @property
    def in_frames_per_launch(self) -> int:
        return self.bspec.in_per_launch

    @property
    def out_frames_per_launch(self) -> int:
        return self.bspec.out_per_launch

    @property
    def launch_latency_ms(self) -> float:
        """Availability latency of the batch quantum."""
        return self.bspec.in_per_launch / self.in_rate * 1000.0

    def input_latency(self) -> int:
        return self.spec.input_latency

    def output_latency(self) -> int:
        return self.spec.output_latency

    def _drain_partial(self) -> None:
        """Consume the sub-quantum staged remainder EXACTLY, banking its
        outputs into ``_carry_out`` and advancing the engine phase.

        After feeding s frames, the closed form puts the stream at
        t = f0 + m*num (m = producible outputs): next window origin
        t//den >= s and fractional phase t % den.  The origin surplus
        becomes a pending skip (absorbed from future input); a changed
        fractional phase rebuilds the step with new f0 weights.  The true
        filter history is recomputed host-side from (hist ++ staged), so
        the launch's zero padding never contaminates state."""
        s = len(self._staged)
        if s == 0:
            return
        q = self.bspec.in_per_launch
        staged = self._staged.pop_all()
        num, den = self.spec.num, self.spec.den
        m = ph.producible_outputs(s, 0, self._f0, num, den)
        hist_host = to_host(self._hist)
        chunk = np.zeros((q, self.B), dtype=np.int16)
        chunk[:s] = staged
        _, y = self._launch(chunk)
        if m:
            self._carry_out.append(to_host(y)[:m])
        self._hist = self._to_device(
            np.concatenate([hist_host, staged])[s:])
        t = self._f0 + m * num
        self._skip = t // den - s     # pending origin advance, >= 0
        if t % den != self._f0:
            self._build_step(t % den)

    def reset_mem(self):
        """resample.c:1208-1220."""
        if self._f0 != 0:
            self._build_step(0)
        self._hist = torch.zeros((self._step.hist_rows, self.B),
                                 dtype=torch.int16, device=self.device)
        self._staged = _HostFifo(self.B)
        self._skip = 0
        self._carry_out = []

    # -- checkpoint/resume (the state IS a checkpoint) ---------------------

    def state_dict(self) -> dict:
        """The JAX engine's checkpoint format (host numpy arrays)."""
        return {
            "in_rate": self.in_rate, "out_rate": self.out_rate,
            "quality": self.spec.quality,
            "fixed_point": False,
            "n_streams": self.n_streams, "channels": self.channels,
            "hist": to_host(self._hist),
            "staged": self._staged.peek_all(),
            "skip": self._skip,
            "f0": self._f0,
            "degraded": False,
            "carry_out": [o.copy() for o in self._carry_out],
        }

    def load_state_dict(self, state: dict):
        """Accepts this engine's or the JAX engine's ``state_dict()``."""
        if (state["n_streams"], state["channels"]) != (self.n_streams,
                                                       self.channels) or \
                (state["in_rate"], state["out_rate"], state["quality"]) != \
                (self.in_rate, self.out_rate, self.spec.quality) or \
                state.get("fixed_point", False):
            raise ResamplerError(ResamplerErrorCode.INVALID_ARG)
        if state.get("degraded", False):
            raise _unported("a degraded (zero-fill) engine state", "M4")
        f0 = int(state.get("f0", 0))
        if f0 != self._f0:
            self._build_step(f0)
        self._hist = self._to_device(_adapt_hist(
            state["hist"], self._step.hist_rows, self.spec.filt_len, self.B))
        self._staged = _HostFifo(self.B)
        self._staged.push(np.array(state["staged"], dtype=np.int16),
                          owned=True)
        self._skip = int(state["skip"])
        self._carry_out = [np.array(o, dtype=np.int16)
                           for o in state.get("carry_out", [])]

    # -- processing ------------------------------------------------------

    def process(self, frames: np.ndarray) -> np.ndarray:
        """frames: int16 [S, n, C] (or time-major lanes [n, B]) → int16
        [S, m, C] (or [m, B]).

        Stages input and runs as many full launches as are available; m is
        a multiple of out_frames_per_launch (possibly 0).  Call flush() at
        end-of-stream to drain the remainder.
        """
        x = self._to_lanes(frames)
        if self._skip:
            # fold the first k frames into the history tail (pending
            # origin advance left by a drain)
            k = min(self._skip, x.shape[0])
            absorbed = self._to_device(np.ascontiguousarray(x[:k]))
            self._hist = torch.cat([self._hist[k:], absorbed])
            x = x[k:]
            self._skip -= k
        # the 3-D frame layout was already copied by _to_lanes; hand the
        # FIFO ownership so only genuinely-aliasing 2-D views get the
        # defensive copy
        self._staged.push(x, owned=not np.may_share_memory(x, frames))
        outs, self._carry_out = self._carry_out, []
        q = self.bspec.in_per_launch
        while len(self._staged) >= q:
            self._staged.pop_into(self._slab, q)  # straight into the slab
            self._hist, y = self._launch(self._slab)
            outs.append(to_host(y))
        if outs:
            return self._from_lanes(np.concatenate(outs, axis=0), frames)
        return self._from_lanes(np.zeros((0, self.B), dtype=np.int16),
                                frames)

    def flush(self) -> np.ndarray:
        """Drain staged frames exactly; returns the outputs whose windows
        start within the real input (plus any banked outputs), in
        [S, m, C] layout.  The engine state stays exact: processing may
        continue."""
        self._drain_partial()
        outs, self._carry_out = self._carry_out, []
        if not outs:
            return np.zeros((self.n_streams, 0, self.channels), np.int16)
        return self._lanes_to_frames(np.concatenate(outs, axis=0))

    def _launch(self, chunk_np: np.ndarray):
        """Upload one chunk and launch the step; the result is read with
        to_host (which waits for the device)."""
        q = self.bspec.in_per_launch
        if chunk_np.shape[0] == self._step.chunk_rows:
            slab = chunk_np
        else:
            assert chunk_np.shape[0] == q, chunk_np.shape
            slab = self._slab
            slab[:q] = chunk_np
        x = self._to_device(slab)
        self.launches += 1
        return self._step.fn(self._hist, x, self._step.w)

    # -- layout helpers ---------------------------------------------------
    # lane l = stream*channels + channel; time-major [n, B] on device.

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _to_lanes(self, frames: np.ndarray) -> np.ndarray:
        frames = np.asarray(frames, dtype=np.int16)
        if frames.ndim == 2:  # already time-major lanes [n, B]
            if frames.shape[1] != self.B:
                raise ResamplerError(ResamplerErrorCode.INVALID_ARG)
            return frames
        if frames.ndim != 3 or frames.shape[0] != self.n_streams \
                or frames.shape[2] != self.channels:
            raise ResamplerError(ResamplerErrorCode.INVALID_ARG)
        # [S, n, C] -> [n, S*C]
        return np.ascontiguousarray(
            frames.transpose(1, 0, 2).reshape(frames.shape[1], self.B))

    def _lanes_to_frames(self, lanes: np.ndarray) -> np.ndarray:
        return lanes.reshape(-1, self.n_streams, self.channels).transpose(
            1, 0, 2)

    def _from_lanes(self, lanes: np.ndarray, like: np.ndarray) -> np.ndarray:
        if np.asarray(like).ndim == 2:
            return lanes
        return self._lanes_to_frames(lanes)
