"""Batched multi-stream serving engine on PyTorch: the port's main path.

S concurrent streams × C channels become one batch axis of B = S*C
independent lanes resampled in a single device launch.  Every launch
consumes a fixed quantum of input frames per lane that is a multiple of
``num``, so the fractional phase returns to its initial value after every
launch: one step with constant weights serves the engine until a flush
changes the phase (time-major buffers, lanes minor):

    step: (hist i16[H, B], x i16[>= n_in, B]) -> (hist', y i16[n_out, B])

The launch geometry, weights and buffer contract are those of the JAX
package's ``speex_resampler_tpu/parallel/batch.py`` (its ``use_pallas=True``
choice), so the two engines can be compared launch by launch.  All four
geometries serve in both numeric universes (float, and the Q15 fixed-point
universe with its exact scheme "fixed"):

- "tiled" (small weight cycles, e.g. 44.1k -> 48k) and "streamed" (large
  ones, e.g. 48k -> 44.1k), the two phase-tiled geometries:
  ``ops/streamed_fir.resample_streamed``, one launcher for both;
- "dense": launch quanta below one tiled or streamed unit (a hard
  ``max_latency_ms`` cap such as the voip preset's 20 ms):
  ``ops/dense_fir.resample_dense`` in the float universe,
  ``ops/dense_fir.resample_dense_fixed`` in the fixed one;
- "gather": huge reduced denominators (e.g. 44100 -> 44101),
  ``ops/fir_matmul.resample_gather[_fixed]``.

Every launch is one hand-written CUDA kernel on the card (``csrc/``) and
its plain PyTorch version on the CPU.

``mesh=`` (``make_batched_step`` and ``BatchedResampler``) splits the lanes
over a sequence of devices, one equal contiguous shard each, as the JAX
package's ``shard_map`` over the lane axis does (``parallel/mesh.py``).

``make_batched_step(..., lane_major=True)`` gives the serving layout of
``runtime/fleet.py``: the step takes ``x i16[B, chunk_rows]`` and returns
``y i16[B, out_rows]``, both transposes on the device inside the step.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import threading

import numpy as np
import torch

from ..ops import _build
from ..ops import dense_fir as df
from ..ops import filter_design as fd
from ..ops import fir_matmul as fm
from ..ops import phase as ph
from ..ops import streamed_fir as sf
from ..ops import tiled_fir as tf
from ..utils.degrade import ZeroFillDegradation
from ..utils.errors import ResamplerError, ResamplerErrorCode
from ..utils.host import Readback, to_host_into
from ..utils.profiling import span
from .mesh import mesh_devices, shard_columns, split_lanes

__all__ = ["BatchedResampler", "make_batched_step", "BatchSpec",
           "weights_from_jax", "DEFAULT_DEVICE"]


# Launch-geometry thresholds of the JAX package, kept identical so both
# engines pick the same launch quantum (they were sized for TPU VMEM; a
# Hopper retune is separate work).  Phase-tiled weights up to the first
# size take the tiled geometry; up to the second the streamed one.
_MAX_TILED_WEIGHT_BYTES = 4 * 1024 * 1024
_MAX_STREAMED_WEIGHT_BYTES = 256 * 1024 * 1024

# int8 scheme gates (worst-case certificate, s16 LSB): "auto" picks int8
# below the first; an explicit scheme="int8" is refused above the second
# (the <=1 LSB max-error contract itself would be at risk near 0.5).
_INT8_CERT_GATE = 0.20
_INT8_CERT_MAX = 0.35

# Fixed-universe tiled weights (int16, n_accum columns per output) may use
# more than the float cap (the JAX package's VMEM choice, kept for identical
# geometry).
_MAX_FIXED_TILED_WEIGHT_BYTES = 6 * 1024 * 1024


class _DefaultDevice(str):
    """The type of ``device=``'s default, "cuda": an explicit device is
    told apart from it, so that ``device`` beside ``mesh`` raises."""


DEFAULT_DEVICE = _DefaultDevice("cuda")


def _placement(device, mesh) -> tuple:
    """The devices of a step or an engine, one a lane shard:
    ``(device,)`` without a mesh, else the mesh's devices.  A mesh takes
    the place of ``device``: passing both raises INVALID_ARG."""
    if mesh is None:
        return (torch.device(device),)
    if device is not DEFAULT_DEVICE:
        raise ResamplerError(ResamplerErrorCode.INVALID_ARG)
    return mesh_devices(mesh)


@dataclasses.dataclass(frozen=True)
class BatchSpec:
    """Static launch geometry for one (ratio, quality) config.

    kernel == "tiled" or "streamed": blocks of R outputs with cyclic phase
    weights; n_blocks is a multiple of P and n_blocks/P "periods" consume
    S inputs each.  kernel == "dense": n_blocks super-blocks of group*den
    outputs, each consuming stride = group*num inputs.  kernel ==
    "gather": n_blocks blocks of num inputs -> den outputs (group 1).  The
    fields are the JAX package's, so the two compare as equal.
    """
    num: int
    den: int
    quality: int
    filt_len: int
    group: int          # dense: super-block factor G
    n_blocks: int       # tiled/streamed: R-blocks (mult of P)
    f0: int             # fractional phase at every launch start
    kernel: str = "tiled"
    S: int = 0          # inputs per P blocks
    P: int = 0          # weight cycle length
    R: int = 0          # outputs per block

    @property
    def stride(self) -> int:
        """dense/gather: input frames per block."""
        return self.group * self.num

    @property
    def in_per_launch(self) -> int:
        """Input frames consumed per lane per launch."""
        if self.kernel in ("tiled", "streamed"):
            return (self.n_blocks // self.P) * self.S
        return self.n_blocks * self.stride

    @property
    def out_per_launch(self) -> int:
        """Output frames produced per lane per launch."""
        if self.kernel in ("tiled", "streamed"):
            return self.n_blocks * self.R
        return self.n_blocks * self.group * self.den


def _n_cols(spec: fd.FilterSpec) -> int:
    """Weight columns per output: 4 accumulator tap sets in the fixed
    interpolated universe, else 1."""
    return 4 if (spec.fixed_point and not spec.use_direct) else 1


def _itemsize(spec: fd.FilterSpec) -> int:
    """Bytes per phase-tiled weight: int16 taps (fixed) or f32."""
    return 2 if spec.fixed_point else 4


def _tiled_weight_bytes_estimate(spec: fd.FilterSpec, R: int = 128) -> int:
    """Size of one phase-tiled weight set WITHOUT building it (the probe
    itself would allocate GBs for pathological coprime ratios)."""
    g = math.gcd(R * spec.num, spec.den)
    P0 = spec.den // g
    S0 = P0 * R * spec.num // spec.den
    factor = 16 // math.gcd(max(S0, 1), 16)
    P = P0 * factor
    K = spec.filt_len + (R - 1) * spec.num // spec.den + 32
    return P * K * R * _itemsize(spec)


def _dense_weight_bytes(spec: fd.FilterSpec) -> int:
    """Size of the dense padded weights at the uncapped group (the JAX
    package's estimate: 2 bytes per entry in the fixed universe, whatever
    its column sets)."""
    group = fm.choose_group(spec.num, spec.den, spec.filt_len)
    L = spec.filt_len + group * spec.num
    return L * group * spec.den * _itemsize(spec)


_MAX_GATHER_OUT_FRAMES = 1 << 22


def _gather_blocks(spec: fd.FilterSpec, target_in_frames: int,
                   hard_cap: bool = False) -> int:
    """Gather-geometry block count (one block = num inputs -> den
    outputs), at most ~4 M output frames per launch; ``hard_cap`` floors
    instead of rounding (a max_latency_ms budget is a ceiling)."""
    max_blocks = max(1, _MAX_GATHER_OUT_FRAMES // spec.den)
    want = (target_in_frames // spec.num if hard_cap
            else round(target_in_frames / spec.num))
    return max(1, min(want, max_blocks))


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


_FLOAT_SCHEMES = ("auto", "int8", "split5", "highest")


def _resolve_scheme(w_cert: np.ndarray, scheme: str):
    """Returns (scheme, int8p, scales): "auto" -> int8 when the
    digit-escalating certificate clears the gate, else split5 (as in the
    JAX package); an explicit "int8" request is refused past the hard
    cap."""
    if scheme not in _FLOAT_SCHEMES:
        raise ResamplerError(ResamplerErrorCode.INVALID_ARG)
    int8p = None
    if scheme == "auto":
        int8p = tf.int8_weights_auto(w_cert, _INT8_CERT_GATE)
        scheme = "int8" if int8p is not None else "split5"
    scales = ()
    if scheme == "int8":
        if int8p is None:
            int8p = tf.int8_weights_auto(w_cert, _INT8_CERT_MAX)
            if int8p is None:
                raise ResamplerError(ResamplerErrorCode.INVALID_ARG)
        scales = int8p[2]
    return scheme, int8p, scales


@span("speex.step.hist")
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
    budget of the universe (all n_cols column sets counted; the JAX
    package's rule, kept for identical geometry)."""
    budget = (_MAX_FIXED_TILED_WEIGHT_BYTES if spec.fixed_point
              else _MAX_TILED_WEIGHT_BYTES)
    R = 128
    while R < 512 and (R * spec.num) // spec.den < 96:
        R2 = R * 2
        g = math.gcd(R2 * spec.num, spec.den)
        S0 = R2 * spec.num // g                   # per P0 = den/g blocks
        P = (spec.den // g) * (16 // math.gcd(S0, 16))
        K_est = (-(-(R2 * spec.num) // spec.den)) + spec.filt_len + 16
        if _itemsize(spec) * P * K_est * R2 * _n_cols(spec) > budget // 2:
            break
        R = R2
    return R


def _tiled_weights(spec: fd.FilterSpec, f0: int = 0, component: int = 0):
    """Phase-tiled weight tables, cached ON the spec by (f0, component), at
    most 4 entries (a flush rebuilds at a handful of phases; one fixed
    interpolated f0 fills the cache with its 4 components).  ``component``
    picks the accumulator tap set ``interp_taps[:, c, :]`` of a fixed
    interpolated spec; every component has the same geometry.
    design_filter is lru_cache'd, so the spec is shared across engines and
    the cache serializes on the spec's own lock."""
    with fd._spec_lock(spec):
        cache = getattr(spec, "_ptw_cache", None)
        if cache is None:
            cache = {}
            object.__setattr__(spec, "_ptw_cache", cache)
        key = (f0, component)
        if key not in cache:
            if len(cache) >= 4:
                cache.pop(next(iter(cache)))
            H = _hist_rows_tiled(spec.filt_len)
            pt = (spec.interp_taps[:, component, :] if _n_cols(spec) == 4
                  else spec.phase_table)
            cache[key] = ph.build_phase_tiled_weights(
                pt, spec.num, spec.den, f0, R=_tiled_R(spec),
                origin_shift=H - (spec.filt_len - 1))
        return cache[key]


def _fixed_coef(spec: fd.FilterSpec, f0: int, P: int, R: int) -> np.ndarray:
    """Per-block-phase Q15 cubic coefficients of the fixed interpolated
    kernels: int32 [P, 4, R], coef[m] for blocks with k % P == m (phases
    repeat with period P because P*R*num = 0 mod den by construction)."""
    r = np.arange(R, dtype=np.int64)
    coef = np.empty((P, 4, R), dtype=np.int32)
    for m in range(P):
        ph_idx = (f0 + (m * R + r) * spec.num) % spec.den
        coef[m] = spec.interp_coef[ph_idx].T
    return coef


@span("speex.setup.q15")
def _fixed_host_weights(spec: fd.FilterSpec, f0: int, K_pad: int) -> tuple:
    """The fixed scheme's host weights: ``(w int16[P, K_pad, C],)`` for a
    direct spec, ``(w, coef int32[P, 4, R])`` for an interpolated one, with
    the n_cols component sets side by side (column c*R + r) and each padded
    with zero tap rows to K_pad.  Each component is built once here.  The
    span ``speex.setup.q15`` (inside ``speex.setup.planes``); its split
    into int8 planes is the same span inside ``speex.setup.upload``
    (``tiled_fir.fixed_device_weights``)."""
    ptw = _tiled_weights(spec, f0)
    comps = [ptw]
    for c in range(1, _n_cols(spec)):
        pc = _tiled_weights(spec, f0, component=c)
        assert pc.offsets.tolist() == ptw.offsets.tolist()
        comps.append(pc)
    w = np.concatenate([np.pad(pc.w, ((0, 0), (0, K_pad - ptw.K), (0, 0)))
                        for pc in comps], axis=2)
    if len(comps) == 1:
        return (w,)
    return (w, _fixed_coef(spec, f0, ptw.P, ptw.R))


@dataclasses.dataclass(frozen=True)
class BatchedStep:
    """Steady-state step + its launch buffer contract.

    fn(hist i16[hist_rows, B], x i16[T, B], w)
        -> (hist' i16[hist_rows, B], y i16[out_per_launch, B])
    x has in_per_launch rows or more (T >= in_per_launch): rows [0,
    in_per_launch) are the chunk; those of rows [in_per_launch,
    in_per_launch + zero_tail) that x has must be zero; any further rows
    are don't-care padding; rows past x's end read as zero.  So the bare
    chunk (T = in_per_launch) is a whole launch, and a reused launch
    buffer of ``chunk_rows`` rows with its zeros is too.  ``w`` is the
    launch's device weights;
    ``kernel`` names the geometry and so what the step launches,
    ``kernel_kw`` the remaining arguments of its launch:
    ``sf.resample_streamed(hist, x, w, **kernel_kw)`` for "tiled" and
    "streamed",
    ``df.resample_dense(hist, x, w, **kernel_kw)`` for a float "dense"
    step, ``df.resample_dense_fixed(hist, x, w, **kernel_kw)`` for a fixed
    one, and ``fm.resample_gather[_fixed](x[:in_per_launch].t(), *w,
    hist=hist.t(), **kernel_kw)`` for a "gather" step (``kernel_kw`` holds
    its ``GatherPlan``, None on the CPU).

    Over a lane mesh (``mesh``, the shards' devices) ``fn`` takes and
    returns lists, one tensor a shard: ``fn(hists, xs, w) -> (hists',
    ys)``, each shard's [rows, B / len(mesh)] (lane-major: [B /
    len(mesh), rows]) on its device, and ``w`` the shards' weights
    (shards on one device share them); ``kernel_kw`` is the first
    shard's.
    """
    fn: object
    w: tuple
    hist_rows: int
    chunk_rows: int
    zero_tail: int
    scheme: str = "highest"   # resolved precision scheme
    kernel_kw: dict = dataclasses.field(default_factory=dict)
    kernel: str = "tiled"
    mesh: tuple = ()


def _launch_geometry(spec: fd.FilterSpec, target_in_frames: int,
                     f0: int = 0,
                     max_in_frames: int | None = None) -> BatchSpec:
    """Static launch geometry.  ``max_in_frames`` is a HARD cap on the
    launch quantum (the engine's availability latency): a geometry whose
    rounding overflows it is re-quantized within its family (units of
    S * periods-per-program frames for tiled, of S for streamed, floored
    block counts for gather) or dropped to a dense geometry whose group
    factor shrinks to fit; a dense geometry whose padded weights would pass
    the dense cap at that group goes to gather instead.  Raises INVALID_ARG
    when even one period (num frames) exceeds the cap."""
    if max_in_frames is None:
        return _launch_geometry_impl(spec, target_in_frames, f0)
    if spec.num > max_in_frames:
        raise ResamplerError(ResamplerErrorCode.INVALID_ARG)
    bspec = _launch_geometry_impl(spec, min(target_in_frames, max_in_frames),
                                  f0)
    if bspec.in_per_launch <= max_in_frames:
        return bspec
    if bspec.kernel in ("tiled", "streamed"):
        unit = bspec.S * _periods_per_unit(bspec.kernel, bspec.P)
        if unit <= max_in_frames:
            b2 = _launch_geometry_impl(spec, (max_in_frames // unit) * unit,
                                       f0)
            if b2.in_per_launch <= max_in_frames:
                return b2
    gather = dataclasses.replace(
        bspec, kernel="gather", group=1, S=0, P=0, R=0,
        n_blocks=_gather_blocks(spec, max_in_frames, hard_cap=True))
    if bspec.kernel == "gather":
        return gather
    group = min(fm.choose_group(spec.num, spec.den, spec.filt_len),
                max(1, max_in_frames // spec.num))
    stride = group * spec.num
    if ((spec.filt_len + stride) * group * spec.den * _itemsize(spec)
            > fm.MAX_PADDED_WEIGHT_BYTES):
        return gather
    return BatchSpec(num=spec.num, den=spec.den, quality=spec.quality,
                     filt_len=spec.filt_len, group=group,
                     n_blocks=max(1, max_in_frames // stride), f0=f0,
                     kernel="dense")


def _periods_per_unit(kernel: str, P: int) -> int:
    """Launch-quantum unit in weight periods: the tiled kernel's programs
    (_v3_periods_per_program), one period for the streamed kernel."""
    return _v3_periods_per_program(P) if kernel == "tiled" else 1


def _launch_geometry_impl(spec: fd.FilterSpec, target_in_frames: int,
                          f0: int) -> BatchSpec:
    """Tiled while the weights (all n_cols column sets) fit the universe's
    tiled cap, streamed up to 256 MB; else gather when the dense padded
    weights would pass 32 MB (huge den), else dense."""
    n_cols = _n_cols(spec)
    if _tiled_weight_bytes_estimate(spec) * n_cols \
            <= 2 * _MAX_STREAMED_WEIGHT_BYTES:
        ptw = _tiled_weights(spec, f0)
        nbytes = ptw.w.nbytes * n_cols
        tiled_max = (_MAX_FIXED_TILED_WEIGHT_BYTES if spec.fixed_point
                     else _MAX_TILED_WEIGHT_BYTES)
        if nbytes <= _MAX_STREAMED_WEIGHT_BYTES:
            kernel = "tiled" if nbytes <= tiled_max else "streamed"
            gp = _periods_per_unit(kernel, ptw.P)
            n_periods = max(gp, round(target_in_frames / (ptw.S * gp)) * gp)
            return BatchSpec(num=spec.num, den=spec.den,
                             quality=spec.quality, filt_len=spec.filt_len,
                             group=1, n_blocks=n_periods * ptw.P, f0=f0,
                             kernel=kernel, S=ptw.S, P=ptw.P, R=ptw.R)
    if _dense_weight_bytes(spec) > fm.MAX_PADDED_WEIGHT_BYTES:
        return BatchSpec(num=spec.num, den=spec.den, quality=spec.quality,
                         filt_len=spec.filt_len, group=1,
                         n_blocks=_gather_blocks(spec, target_in_frames),
                         f0=f0, kernel="gather")
    group = fm.choose_group(spec.num, spec.den, spec.filt_len)
    return BatchSpec(num=spec.num, den=spec.den, quality=spec.quality,
                     filt_len=spec.filt_len, group=group,
                     n_blocks=max(1, round(target_in_frames
                                           / (group * spec.num))),
                     f0=f0, kernel="dense")


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
    """Bytes of the step's tensors: its weights and those its launch takes
    in ``kernel_kw`` (a gather step's band)."""
    band = step.kernel_kw.get("band") or ()
    return sum(t.numel() * t.element_size() for t in (*step.w, *band)
               if isinstance(t, torch.Tensor))


def clear_step_cache() -> None:
    """Drop all memoized steps (frees their device weight arrays, once no
    engine holds the step)."""
    with _STEP_CACHE_LOCK:
        _STEP_CACHE.clear()


def make_batched_step(spec: fd.FilterSpec, bspec: BatchSpec, *,
                      device=DEFAULT_DEVICE, scheme: str = "auto",
                      lane_major: bool = False, mesh=None) -> BatchedStep:
    """Memoizing front-end for :func:`_build_batched_step`.

    ``lane_major=True`` is the serving layout of ``runtime/fleet.py``: the
    step takes ``x i16[B, chunk_rows]`` and returns ``y i16[B, out_rows]``
    (the host's gather and scatter then stay contiguous per stream), with
    both transposes plain torch on the step's device; ``hist`` stays
    time-major.

    ``mesh`` (a sequence of devices, in place of ``device``) gives the
    step over a lane mesh (:func:`_mesh_step`)."""
    if mesh is not None:
        return _mesh_step(spec, bspec, _placement(device, mesh), scheme,
                          lane_major)
    device = torch.device(device)
    key = (spec.num, spec.den, spec.quality, spec.fixed_point,
           spec.use_direct, spec.filt_len, spec.oversample, bspec, scheme,
           str(device), bool(lane_major))
    with _STEP_CACHE_LOCK:
        hit = _STEP_CACHE.get(key)
        if hit is not None:
            _STEP_CACHE.move_to_end(key)
            return hit
    # build outside the lock (duplicate builds of one key are benign)
    step = _build_batched_step(spec, bspec, device=device, scheme=scheme)
    if lane_major:
        step = _lane_major(step)
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


def _mesh_step(spec: fd.FilterSpec, bspec: BatchSpec, devices: tuple,
               scheme: str, lane_major: bool) -> BatchedStep:
    """The step over a lane mesh: one memoized step a distinct device
    (its weights uploaded once there), and an ``fn`` that launches each
    shard on its own device's current stream, with no copy between
    devices (lanes are share-nothing: no collective).  The wrapper itself
    is not memoized; building it costs no upload."""
    by_device = {d: make_batched_step(spec, bspec, device=d, scheme=scheme,
                                      lane_major=lane_major)
                 for d in dict.fromkeys(devices)}
    shards = [by_device[d] for d in devices]
    fns = [s.fn for s in shards]

    def fn(hists, xs, w):
        if not len(hists) == len(xs) == len(w) == len(fns):
            raise ValueError(f"{len(hists)} histories, {len(xs)} inputs and "
                             f"{len(w)} weights for a mesh of {len(fns)}")
        outs = [f(h, x, ws) for f, h, x, ws in zip(fns, hists, xs, w)]
        return [o[0] for o in outs], [o[1] for o in outs]

    return dataclasses.replace(shards[0], fn=fn,
                               w=tuple(s.w for s in shards), mesh=devices)


def _lane_major(step: BatchedStep) -> BatchedStep:
    """``step`` on lane-major buffers: x [B, chunk_rows] in, y [B, out]
    out, transposed on the step's device around the time-major step."""
    inner = step.fn

    def fn(hist, x_lm, w):
        h2, y = inner(hist, x_lm.t().contiguous(), w)
        return h2, y.t().contiguous()

    return dataclasses.replace(step, fn=fn)


def _build_batched_step(spec: fd.FilterSpec, bspec: BatchSpec, *,
                        device: torch.device,
                        scheme: str = "auto") -> BatchedStep:
    """Build the steady-state step of ``bspec``'s geometry.

    ``scheme`` (tiled and streamed): "int8" (certificate-gated digit
    planes), "split5" (five bf16 products), "highest" (exact f32), or
    "auto" = int8 when the worst-case certificate clears the gate, else
    split5 (see _resolve_scheme).  The float dense and gather steps run
    "highest" whatever the request, as in the JAX package (an unknown
    scheme still raises INVALID_ARG).  A fixed-point spec has one exact
    scheme, "fixed" ("auto" resolves it; any other request raises
    INVALID_ARG, as in the JAX package)."""
    if spec.fixed_point and scheme not in ("auto", "fixed"):
        raise ResamplerError(ResamplerErrorCode.INVALID_ARG)
    if not spec.fixed_point and scheme not in _FLOAT_SCHEMES:
        raise ResamplerError(ResamplerErrorCode.INVALID_ARG)
    if bspec.kernel == "dense":
        return _build_dense_step(spec, bspec, device=device)
    if bspec.kernel == "gather":
        return _build_gather_step(spec, bspec, device=device)
    return _build_phase_step(spec, bspec, device=device, scheme=scheme)


def _build_phase_step(spec: fd.FilterSpec, bspec: BatchSpec, *,
                      device: torch.device, scheme: str) -> BatchedStep:
    """The step of a phase-tiled geometry, "tiled" or "streamed" (the JAX
    package's two branches), launched by ``sf.resample_streamed``: the
    phase-tiled weights, a streamed step's padded to K_pad = round128(K)
    tap rows with the float scheme resolved on the padded set (so planes,
    scales and certificate equal the JAX package's); a tiled step's chunk
    of the JAX package's v3 views, a streamed one's of round16(n_in +
    K_pad) rows.  A CUDA tiled int8 step takes the resident kernel where
    its band fits (``sf.int8_launch_weights``)."""
    streamed = bspec.kernel == "streamed"
    with span("speex.setup.planes"):
        ptw = _tiled_weights(spec, bspec.f0)
        K = -(-ptw.K // 128) * 128 if streamed else ptw.K
        if spec.fixed_point:
            scheme, scales = "fixed", ()
            host_w = _fixed_host_weights(spec, bspec.f0, K)
        else:
            w_np = np.pad(ptw.w, ((0, 0), (0, K - ptw.K), (0, 0)))
            scheme, int8p, scales = _resolve_scheme(w_np, scheme)
            host_w = _float_host_weights(w_np, scheme, int8p)
    assert (ptw.S, ptw.P, ptw.R) == (bspec.S, bspec.P, bspec.R)
    N = spec.filt_len
    H = _hist_rows_tiled(N)
    n_in, n_out = bspec.in_per_launch, bspec.out_per_launch
    if streamed:
        chunk_rows = -(-(n_in + K) // 16) * 16
    else:
        V = (_v3_views(ptw.S, ptw.K, H, ptw.offsets)
             + _v3_periods_per_program(ptw.P) - 1)
        chunk_rows = (bspec.n_blocks // ptw.P - _v3_back(ptw.S, H)
                      + V) * ptw.S
    with span("speex.setup.upload"):
        w = (sf.device_weights_streamed if streamed
             else tf.device_weights)(host_w, scheme, device)
    if scheme == "int8" and not streamed and device.type == "cuda":
        w = sf.int8_launch_weights(w)
    kernel_kw = dict(n_blocks=bspec.n_blocks, shift=H - (N - 1),
                     num=spec.num, den=spec.den, f0=bspec.f0, scheme=scheme,
                     scales=scales, n_accum=_n_cols(spec))

    def step(hist, x, w):
        y = sf.resample_streamed(hist, x, w, **kernel_kw)
        return _next_hist(hist, x, n_in, H), y[:n_out]

    return BatchedStep(fn=step, w=w, hist_rows=H, chunk_rows=chunk_rows,
                       zero_tail=K, scheme=scheme, kernel_kw=kernel_kw,
                       kernel=bspec.kernel)


def _float_host_weights(w_np: np.ndarray, scheme: str, int8p):
    """The host weights of a resolved float scheme on the phase-tiled
    weights ``w_np`` (tiled_fir.device_weights' input)."""
    if scheme == "int8":
        return int8p[0], int8p[1]
    if scheme == "split5":
        return tf.split5_weights(w_np)
    return w_np


def _padded_weights(spec: fd.FilterSpec, bspec: BatchSpec) -> tuple:
    """The dense geometry's padded weights, zero rows up to L_pad (a
    multiple of stride): ``(w [L_pad, C], n_accum)``.  f32 [L_pad, R] in
    the float universe; int16 taps in the fixed one, with the 4
    accumulator column sets of an interpolated filter side by side
    (column c*R + r, as the tiled fixed weights; the JAX package orders
    them r*4 + c)."""
    tables = ([spec.interp_taps[:, c, :] for c in range(4)]
              if _n_cols(spec) == 4 else [spec.phase_table])
    w = np.concatenate([ph.build_padded_weights(t, spec.num, spec.den,
                                                bspec.f0, bspec.group)
                        for t in tables], axis=1)
    L_pad = -(-w.shape[0] // bspec.stride) * bspec.stride
    return np.pad(w, ((0, L_pad - w.shape[0]), (0, 0))), len(tables)


@span("speex.setup.q15")
def _fixed_dense_host_weights(spec: fd.FilterSpec, bspec: BatchSpec) -> tuple:
    """The fixed dense step's host weights: ``_padded_weights``' int16
    taps, n_accum, and for an interpolated filter the Q15 cubic
    coefficients int32[4, R] (else None).  The span ``speex.setup.q15``,
    as :func:`_fixed_host_weights`."""
    w_np, n_accum = _padded_weights(spec, bspec)
    coef = None
    if n_accum == 4:
        bc = ph.block_constants(spec.num, spec.den, bspec.f0, bspec.group)
        coef = spec.interp_coef[bc.p].T
    return w_np, n_accum, coef


def _build_dense_step(spec: fd.FilterSpec, bspec: BatchSpec, *,
                      device: torch.device) -> BatchedStep:
    """The dense geometry's step (the JAX package's branch): history of
    filt_len-1 rows, a chunk of exactly n_in rows, and the launch reads
    the virtual axis hist ++ x ++ zeros from block origins b*stride.
    Float: the K3 kernel (``df.resample_dense``).  Fixed: its int8
    tensor-core twin (``df.resample_dense_fixed``), with the Q15 cubic
    coefficients int32[4, R] of an interpolated filter."""
    N, stride = spec.filt_len, bspec.stride
    n_in, n_out = bspec.in_per_launch, bspec.out_per_launch
    with span("speex.setup.planes"):
        if spec.fixed_point:
            w_np, n_accum, coef = _fixed_dense_host_weights(spec, bspec)
        else:
            w_np, n_accum = _padded_weights(spec, bspec)
    if not spec.fixed_point:
        with span("speex.setup.upload"):
            w = df.device_weights(w_np, device)
        kernel_kw = dict(stride=stride, n_blocks=bspec.n_blocks,
                         R=w_np.shape[1])

        def step(hist, x, w):
            y = df.resample_dense(hist, x, w, **kernel_kw)
            return _next_hist(hist, x, n_in, N - 1), y[:n_out]

        return BatchedStep(fn=step, w=w, hist_rows=N - 1, chunk_rows=n_in,
                           zero_tail=0, scheme="highest", kernel_kw=kernel_kw,
                           kernel="dense")
    with span("speex.setup.upload"):
        w = df.device_weights_fixed(w_np, coef, device)
    kernel_kw = dict(stride=stride, n_blocks=bspec.n_blocks,
                     R=w_np.shape[1] // n_accum, n_accum=n_accum)

    def step(hist, x, w):
        y = df.resample_dense_fixed(hist, x, w, **kernel_kw)
        return _next_hist(hist, x, n_in, N - 1), y[:n_out]

    return BatchedStep(fn=step, w=w, hist_rows=N - 1, chunk_rows=n_in,
                       zero_tail=0, scheme="fixed", kernel_kw=kernel_kw,
                       kernel="dense")


def _gather_starts(spec: fd.FilterSpec, bspec: BatchSpec) -> tuple:
    """(window starts int32, phases int64) of a gather launch's outputs:
    output k's time f0 + k * num, its window start clamped in range."""
    t = bspec.f0 + np.arange(bspec.out_per_launch, dtype=np.int64) * spec.num
    starts = np.minimum(t // spec.den, max(bspec.in_per_launch - 1, 0))
    return starts.astype(np.int32), t % spec.den


def _gather_plan(spec: fd.FilterSpec, starts: np.ndarray) -> fm.GatherPlan:
    """The CTA geometry a CUDA gather step takes for these starts
    (``fm.gather_plan``; the fixed kernels' accumulator rows an output)."""
    return fm.gather_plan(starts, spec.filt_len, n_accum=_n_cols(spec)
                          if spec.fixed_point else None)


def _build_gather_step(spec: fd.FilterSpec, bspec: BatchSpec, *,
                       device: torch.device) -> BatchedStep:
    """The gather geometry's step (the JAX package's branch): the taps of
    each of the launch's n_out outputs are gathered by phase on the host
    once per step (window starts clamped in range); a launch is the
    gather kernel (``fm.resample_gather``, or ``resample_gather_fixed``
    with int16 taps and, for an interpolated filter, int32[n_out, 4] cubic
    coefficients) over ``hist ++ x``, each read in place.  A CUDA step's
    CTA geometry (``fm.gather_plan`` of the starts: the band form where
    the outputs' band fits a CTA, else the stream form) and, for both, its
    band (``fm.gather_band`` of the same host taps) are made here, in
    ``kernel_kw``; a CPU step runs the plain version and has neither."""
    N, n_in = spec.filt_len, bspec.in_per_launch
    cuda = torch.device(device).type == "cuda"
    with span("speex.setup.planes"):
        starts, phases = _gather_starts(spec, bspec)
        if _n_cols(spec) == 4:
            taps, coef = spec.interp_rows(phases)
            host_w = (taps, starts, coef.astype(np.int32))
        else:
            host_w = (spec.phase_rows(phases), starts)
        plan = _gather_plan(spec, starts) if cuda else None
    launch, scheme = ((fm.resample_gather_fixed, "fixed") if spec.fixed_point
                      else (fm.resample_gather, "highest"))
    with span("speex.setup.upload"):
        w = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                  for a in host_w)
        band = (fm.gather_band(host_w[0], starts, plan, device)
                if cuda and plan.form != "rows" else None)
    kernel_kw = dict(plan=plan, band=band)

    def step(hist, x, w):
        y = launch(x[:n_in].t(), *w, hist=hist.t(), **kernel_kw)
        return _next_hist(hist, x, n_in, N - 1), y.t()

    return BatchedStep(fn=step, w=w, hist_rows=N - 1, chunk_rows=n_in,
                       zero_tail=0, scheme=scheme, kernel_kw=kernel_kw,
                       kernel="gather")


def weights_from_jax(w, scheme: str, device="cuda",
                     kernel: str = "tiled", n_out: int | None = None) -> tuple:
    """A JAX ``BatchedStep.w`` converted to numpy -> this package's device
    weights for the same step.  ``kernel`` is the step's geometry, which
    the arrays alone cannot tell:

    - "tiled": an f32 [P, K, R] array for "highest", the
      ``(planes int8[D, P, K, R], bias)`` tuple for "int8" (laid out
      K-major and permuted here, K padded to a multiple of 32:
      ``tiled_fir.device_weights``, with its slice count; a CUDA step
      whose band is past the resident kernel's carries its band widths
      instead, ``streamed_fir.int8_launch_weights``);
    - "streamed": f32 [P, R, K_pad] for "highest",
      ``(planes int8[P, D, R, K_pad], bias)`` for "int8"; transposed here to
      the port's [P, K_pad, R]; for "int8" P and D are swapped to the
      port's K-major [D, P, R, K_pad] and each 32-tap group permuted
      (``tiled_fir.int8_k_major``);
    - "split5": bf16 [3, P, K, R] (tiled) or [P, 3, R, K_pad] (streamed),
      read as bit patterns (numpy holds JAX's bf16 as ``ml_dtypes``);
    - "fixed", tiled or streamed: ``(planes int8[2, P, C, K], bias
      int32[P, C][, coef int32[P, 4, R]])`` (tiled) or planes int8[P, 2, C,
      K_pad] (streamed).  The bias is checked to be ``128 * sum_K w`` of
      the int16 taps ``256*wh + wl0``, which then take the port's own
      conversion (``tiled_fir.fixed_device_weights``: the same split, K
      padded to a multiple of 32, each 32-tap group permuted);
    - "dense": f32 [L_pad, R] for "highest" (padded here to the port's
      R_pad columns); for "fixed" ``(wh int8[L_pad,
      C], wl0, bias int32[C][, coef int32[R, 4]])`` with columns c-minor
      (``r*4 + c``): rebuilt as int16 taps, the bias checked, the columns
      reordered accumulator-major and coef transposed to [4, R], then the
      kernel's planes built from them (``dense_fir.device_weights_fixed``);
    - "gather": its arrays ``(taps, starts[, coef])``, padded by the JAX
      package to its 2048-output tile, cut to the launch's ``n_out``
      outputs (required)."""
    device = torch.device(device)
    if kernel not in ("tiled", "streamed", "dense", "gather"):
        raise ValueError(f"unknown geometry {kernel!r}")
    if kernel == "gather":
        if n_out is None:
            raise ValueError("a gather step's weights need n_out")
        return tuple(torch.from_numpy(np.array(a[:n_out])).to(device)
                     for a in w)
    if kernel == "dense":
        if scheme != "fixed":
            return df.device_weights(np.asarray(w), device)
        wh, wl0, bias, *coef = (np.asarray(a) for a in w)
        w16 = _taps_from_planes(wh, wl0, bias, tap_axis=0)
        if coef:
            L, C = w16.shape
            w16 = w16.reshape(L, C // 4, 4).transpose(0, 2, 1).reshape(L, C)
        return df.device_weights_fixed(w16, coef[0].T if coef else None,
                                       device)
    if scheme == "split5":
        planes = np.asarray(w)
        if kernel == "streamed":
            planes = planes.transpose(1, 0, 3, 2)
        bits = torch.from_numpy(np.array(planes).view(np.int16))
        return tf.device_weights(bits.view(torch.bfloat16), scheme, device)
    if scheme == "fixed":
        planes, bias, *coef = (np.asarray(a) for a in w)
        if kernel == "streamed":
            planes = planes.transpose(1, 0, 2, 3)
        w16 = _taps_from_planes(planes[0], planes[1], bias, tap_axis=2)
        w16 = np.ascontiguousarray(w16.transpose(0, 2, 1))
        return tf.device_weights((w16, *coef), scheme, device)
    if kernel == "tiled":
        return tf.device_weights(w, scheme, device)
    if scheme == "highest":
        w = np.ascontiguousarray(np.asarray(w).transpose(0, 2, 1))
    elif scheme == "int8":
        planes, bias = w
        return sf.device_weights_streamed(
            (np.asarray(planes).swapaxes(0, 1), bias), scheme, device,
            k_major=True)                                   # [D, P, R, K]
    return sf.device_weights_streamed(w, scheme, device)


def _taps_from_planes(wh, wl0, bias, tap_axis: int) -> np.ndarray:
    """int16 taps ``256*wh + wl0`` from the JAX package's balanced int8
    planes; raises ValueError unless ``bias`` is ``128 * sum`` of the taps
    over ``tap_axis``."""
    w16 = 256 * wh.astype(np.int32) + wl0.astype(np.int32)
    if not np.array_equal(w16.sum(axis=tap_axis, dtype=np.int32) << 7, bias):
        raise ValueError("fixed bias is not 128 * sum of the taps")
    return w16.astype(np.int16)


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


class _Slab:
    """One persistent launch slab.  On the CPU ``host`` is a NumPy array
    the step reads in place.  On CUDA ``host`` is the NumPy view of a
    pinned host tensor with a persistent device twin: the upload is
    asynchronous (``copy_(non_blocking=True)``), so the host may refill the
    slab only after the event of its last upload, which :meth:`fill` waits
    for."""

    def __init__(self, shape: tuple, device: torch.device):
        self.dev = self._pinned = self._uploaded = self._released = None
        if device.type == "cuda":
            self._pinned = torch.zeros(shape, dtype=torch.int16,
                                       pin_memory=True)
            self.host = self._pinned.numpy()
            self.dev = torch.zeros(shape, dtype=torch.int16, device=device)
        else:
            self.host = np.zeros(shape, dtype=np.int16)

    def fill(self) -> np.ndarray:
        """The host array, writable once its last upload has ended."""
        if self._uploaded is not None:
            self._uploaded.synchronize()
            self._uploaded = None
        return self.host

    def upload(self, stream: torch.cuda.Stream | None = None
               ) -> torch.Tensor:
        """The slab as the step's input tensor.  On CUDA the copy runs on
        ``stream`` (default: the current stream), after the launch that
        last read the device twin (:meth:`release`); the current stream
        then waits for the copy."""
        if self.dev is None:
            return torch.from_numpy(self.host)
        compute = torch.cuda.current_stream(self.dev.device)
        stream = compute if stream is None else stream
        if stream is not compute:
            if self._released is not None:
                stream.wait_event(self._released)
            self.dev.record_stream(stream)
        with torch.cuda.stream(stream):
            self.dev.copy_(self._pinned, non_blocking=True)
            self._uploaded = torch.cuda.Event()
            self._uploaded.record(stream)
        if stream is not compute:
            compute.wait_event(self._uploaded)
        return self.dev

    def release(self) -> None:
        """Mark the device twin free once the work queued so far on the
        current stream (the launch that reads it) has run."""
        if self.dev is not None:
            self._released = torch.cuda.Event()
            self._released.record()


class _MeshSlab:
    """A launch slab over a lane mesh: ``host`` is the whole [rows, B]
    host array that ``process`` fills, and :meth:`upload` copies each
    shard's columns into the shard's own :class:`_Slab` (pinned on CUDA)
    and returns the shards' input tensors: one host copy more than an
    unmeshed launch, which fills its pinned slab in place."""

    def __init__(self, rows: int, cols: list, devices: tuple):
        self.host = np.zeros((rows, cols[-1][1]), dtype=np.int16)
        self._cols = cols
        self._shards = [_Slab((rows, hi - lo), d)
                        for (lo, hi), d in zip(cols, devices)]

    def fill(self) -> np.ndarray:
        """The host array (each shard's upload copied out of it)."""
        return self.host

    def upload(self) -> list:
        """Each shard's columns on its device, on its current stream."""
        out = []
        for (lo, hi), slab in zip(self._cols, self._shards):
            slab.fill()[:] = self.host[:, lo:hi]
            out.append(slab.upload())
        return out


class BatchedResampler(ZeroFillDegradation):
    """Resample S identical-config streams (C channels each) in lockstep.

    Same semantics as the JAX package's ``BatchedResampler`` for
    ``process``/``flush``/``skip_zeros``/``reset_mem``/``state_dict``: each
    lane's output equals the reference's for that lane's samples within 1
    LSB (bit for bit with ``fixed_point=True``), and a checkpoint from
    either engine loads in the other (a snapshot of the other universe is
    refused).

    Parameters
    ----------
    n_streams, channels : lane geometry; B = n_streams * channels.
    target_chunk_frames : desired input frames per lane per launch; rounded
        to the launch quantum.
    device : "cuda" (the kernel; raises when no CUDA device exists) or
        "cpu" (the kernel's plain PyTorch version).  Unused with ``mesh``.
    scheme : "auto", "int8", "split5" or "highest"; "auto" or "fixed"
        with ``fixed_point``.
    fixed_point : serve the Q15 fixed-point universe (the speexdsp
        ``-DFIXED_POINT`` build), bit-exact.
    mesh : a sequence of devices (``torch.device`` or strings; one may
        repeat), in place of ``device``: the B lanes split into
        ``len(mesh)`` equal contiguous shards, each with its own history
        and slab pair, launched on its own device (the JAX package's
        ``shard_map`` over the lane axis).  B not divisible by the shard
        count, or ``device`` passed too, raises INVALID_ARG.  Checkpoints
        hold the joined history (the JAX format), so they load into an
        engine with or without a mesh; ``launches`` grows by ``len(mesh)``
        a launch, and a fault on any shard degrades the whole engine.
    max_latency_ms : hard cap on the launch quantum (a cap below one
        tiled or streamed unit serves through the dense geometry).

    ``process`` runs a depth-1 dispatch pipeline over two slabs: launch
    i+1 is queued before launch i is read back.  On CUDA the slabs are
    pinned and uploaded asynchronously, and each result is read back into
    pinned memory on a copy stream.  A launch or readback error degrades
    the engine to zero-fill output with exact sample counts
    (``utils/degrade.py``: ``degraded``, ``degraded_cause``,
    ``degraded_launches``, a logged error and a ``RuntimeWarning``); a
    kernel build failure raises out of the constructor.
    """

    def __init__(self, n_streams: int, channels: int, in_rate: int,
                 out_rate: int, quality: int = 7, *,
                 target_chunk_frames: int = 4096,
                 device=DEFAULT_DEVICE,
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
        devices = _placement(device, mesh)
        for d in dict.fromkeys(devices):
            _serving_device(d)
        #: the engine's device (None under a mesh: see ``mesh``)
        self.device = devices[0] if mesh is None else None
        #: the lane shards' devices (None without a mesh)
        self.mesh = devices if mesh is not None else None
        self.n_streams = n_streams
        self.channels = channels
        self.in_rate = in_rate
        self.out_rate = out_rate
        self.fixed_point = bool(fixed_point)
        g = math.gcd(in_rate, out_rate)
        try:
            with span("speex.setup.design"):
                self.spec = fd.design_filter(in_rate // g, out_rate // g,
                                             quality,
                                             fixed_point=fixed_point)
        except fd.OverflowArgError:
            raise ResamplerError(ResamplerErrorCode.OVERFLOW)
        self.B = n_streams * channels
        self._cols = (shard_columns(self.B, len(devices)) if self.mesh
                      else None)
        self._target = target_chunk_frames
        self._max_in = (None if max_latency_ms is None
                        else int(max_latency_ms * in_rate / 1000))
        self._scheme = scheme
        self._f0 = 0
        #: kernel launches made by this engine (one a shard under a mesh)
        self.launches = 0
        # zero-fill degradation (resample.c:561-591, :785-791): a device
        # failure swaps the engine onto a host zero-output step that keeps
        # consuming/producing the exact sample counts.  Sticky.
        self._degraded = False
        # results are read back on their own stream (one a CUDA device,
        # listed a shard), beside the next launch
        streams: dict = {}
        for d in devices:
            if d.type == "cuda" and d not in streams:
                streams[d] = torch.cuda.Stream(d)
        self._copy_streams = [streams.get(d) for d in devices]
        # steps keyed by f0 (a flush may move the phase; keep a few)
        self._step_cache: dict = {}
        self._build_step(0)
        self._hist = self._to_device(
            np.zeros((self._step.hist_rows, self.B), dtype=np.int16))
        self._skip = 0
        # staging FIFO of not-yet-launched input frames, [*, B] host int16
        self._staged = _HostFifo(self.B)
        # outputs banked by a partial drain, surfaced on the next
        # process()/flush()
        self._carry_out: list[np.ndarray] = []

    def _build_step(self, f0: int) -> None:
        """(Re)build the steady-state step at fractional phase ``f0``.  The
        launch quantum is f0-independent; only weights and origins change.
        A degraded engine only moves its phase (the zero-output step has
        no weights, and the device may be dead)."""
        if self._degraded:
            self._f0 = f0
            return
        cached = self._step_cache.get(f0)
        if cached is None:
            bspec = _launch_geometry(self.spec, self._target, f0=f0,
                                     max_in_frames=self._max_in)
            if self.mesh:
                step = make_batched_step(self.spec, bspec, mesh=self.mesh,
                                         scheme=self._scheme)
            else:
                step = make_batched_step(self.spec, bspec,
                                         device=self.device,
                                         scheme=self._scheme)
            # two persistent launch slabs for the depth-1 pipeline; rows
            # past the quantum stay zero (pop_into and _launch write only
            # [:in_per_launch])
            slabs = [_MeshSlab(step.chunk_rows, self._cols, self.mesh)
                     if self.mesh else
                     _Slab((step.chunk_rows, self.B), self.device)
                     for _ in range(2)]
            cached = (bspec, step, slabs)
            if len(self._step_cache) >= 4:
                self._step_cache.pop(next(iter(self._step_cache)))
            self._step_cache[f0] = cached
        self.bspec, self._step, self._slabs = cached
        self._slab_i = 0
        self._f0 = f0

    def _next_slab(self) -> _Slab:
        slab = self._slabs[self._slab_i]
        self._slab_i ^= 1
        slab.fill()
        return slab

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
        hist_host = self._hist_host()
        chunk = np.zeros((q, self.B), dtype=np.int16)
        chunk[:s] = staged
        _, y = self._launch(chunk)
        if m:
            self._carry_out.append(self._recv(y)[:m])
        hist_np = np.concatenate([hist_host, staged])[s:]
        self._hist = hist_np if self._degraded else self._to_device(hist_np)
        t = self._f0 + m * num
        self._skip = t // den - s     # pending origin advance, >= 0
        if t % den != self._f0:
            self._build_step(t % den)

    def skip_zeros(self):
        """Swallow the filter delay (resample.c:1200-1206), at ANY time,
        like the C API: setting ``last_sample = filt_len//2`` shifts the
        next window origin k = filt_len//2 ahead of the current stream
        position.  The engine first drains any sub-quantum staged
        remainder exactly (its outputs surface on the next
        process()/flush()), then feeds the next k input frames into the
        tail of the history instead of staging them (see ``process``)."""
        self._drain_partial()
        self._skip = self.spec.filt_len // 2

    def reset_mem(self):
        """resample.c:1208-1220.  Degradation survives a reset, like the C
        core (reset_mem never reinstalls the real resampler)."""
        if self._f0 != 0:
            self._build_step(0)
        hist = np.zeros((self._step.hist_rows, self.B), dtype=np.int16)
        self._hist = hist if self._degraded else self._to_device(hist)
        self._staged = _HostFifo(self.B)
        self._skip = 0
        self._carry_out = []

    # -- checkpoint/resume (the state IS a checkpoint) ---------------------

    def state_dict(self) -> dict:
        """The JAX engine's checkpoint format (host numpy arrays)."""
        return {
            "in_rate": self.in_rate, "out_rate": self.out_rate,
            "quality": self.spec.quality,
            "fixed_point": self.fixed_point,
            "n_streams": self.n_streams, "channels": self.channels,
            "hist": self._hist_host(),
            "staged": self._staged.peek_all(),
            "skip": self._skip,
            "f0": self._f0,
            "degraded": self._degraded,
            "carry_out": [o.copy() for o in self._carry_out],
        }

    def load_state_dict(self, state: dict):
        """Accepts this engine's or the JAX engine's ``state_dict()``; a
        degraded checkpoint degrades this engine (sticky)."""
        if (state["n_streams"], state["channels"]) != (self.n_streams,
                                                       self.channels) or \
                (state["in_rate"], state["out_rate"], state["quality"]) != \
                (self.in_rate, self.out_rate, self.spec.quality) or \
                state.get("fixed_point", False) != self.fixed_point:
            raise ResamplerError(ResamplerErrorCode.INVALID_ARG)
        if state.get("degraded", False):
            self._adopt_degraded()
        f0 = int(state.get("f0", 0))
        if f0 != self._f0:
            self._build_step(f0)
        hist_np = _adapt_hist(state["hist"], self._step.hist_rows,
                              self.spec.filt_len, self.B)
        self._hist = hist_np if self._degraded else self._to_device(hist_np)
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
            # origin advance left by a drain or skip_zeros)
            k = min(self._skip, x.shape[0])
            if self._degraded:
                self._hist = np.concatenate([self._hist[k:], x[:k]], axis=0)
            else:
                absorbed = self._to_device(np.ascontiguousarray(x[:k]))
                if self.mesh:
                    self._hist = [torch.cat([h[k:], a])
                                  for h, a in zip(self._hist, absorbed)]
                else:
                    self._hist = torch.cat([self._hist[k:], absorbed])
            x = x[k:]
            self._skip -= k
        # the 3-D frame layout was already copied by _to_lanes; hand the
        # FIFO ownership so only genuinely-aliasing 2-D views get the
        # defensive copy
        self._staged.push(x, owned=not np.may_share_memory(x, frames))
        outs, self._carry_out = self._carry_out, []
        q = self.bspec.in_per_launch
        pending = None
        while len(self._staged) >= q:
            # depth-1 dispatch pipeline: launch i+1 is queued before launch
            # i's result is read back (_recv blocks)
            slab = self._next_slab().host
            self._staged.pop_into(slab, q)  # straight into the slab
            self._hist, y = self._launch(slab)
            if pending is not None:
                outs.append(self._recv(pending))
            pending = y
        if pending is not None:
            outs.append(self._recv(pending))
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

    # -- zero-fill degradation: shared machinery in utils/degrade.py ------

    def _degraded_launch(self, chunk_np: np.ndarray):
        """Host zero-output launch with exact sample accounting
        (resampler_basic_zero, resample.c:561-591)."""
        return self._advance_degraded_hist(chunk_np), self._zero_result()

    def _launch(self, chunk_np: np.ndarray):
        """Queue one launch on ``chunk_np``: a slab's host array (as
        ``process`` fills it) or a bare [in_per_launch, B] chunk, copied
        into the next slab.  Returns (hist', result); the result is read
        with ``_recv``.  A failure degrades the engine."""
        if self._degraded:
            return self._degraded_launch(chunk_np)
        q = self.bspec.in_per_launch
        slab = self._slabs[self._slab_i ^ 1]     # the one _next_slab gave
        if chunk_np is not slab.host:
            assert chunk_np.shape[0] == q, chunk_np.shape
            slab = self._next_slab()
            slab.host[:q] = chunk_np
        try:
            x = slab.upload()
            self.launches += len(self.mesh) if self.mesh else 1
            hist, y = self._step.fn(self._hist, x, self._step.w)
            return hist, self._readback(y)
        except Exception as exc:
            self._enter_degraded(exc)
            return self._degraded_launch(chunk_np)

    def _readback(self, y):
        """CUDA: queue the copy of ``y`` into pinned memory on the copy
        stream (a ``Readback``); CPU: ``y`` itself.  Under a mesh, a list
        of those, one a shard, which ``_recv`` joins."""
        if not self.mesh:
            return _readback(y, self._copy_streams[0])
        return [_readback(t, s) for t, s in zip(y, self._copy_streams)]

    # -- layout helpers ---------------------------------------------------
    # lane l = stream*channels + channel; time-major [n, B] on device.

    def _to_device(self, a: np.ndarray):
        """The host [rows, B] array on the engine's device; under a mesh,
        split onto it (a list, one tensor a shard)."""
        if self.mesh:
            return split_lanes(torch.from_numpy(a), self.mesh)
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


def _readback(y: torch.Tensor, stream: torch.cuda.Stream | None):
    """``y`` read back into pinned memory on ``stream`` (a ``Readback``),
    or ``y`` itself where there is no copy stream (the CPU)."""
    if stream is None:
        return y
    out = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
    return Readback(to_host_into(y, out, stream), out.numpy())


def _serving_device(device) -> torch.device:
    """An engine's device: "cuda" (raises without a CUDA device; the kernel
    library is built here, so a build failure raises out of the engine's
    constructor and never reaches the degradation handler) or "cpu" (the
    kernels' plain versions)."""
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but no CUDA device is "
                               "available")
        _build.load()
    return device
