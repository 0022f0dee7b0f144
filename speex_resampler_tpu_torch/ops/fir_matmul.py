"""The JAX package's XLA-only launch ops: plain-torch twins, and the CUDA
kernels of the gather launch.

Counterpart of ``speex_resampler_tpu/ops/fir_matmul.py``.  The JAX package
runs these outside any ``pallas_call`` (XLA fuses each into one program):

- :func:`resample_conv`: ``ResamplerCore``'s device route, one f32 matmul
  of strided patches against the padded phase weights, in full FP32 (the
  JAX package's ``Precision.HIGHEST``) whatever the caller set for TF32;
  plain torch on every device, as the JAX package left it to XLA;
  :func:`resample_conv_tm` is its time-major twin;
- :func:`resample_conv_tm_fixed`: the fixed-point (Q15) dense product,
  exact, on the concatenated axis (the fixed dense step launches
  ``ops/dense_fir.resample_dense_fixed``, whose plain version this is);
- :func:`resample_gather` / :func:`resample_gather_fixed`: the weight-free
  gather launch of huge-denominator ratios (e.g. 44100 -> 44101), float
  and fixed.  For CUDA tensors they launch the kernels of
  ``csrc/gather_fir.cu`` on the current stream (or raise); for CPU tensors
  they run their plain versions, :func:`resample_gather_reference` and
  :func:`resample_gather_fixed_reference`.  Neither falls back to the
  other.  Their axis is ``hist ++ x``, hist optional: the batched step
  passes its history and chunk as they lie, and the kernel reads each in
  place.  A CUDA launch takes a :class:`GatherPlan` (:func:`gather_plan`,
  from the host's starts, made when a CUDA step is built) and, for the
  band and stream forms, its :class:`GatherBand` (:func:`gather_band`,
  built beside the plan).  The plan's form is a geometry: "rows" (float
  only: per-output dots on the CUDA cores; the outputs a CTA takes and
  the window rows it stages at once, so that they fit shared memory at
  any ratio), "band" (a group of consecutive outputs' taps as one dense band
  on the tensor cores, resident in shared memory, where their windows
  overlap densely) or "stream" (the same band streamed through shared
  memory a stage of taps at a time, where it is too wide to be resident:
  a steep decimation).  Nothing switches form at launch.

The float dense launch is a TPU kernel (K3) and lives in ``ops/dense_fir``.
Also here: the dense geometry's group factor and padded-weight cap, and
the JAX package's host helper :func:`fixed_weight_planes`.

Fixed weights are the int16 taps themselves (as in ``ops/tiled_fir``), not
the two int8 planes plus a bias that the JAX package builds for the MXU:
``w16 int16[L, C]`` with ``C = n_accum * R`` columns accumulator-major
(column ``c*R + r``), and the Q15 cubic coefficients ``coef int32[4, R]``
for the interpolated filter (``n_accum`` 4).  The plain versions' exact
integer dots are float64 matmuls (every int16 x int16 product is at most
2^30 and every partial sum an integer far below 2^53, so any order gives
the same number), wrapped to int32 as the C accumulator wraps.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..utils.profiling import count, span
from . import _build
from .convert import word2int
from .fixed_math import balanced_q15_split, fixed_interp_mix_rows, sat32pshr15
from .tiled_fir import _no_tf32, int8_k_major, wrap_int32

__all__ = ["MAX_PADDED_WEIGHT_BYTES", "choose_group", "resample_conv",
           "resample_conv_tm", "resample_conv_tm_fixed", "resample_gather",
           "resample_gather_fixed", "resample_gather_reference",
           "resample_gather_fixed_reference", "fixed_weight_planes",
           "GatherPlan", "gather_plan", "gather_plan_rows", "launch_key",
           "gather_plan_band", "gather_plan_stream", "GatherBand",
           "gather_band", "GATHER_SMEM_BYTES", "GATHER_BAND_SMEM_BYTES"]

#: Above this padded-weight size the engine takes the gather geometry.
MAX_PADDED_WEIGHT_BYTES = 32 * 1024 * 1024

_LANE_TARGET = 128   # output columns per block row the group widens toward

# float64 bytes of one plain gather tile's [tile, N, batch] window; the
# tile is chosen from N and the batch so that it stays under this at any
# batch, and holds at most the JAX package's 2048 outputs (each tile is a
# dozen small ops, so at 2048 lanes a larger window means fewer of them:
# 128 outputs a tile at N 128)
_GATHER_WINDOW_BYTES = 256 * 1024 * 1024
_GATHER_MAX_TILE = 2048

#: Shared memory a gather CTA may take (``kSmemMax`` of
#: ``csrc/gather_fir.cu``: two CTAs an SM), and its lanes (two a thread).
GATHER_SMEM_BYTES = 112 * 1024
GATHER_LANES = 64
# outputs a gather CTA may take (kO = M / 8 a warp), largest first
_GATHER_OUTPUTS = (64, 32, 16, 8)

#: The band form's shared memory ceiling (a CTA's most on the H100,
#: ``kMaxSmem`` of ``csrc/gather_fir.cu``).
GATHER_BAND_SMEM_BYTES = 232448
# band rows (outputs) a fixed group, by n_accum (fixedtc::Shape::kRows);
# the float band's outputs a warp tile and a CTA (four tiles)
_BAND_GROUP = {4: 32, 1: 64}
_F64_TILE = 16
_F64_OUTPUTS = 64
_F64_PITCH = GATHER_LANES + 8      # a staged x row, elements
_RAW_PITCH = GATHER_LANES * 2 + 16  # int8tc::kRawPitch, bytes
# the stream form's outputs a band tile (float: the 16-output warp tile;
# fixed: a warpgroup's fixedtc::Shape::kWgRows) and taps a stage (K is a
# whole number of stages), by n_accum (None: float)
_STREAM_GROUP = {None: 16, 4: 16, 1: 32}
_STREAM_TAPS = {None: 32, 4: 64, 1: 64}
# a streamed CTA's ring stages by n_accum and, fixed, its 64-lane tiles
# (one a warpgroup); the float CTA's lanes
_STREAM_RING = {None: 4, 4: 6, 1: 6}
_STREAM_WGS = 2
_F64_STREAM_LANES = 256

#: Launches of the gather kernels in this process, by kernel: the float
#: rows form's under "highest", the band and stream forms' under
#: :func:`launch_key`; only the wrappers add to them, once per launch.
#: Callers reset the counts to count one run.
launches = {"highest": 0, "highest_band": 0, "fixed_band": 0,
            "highest_stream": 0, "fixed_stream": 0}
#: the port's counters (``utils/profiling.count``) of the band and stream
#: launches, float and fixed: 1 a launch, the CTAs it launched (its grid),
#: the CTAs the card holds at once for it (the multiprocessors times the
#: kernel's occupancy at the launch's shared memory, at most the grid) and
#: its (output tile, 64-lane tile) units (:func:`gather_tiles`): tiles over
#: resident CTAs is the tiles a resident CTA walked
GATHER_LAUNCHES = "speex.kernel.gather.launches"
GATHER_CTAS = "speex.kernel.gather.ctas"
GATHER_RESIDENT = "speex.kernel.gather.resident"
GATHER_TILES = "speex.kernel.gather.tiles"

#: The library whose shared-memory ceiling this module has checked.
_checked = None


def choose_group(num: int, den: int, filt_len: int) -> int:
    """The dense super-block group factor G (R = G*den output columns):
    widens small-den configs toward 128 columns while G*num <= 2*filt_len
    (the JAX package's rule)."""
    if den >= _LANE_TARGET:
        return 1
    g = -(-_LANE_TARGET // den)
    while g > 1 and g * num > 2 * filt_len:
        g -= 1
    return max(g, 1)


def dense_patches(x: torch.Tensor, L: int, stride: int) -> torch.Tensor:
    """[n_blocks, L, B] view: block b is rows b*stride .. b*stride+L-1 of
    the time-major x int16[T, B] (T % stride == 0, L % stride == 0,
    n_blocks = T // stride - L // stride)."""
    T, B = x.shape
    assert T % stride == 0 and L % stride == 0, (T, L, stride)
    n_blocks = T // stride - L // stride
    assert n_blocks >= 1, (T, L, stride)
    return x.unfold(0, L, stride)[:n_blocks].transpose(1, 2)


def resample_conv(x: torch.Tensor, w: torch.Tensor, *, stride: int,
                  raw: bool = False) -> torch.Tensor:
    """One launch of the single-stream device route: strided patches times
    the padded phase weights.

    x: f32 (or int16) [batch, T]  history ++ chunk ++ zero pad, where
                                  T = n_blocks * stride + L
    w: f32 [L, R]                 padded phase weights, L % stride == 0
    returns int16 [batch, n_blocks * R] through WORD2INT, or the raw f32
    sums (the float-sample API, no WORD2INT) when ``raw``; callers slice
    off the masked tail outputs.

    Patch b is x[b*stride : b*stride + L] (an unfold view); the product is
    one f32 matmul with TF32 off for its duration."""
    L, R = w.shape
    batch, T = x.shape
    assert T % stride == 0 and L % stride == 0, (T, L, stride)
    n_blocks = T // stride - L // stride
    patches = x.unfold(1, L, stride)[:, :n_blocks]        # [batch, nb, L]
    with _no_tf32():
        y = torch.matmul(patches.reshape(batch * n_blocks, L).float(),
                         w.float())                       # [batch*nb, R]
    y = y.reshape(batch, n_blocks * R)
    return y if raw else word2int(y)


def resample_conv_tm(x: torch.Tensor, w: torch.Tensor, *,
                     stride: int) -> torch.Tensor:
    """Time-major twin of :func:`resample_conv` (the JAX package's
    ``resample_conv_tm``, the layout of the batched engine).

    x: int16[T, B], T % stride == 0; w: f32[L, R], L % stride == 0.
    returns int16[n_blocks * R, B], n_blocks = T // stride - L // stride:
    block b is WORD2INT(W^T @ x[b*stride : b*stride + L]), one f32 matmul
    with TF32 off for its duration."""
    L, R = w.shape
    patches = dense_patches(x, L, stride)                  # [nb, L, B]
    with _no_tf32():
        y = torch.matmul(w.float().t(), patches.float())   # [nb, R, B]
    return word2int(y).reshape(-1, x.shape[1])


def fixed_weight_planes(w16):
    """The JAX package's exact balanced plane split of int16 taps (its
    dense fixed weights): w16 int16[L, C] -> (wh int8[L, C], wl0 int8[L,
    C], bias int32[C]) with w = 256*wh + wl0 exactly and bias[c] = 128 *
    sum_L w16[l, c] (``fixed_math.balanced_q15_split``)."""
    return balanced_q15_split(w16, tap_axis=0)


def resample_conv_tm_fixed(x: torch.Tensor, w: tuple, *, stride: int,
                           n_accum: int = 1) -> torch.Tensor:
    """Fixed-point dense launch, time-major, bit-exact.

    x: int16[T, B], T % stride == 0 (history ++ chunk ++ zeros)
    w: ``(w16 int16[L, C],)`` (direct, n_accum 1) or ``(w16, coef
       int32[4, R])`` (interpolated, n_accum 4); L % stride == 0
    returns int16[n_blocks * R, B].  n_accum 1: SATURATE32PSHR(sum, 15,
    32767); n_accum 4: sum_c MULT16_32_Q15(coef[c], acc_c >> 1), then the
    same saturation."""
    w16 = w[0]
    L, C = w16.shape
    R = C // n_accum
    patches = dense_patches(x, L, stride)                  # [nb, L, B]
    n_blocks, B = patches.shape[0], x.shape[1]
    acc = wrap_int32(torch.matmul(w16.double().t(), patches.double()))
    if n_accum == 1:
        return sat32pshr15(acc).reshape(n_blocks * R, B)
    return fixed_interp_mix_rows(acc.view(n_blocks, 4, R, B),
                                 w[1]).reshape(n_blocks * R, B)


def launch_key(scheme: str, form: str) -> str:
    """The :data:`launches` key of a gather launch of this scheme
    ("highest" or "fixed") and form ("rows", float only; "band" or
    "stream")."""
    return scheme if form == "rows" else f"{scheme}_{form}"


class GatherPlan(NamedTuple):
    """A gather launch's CTA geometry (:func:`gather_plan`).  Rows form:
    ``outputs`` M consecutive outputs a CTA (8, 16, 32 or 64), ``taps`` KC
    taps a chunk the CTA stages and walks (<= N), ``rows`` the window rows
    it stages at once.  Band form: ``outputs`` the band's outputs a group
    (fixed: 32 for n_accum 4, 64 for 1; float: 64 a CTA, four 16-output
    tiles), ``taps`` K, the band's width (fixed: a multiple of 32; float:
    of 8), ``rows`` the x rows a float CTA stages (0 for fixed).  Stream
    form: ``outputs`` a band tile's (float 16; fixed 16 for n_accum 4, 32
    for 1), ``taps`` K (a whole number of 32-tap float, 64-tap fixed
    stages), ``rows`` 0."""
    outputs: int
    taps: int
    rows: int
    form: str = "rows"


class GatherBand(NamedTuple):
    """A band or stream launch's weights (:func:`gather_band`).  Float:
    ``w`` float64 (band form) or float32 (stream form) [ceil(n_out / 16) *
    16, K], row o holding output o's taps from column starts[o] - starts[o
    - o % 16], ``bias`` None.  Fixed (G the plan's outputs): ``w``
    the balanced int8 planes int8[2, groups, n_accum * G, K] of the int16
    band (K-major, each 32-tap group permuted by ``tiled_fir.K_PERM``;
    column c * G + j holds tap row c of the group's output j from column
    starts[o] - starts[o0]), ``bias`` int32[groups, n_accum * G] = 128 *
    sum of each column."""
    w: torch.Tensor
    bias: torch.Tensor | None


def _band_smem(n_accum: int | None, x_itemsize: int, K: int,
               rows: int) -> int:
    """Dynamic shared memory of a band CTA (``gather_fir_band_smem`` of
    ``csrc/gather_fir.cu``, checked against this when the library loads):
    fixed, the group's two planes, each warpgroup's ring of four 64-tap x
    stages and its output rows; float, the four tiles' bands (rows K + 4
    doubles apart) and two staged x windows."""
    if n_accum is None:
        return _F64_OUTPUTS * (K + 4) * 8 + 2 * rows * _F64_PITCH * x_itemsize
    G = _BAND_GROUP[n_accum]       # two warpgroups, G / 2 outputs each
    return 2 * K * n_accum * G + 2 * (4 * 64 + G // 2) * _RAW_PITCH + 128


def _stream_smem(n_accum: int | None) -> int:
    """Dynamic shared memory of a streamed CTA (``gather_fir_stream_smem``
    of ``csrc/gather_fir.cu``): a ring of stages (float 4, fixed 6), each
    (float) 32 taps of the tile's 16 band rows (f32, rows 36 floats apart)
    and of the x rows of its 256 lanes (rows 264 samples apart) or (fixed)
    64 taps of the group's two planes and of each warpgroup's x rows;
    fixed, each warpgroup's output rows."""
    ring = _STREAM_RING[n_accum]
    if n_accum is None:
        return ring * (16 * 36 * 4 + 32 * (_F64_STREAM_LANES + 8) * 2)
    G = _STREAM_GROUP[n_accum]
    return (ring * (2 * 64 * n_accum * G + _STREAM_WGS * 64 * _RAW_PITCH)
            + _STREAM_WGS * G * _RAW_PITCH + 128)


def _starts(starts, N: int) -> np.ndarray:
    s = np.asarray(starts, dtype=np.int64)
    if s.ndim != 1 or s.size == 0 or (np.diff(s) < 0).any():
        raise ValueError("starts must be a non-empty non-decreasing vector")
    if N < 1:
        raise ValueError(f"N = {N}")
    return s


def _spreads(s: np.ndarray, M: int) -> np.ndarray:
    """Each M-output tile's start spread (its last output's start less its
    first's; the last tile may hold fewer outputs)."""
    first = np.arange(0, s.size, M)
    return s[np.minimum(first + M, s.size) - 1] - s[first]


def gather_plan_band(starts, N: int, *, n_accum: int | None = None,
                     x_itemsize: int = 2) -> GatherPlan | None:
    """The band form's plan over these window starts and N taps an output
    (``n_accum`` as :func:`gather_plan`), or None where a CTA's band and
    staged rows do not fit :data:`GATHER_BAND_SMEM_BYTES`.  Fixed: G
    outputs a group, K the widest group's start spread + N rounded up to
    32.  Float: K the widest 16-output tile's spread + N rounded up to 8;
    a CTA stages the rows from its first output's start to its fourth
    tile's origin + K."""
    s = _starts(starts, N)
    if n_accum is None:
        K = -(-(int(_spreads(s, _F64_TILE).max()) + N) // 8) * 8
        first = np.arange(0, s.size, _F64_OUTPUTS)
        fourth = np.minimum(first + 3 * _F64_TILE, s.size - 1)
        rows = int((s[fourth] - s[first]).max()) + K
        plan = GatherPlan(_F64_OUTPUTS, K, rows, "band")
    else:
        G = _BAND_GROUP[n_accum]
        K = -(-(int(_spreads(s, G).max()) + N) // 32) * 32
        plan = GatherPlan(G, K, 0, "band")
    if _band_smem(n_accum, x_itemsize, plan.taps,
                  plan.rows) > GATHER_BAND_SMEM_BYTES:
        return None
    return plan


def gather_plan_stream(starts, N: int, *, n_accum: int | None = None,
                       x_itemsize: int = 2) -> GatherPlan:
    """The stream form's plan over these window starts and N taps an output
    (``n_accum`` as :func:`gather_plan`): G outputs a band tile (float 16;
    fixed 16 for n_accum 4, 32 for 1), K the widest tile's start spread + N
    rounded up to a whole stage (32 taps float, 64 fixed).  Its kernels
    stream the band, so it fits at any K; they take int16 samples only."""
    if x_itemsize != 2:
        raise ValueError("the stream form takes int16 samples")
    s = _starts(starts, N)
    G, stage = _STREAM_GROUP[n_accum], _STREAM_TAPS[n_accum]
    K = -(-(int(_spreads(s, G).max()) + N) // stage) * stage
    return GatherPlan(G, K, 0, "stream")


def gather_plan_rows(starts, N: int, *,
                     x_itemsize: int = 2) -> GatherPlan:
    """The rows form's plan (float only) over these window starts
    (non-decreasing int[n_out]) and N taps an output, such that a CTA's
    staged tap rows (M x KC, as double) and window rows (``rows`` x 64
    lanes of ``x_itemsize`` bytes) fit :data:`GATHER_SMEM_BYTES`.

    A CTA stages, for each chunk of KC taps, the rows its outputs' windows
    span: the start spread of its M outputs + KC.  The first plan takes
    all of a chunk's rows at once: the most outputs M that fit with KC =
    N, else with KC halved, and so on.  The second stages them a piece of
    ``rows`` at a time: M 8, KC filling half the memory, the rows the
    other half.  The second is taken where the first does not exist (a
    steep decimation whose 8 outputs' windows lie far apart) or stages
    more rows an output, ceil(N / KC) (spread + KC) / M."""
    s = _starts(starts, N)
    tap_bytes = 8
    row_bytes = GATHER_LANES * x_itemsize
    spans = {M: int(_spreads(s, M).max()) for M in _GATHER_OUTPUTS}

    def cost(p):
        return -(-N // p.taps) * (spans[p.outputs] + p.taps) / p.outputs

    kc = min(N, GATHER_SMEM_BYTES // 2 // (8 * tap_bytes))
    pieces = GatherPlan(8, kc, (GATHER_SMEM_BYTES - 8 * kc * tap_bytes)
                        // row_bytes)
    kc = N
    while True:
        for M in _GATHER_OUTPUTS:
            rows = spans[M] + kc
            if M * kc * tap_bytes + rows * row_bytes <= GATHER_SMEM_BYTES:
                whole = GatherPlan(M, kc, rows)
                return whole if cost(whole) <= cost(pieces) else pieces
        if kc == 1:
            return pieces
        kc = -(-kc // 2)


def gather_plan(starts, N: int, *, n_accum: int | None = None,
                x_itemsize: int = 2) -> GatherPlan:
    """The CTA geometry of a gather launch over these window starts
    (non-decreasing int[n_out]) and N taps an output: the band form
    (:func:`gather_plan_band`) wherever its band fits a CTA, else, for
    int16 samples and every fixed launch, the stream form
    (:func:`gather_plan_stream`, which refuses other samples), else the
    float rows form (:func:`gather_plan_rows`).  ``n_accum`` None is the float
    kernel, 1 or 4 the fixed one's tap rows an output; ``x_itemsize`` the
    sample width.  Computed on the host when a step is built, never at
    launch.

    The band form measured faster at the batched launch (2048 lanes) at
    every drift ratio that fits, its sparsest bands included (44.1k ->
    44.101k q0: density N / K 0.33 float, 0.125 fixed; 2.1x and 2.4x the
    rows form's speed; PERF.md section 6).  Where it does not fit, a steep
    decimation such as 96000 -> 401 q3, the band is as dense (N / K 0.76
    at 16 outputs) and the stream form walks it."""
    band = gather_plan_band(starts, N, n_accum=n_accum,
                            x_itemsize=x_itemsize)
    if band is not None:
        return band
    if x_itemsize == 2 or n_accum is not None:
        return gather_plan_stream(starts, N, n_accum=n_accum,
                                  x_itemsize=x_itemsize)
    return gather_plan_rows(starts, N, x_itemsize=x_itemsize)


def gather_band(taps, starts, plan: GatherPlan, device=None) -> GatherBand:
    """The band or stream form's weights (:class:`GatherBand`) of its
    plan, from the host's taps (f32[n_out, N]: float; int16[n_out, N] or
    [n_out, 4, N]: fixed) and starts, on ``device`` (the taps' if a
    tensor, else the CPU).  Built when a step is built, never at launch."""
    if plan.form not in ("band", "stream"):
        raise ValueError(f"a {plan.form} plan has no band")
    if device is None:
        device = taps.device if isinstance(taps, torch.Tensor) else "cpu"
    if isinstance(taps, torch.Tensor):
        taps = taps.cpu().numpy()
    s = np.asarray(starts.cpu() if isinstance(starts, torch.Tensor)
                   else starts, dtype=np.int64)
    n_out, N, K = len(s), taps.shape[-1], plan.taps
    fixed = taps.dtype == np.int16
    tile = plan.outputs if fixed else _F64_TILE
    o = np.arange(n_out)
    off = s - s[o // tile * tile]
    cols = off[:, None] + np.arange(N)
    if int(cols.max()) >= K:
        raise ValueError(f"a window reaches past the band's {K} taps")
    if not fixed:
        band = np.zeros((-(-n_out // tile) * tile, K),
                        dtype=np.float64 if plan.form == "band"
                        else np.float32)
        band[o[:, None], cols] = taps
        return GatherBand(torch.from_numpy(band).to(device), None)
    t3 = taps.reshape(n_out, -1, N)
    n_acc = t3.shape[1]
    G, groups = plan.outputs, -(-n_out // plan.outputs)
    band = np.zeros((groups, G, n_acc, K), dtype=np.int16)
    band[(o // G)[:, None], (o % G)[:, None], :, cols] = \
        t3.transpose(0, 2, 1)
    band = band.transpose(0, 2, 1, 3).reshape(groups, n_acc * G, K)
    wh, wl0, bias = balanced_q15_split(band, tap_axis=2)
    planes = int8_k_major(np.stack([wh, wl0]))
    return GatherBand(planes.to(device), torch.from_numpy(bias).to(device))


def _library():
    """The kernels' library, its gather shared-memory ceiling checked
    against :data:`GATHER_SMEM_BYTES` the first time it is seen."""
    global _checked
    lib = _build.load()
    if lib is not _checked:
        if lib.gather_fir_smem_max() != GATHER_SMEM_BYTES \
                or lib.gather_fir_band_smem_max() != GATHER_BAND_SMEM_BYTES:
            raise RuntimeError("csrc/gather_fir.cu's shared memory ceilings "
                               "disagree with GATHER_SMEM_BYTES / "
                               "GATHER_BAND_SMEM_BYTES")
        for n_accum, x_bytes, K, rows in ((None, 2, 144, 192),
                                          (None, 4, 136, 200), (4, 2, 160, 0),
                                          (1, 2, 96, 0)):
            if lib.gather_fir_band_smem(n_accum or 0, x_bytes, K, rows) \
                    != _band_smem(n_accum, x_bytes, K, rows):
                raise RuntimeError("csrc/gather_fir.cu's band shared memory "
                                   "disagrees with fir_matmul._band_smem")
        _checked = lib
    return lib


def _axis(hist, x):
    """The plain versions' operand: hist ++ x along time, [batch, H + T]."""
    return x if hist is None else torch.cat([hist, x], dim=1)


def _hist_args(hist, x) -> tuple:
    """(pointer, time stride, lane stride, rows) of a launch's hist."""
    if hist is None:
        return None, 0, 0, 0
    if hist.device != x.device:
        raise ValueError(f"hist on {hist.device}, expected {x.device}")
    if hist.ndim != 2 or hist.dtype != x.dtype \
            or hist.shape[0] != x.shape[0]:
        raise TypeError(f"hist {hist.dtype} {tuple(hist.shape)} for x "
                        f"{x.dtype} {tuple(x.shape)}")
    return hist.data_ptr(), hist.stride(1), hist.stride(0), hist.shape[1]


def _check_gather(x, taps, starts, coef, plan, fixed: bool):
    """Validate one gather launch on the card; returns (n_out, N)."""
    for t in (taps, starts) + ((coef,) if coef is not None else ()):
        if t.device != x.device:
            raise ValueError(f"tensor on {t.device}, expected {x.device}")
        if not t.is_contiguous():
            raise ValueError("taps, starts and coef must be contiguous")
    if x.ndim != 2 or x.dtype not in ((torch.int16,) if fixed
                                      else (torch.int16, torch.float32)):
        raise TypeError(f"x {x.dtype} {tuple(x.shape)}")
    n_out, N = taps.shape[0], taps.shape[-1]
    if fixed:
        interp = taps.ndim == 3
        if taps.dtype != torch.int16 or (interp and taps.shape[1] != 4):
            raise TypeError(f"fixed taps {taps.dtype} {tuple(taps.shape)}")
        if (coef is not None) != interp or (interp and (
                coef.dtype != torch.int32
                or tuple(coef.shape) != (n_out, 4))):
            raise ValueError("an interpolated gather takes coef int32"
                             "[n_out, 4], a direct one none")
    elif taps.dtype != torch.float32 or taps.ndim != 2:
        raise TypeError(f"float taps {taps.dtype} {tuple(taps.shape)}")
    if starts.dtype != torch.int32 or tuple(starts.shape) != (n_out,):
        raise ValueError(f"starts {starts.dtype} {tuple(starts.shape)}")
    if not isinstance(plan, GatherPlan):
        raise TypeError("a CUDA gather launch takes a GatherPlan "
                        "(gather_plan of the host's starts)")
    return n_out, N


def _check_band(x, band, plan, n_out, n_accum):
    """Validate a band or stream launch's weights against its plan
    (n_accum None: float)."""
    if not isinstance(band, GatherBand):
        raise TypeError(f"a {plan.form} plan's launch takes its GatherBand "
                        "(gather_band)")
    K = plan.taps
    if n_accum is None:
        dtype = torch.float64 if plan.form == "band" else torch.float32
        want = [(band.w, dtype, (-(-n_out // _F64_TILE) * _F64_TILE, K))]
    else:
        G = plan.outputs
        group = (_BAND_GROUP if plan.form == "band" else _STREAM_GROUP)
        if G != group[n_accum]:
            raise ValueError(f"a fixed {plan.form} plan of n_accum {n_accum} "
                             f"takes {group[n_accum]} outputs a group")
        groups = -(-n_out // G)
        want = [(band.w, torch.int8, (2, groups, n_accum * G, K)),
                (band.bias, torch.int32, (groups, n_accum * G))]
    for t, dtype, shape in want:
        if not isinstance(t, torch.Tensor) or t.device != x.device \
                or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            got = None if t is None else (t.dtype, tuple(t.shape))
            raise ValueError(f"band {got}, expected a contiguous {dtype} "
                             f"{shape} on {x.device}")


def _stream_scratch(lib, n_accum, n_out: int, batch: int, K: int,
                    device) -> tuple:
    """A streamed launch's scratch: its partial sums (bytes) and its
    zeroed int32 counters where it splits K over CTAs, as the library
    sizes them for this card, else (None, None).  The caller holds them
    until the launch is queued."""
    part_bytes, counters = ctypes.c_longlong(0), ctypes.c_int(0)
    err = lib.gather_fir_stream_scratch(n_accum or 0, n_out, batch, K,
                                        ctypes.byref(part_bytes),
                                        ctypes.byref(counters))
    if err:
        raise RuntimeError("gather kernel (stream) scratch failed: "
                           + lib.gather_fir_error_string(err).decode())
    part = (torch.empty(part_bytes.value, dtype=torch.uint8, device=device)
            if part_bytes.value else None)
    count = (torch.zeros(counters.value, dtype=torch.int32, device=device)
             if counters.value else None)
    return part, count


def _ptrs(*tensors) -> tuple:
    return tuple(None if t is None else t.data_ptr() for t in tensors)


def gather_tiles(plan: GatherPlan, n_out: int, batch: int) -> int:
    """The (output tile, 64-lane tile) units of a band or stream launch,
    an output tile being its plan's ``outputs``: a float band CTA's 64, a
    fixed group's, a stream form's band tile."""
    return -(-n_out // plan.outputs) * -(-batch // GATHER_LANES)


@functools.lru_cache(maxsize=64)
def launch_ctas(lib, device: int, form: str, n_accum: int | None,
                x_bytes: int, n_out: int, batch: int, K: int,
                rows: int) -> tuple:
    """(CTAs, resident CTAs) of a band or stream launch on the current
    CUDA device (index ``device``, for the cache), as ``lib``'s launcher
    takes them (``gather_fir_launch_ctas``); ``n_accum`` None is the float
    kernel.  A step's launches repeat, so each shape is asked once."""
    ctas, resident = ctypes.c_int(0), ctypes.c_int(0)
    err = lib.gather_fir_launch_ctas(("band", "stream").index(form),
                                     n_accum or 0, x_bytes, n_out, batch, K,
                                     rows, ctypes.byref(ctas),
                                     ctypes.byref(resident))
    if err:
        raise RuntimeError(f"gather kernel ({form}) CTA query failed: "
                           + lib.gather_fir_error_string(err).decode())
    return ctas.value, resident.value


def count_gather(lib, device: int, plan: GatherPlan, n_accum: int | None,
                 x_bytes: int, n_out: int, batch: int) -> None:
    """One band or stream launch of ``plan`` into the port's counters
    (:data:`GATHER_LAUNCHES` and the rest), on the current CUDA device."""
    ctas, resident = launch_ctas(lib, device, plan.form, n_accum, x_bytes,
                                 n_out, batch, plan.taps, plan.rows)
    count(GATHER_LAUNCHES)
    count(GATHER_CTAS, ctas)
    count(GATHER_RESIDENT, resident)
    count(GATHER_TILES, gather_tiles(plan, n_out, batch))


@span("speex.kernel.gather")
def resample_gather(x: torch.Tensor, taps: torch.Tensor,
                    starts: torch.Tensor, *,
                    hist: torch.Tensor | None = None,
                    tile: int | None = None, raw: bool = False,
                    plan: GatherPlan | None = None,
                    band: GatherBand | None = None) -> torch.Tensor:
    """Float gather launch: per-output tap-row dots over hist ++ x.

    x:      int16 (or f32) [batch, T], any strides (the batched step passes
            a transposed view of time-major memory, the single-stream
            route a contiguous [channels, T])
    hist:   None, or [batch, H] of x's type, any strides: the H rows of
            the axis before x (the batched step's history)
    taps:   f32[n_out, N]   each output's taps, gathered by phase
    starts: int32[n_out]    window starts on hist ++ x, non-decreasing
                            (clamped in range)
    plan:   the launch's :class:`GatherPlan` (CUDA tensors)
    band:   the band or stream plan's :class:`GatherBand` (CUDA tensors)
    returns int16[batch, n_out], or the raw f32 sums when ``raw`` (a
    transposed view of [n_out, batch] memory)

    CUDA tensors launch ``gather_fir_f32`` (rows), ``gather_fir_f32_band``
    (band) or ``gather_fir_f32_stream`` (stream; int16 x only, else
    TypeError), as the plan says, on the current stream (asynchronously;
    a launch error raises); CPU tensors run
    :func:`resample_gather_reference` on the concatenation hist ++ x
    (``tile`` steers only it).  A band or stream launch adds 1, its CTAs,
    its resident CTAs and its tiles to the counters (:func:`count_gather`)."""
    if x.device.type == "cpu":
        return resample_gather_reference(_axis(hist, x), taps, starts,
                                         tile=tile, raw=raw)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    n_out, N = _check_gather(x, taps, starts, None, plan, fixed=False)
    h = _hist_args(hist, x)
    lib = _library()
    batch, T = x.shape
    y = torch.empty((n_out, batch),
                    dtype=torch.float32 if raw else torch.int16,
                    device=x.device)
    axis = (*h, x.data_ptr(), x.stride(1), x.stride(0),
            int(x.dtype == torch.float32))
    with torch.cuda.device(x.device):
        if plan.form == "band":
            _check_band(x, band, plan, n_out, None)
            err = lib.gather_fir_f32_band(
                *axis, band.w.data_ptr(), starts.data_ptr(), y.data_ptr(), T,
                batch, n_out, plan.taps, plan.rows, int(raw),
                _build.stream_handle(x.device))
        elif plan.form == "stream":
            if x.dtype != torch.int16:
                raise TypeError("the stream form takes int16 samples, got "
                                f"{x.dtype}")
            _check_band(x, band, plan, n_out, None)
            scratch = _stream_scratch(lib, None, n_out, batch, plan.taps,
                                      x.device)
            err = lib.gather_fir_f32_stream(
                *axis[:-1], band.w.data_ptr(), starts.data_ptr(),
                y.data_ptr(), T, batch, n_out, plan.taps, int(raw),
                *_ptrs(*scratch), _build.stream_handle(x.device))
        else:
            err = lib.gather_fir_f32(
                *axis, taps.data_ptr(), starts.data_ptr(), y.data_ptr(), T,
                batch, n_out, N, plan.outputs, plan.taps, plan.rows,
                int(raw), _build.stream_handle(x.device))
        if not err and plan.form != "rows":
            count_gather(lib, x.device.index, plan, None, x.element_size(),
                         n_out, batch)
    if err:
        raise RuntimeError(f"gather kernel ({plan.form}) launch failed: "
                           + lib.gather_fir_error_string(err).decode())
    launches[launch_key("highest", plan.form)] += 1
    return y.t()


@span("speex.kernel.gather")
def resample_gather_fixed(x: torch.Tensor, taps: torch.Tensor,
                          starts: torch.Tensor,
                          coef: torch.Tensor | None = None, *,
                          hist: torch.Tensor | None = None,
                          tile: int | None = None,
                          plan: GatherPlan | None = None,
                          band: GatherBand | None = None) -> torch.Tensor:
    """Fixed-point gather launch over hist ++ x, bit-exact.

    x:      int16[batch, T], any strides (as :func:`resample_gather`)
    hist:   None, or int16[batch, H], any strides (as
            :func:`resample_gather`)
    taps:   int16[n_out, N] (direct rows) or int16[n_out, 4, N]
            (interpolated accumulator rows), gathered by phase
    starts: int32[n_out] clamped window origins, non-decreasing
    coef:   int32[n_out, 4] Q15 cubic coefficients (interpolated only)
    plan:   the launch's :class:`GatherPlan` (CUDA tensors)
    band:   the band or stream plan's :class:`GatherBand` (CUDA tensors)
    returns int16[batch, n_out]

    CUDA tensors launch ``gather_fir_fixed_band<1|4>`` (band) or
    ``gather_fir_fixed_stream<1|4>`` (stream), as the plan says (a rows
    plan raises: the fixed gather has no rows form), on the current
    stream; CPU tensors run
    :func:`resample_gather_fixed_reference` on the concatenation hist ++ x
    (``tile`` steers only it).  A launch adds to the counters as
    :func:`resample_gather`'s band and stream launches do."""
    if x.device.type == "cpu":
        return resample_gather_fixed_reference(_axis(hist, x), taps, starts,
                                               coef, tile=tile)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    n_out, N = _check_gather(x, taps, starts, coef, plan, fixed=True)
    if plan.form not in ("band", "stream"):
        raise ValueError(f"a fixed gather launch takes a band or stream "
                         f"plan, not a {plan.form} one")
    h = _hist_args(hist, x)
    lib = _library()
    batch, T = x.shape
    y = torch.empty((n_out, batch), dtype=torch.int16, device=x.device)
    n_accum = 4 if taps.ndim == 3 else 1
    axis = (*h, x.data_ptr(), x.stride(1), x.stride(0))
    c_ptr = None if coef is None else coef.data_ptr()
    with torch.cuda.device(x.device):
        if plan.form == "band":
            _check_band(x, band, plan, n_out, n_accum)
            err = lib.gather_fir_fixed_band(
                *axis, band.w.data_ptr(), band.bias.data_ptr(),
                starts.data_ptr(), c_ptr, y.data_ptr(), n_accum, T, batch,
                n_out, plan.taps, _build.stream_handle(x.device))
        else:
            _check_band(x, band, plan, n_out, n_accum)
            scratch = _stream_scratch(lib, n_accum, n_out, batch, plan.taps,
                                      x.device)
            err = lib.gather_fir_fixed_stream(
                *axis, band.w.data_ptr(), band.bias.data_ptr(),
                starts.data_ptr(), c_ptr, y.data_ptr(), n_accum, T, batch,
                n_out, plan.taps, *_ptrs(*scratch),
                _build.stream_handle(x.device))
        if not err:
            count_gather(lib, x.device.index, plan, n_accum, 2, n_out, batch)
    if err:
        raise RuntimeError(f"fixed gather kernel ({plan.form}) launch "
                           "failed: "
                           + lib.gather_fir_error_string(err).decode())
    launches[launch_key("fixed", plan.form)] += 1
    return y.t()


def _gather_tiles(n_out: int, N: int, batch: int, tile: int | None):
    if tile is None:
        tile = min(_GATHER_MAX_TILE,
                   max(1, _GATHER_WINDOW_BYTES // (N * batch * 8)))
    return range(0, n_out, tile), tile


def _windows(x: torch.Tensor, starts: torch.Tensor, o0: int, o1: int,
             N: int) -> torch.Tensor:
    """float64 [o1-o0, N, batch]: output o's window, rows starts[o] ..
    starts[o]+N-1 of x int16[batch, T] (read time-major)."""
    idx = starts[o0:o1].long()[:, None] + torch.arange(N, device=x.device)
    return x.t()[idx].double()


def resample_gather_reference(x: torch.Tensor, taps: torch.Tensor,
                              starts: torch.Tensor, *,
                              tile: int | None = None,
                              raw: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`resample_gather` (same contract), on
    the tensors' own device.

    Each dot is taken in float64 (the products of f32 taps and int16
    samples are exact there), rounded once to f32, then WORD2INT: within
    the LSB contract of the JAX package's f32 HIGHEST einsum.  Outputs are
    walked ``tile`` at a time (by default sized from N and the batch, so
    the window stays bounded); the result does not depend on the tile."""
    n_out, N = taps.shape
    batch = x.shape[0]
    y = torch.empty((n_out, batch), dtype=torch.float32, device=x.device)
    tiles, tile = _gather_tiles(n_out, N, batch, tile)
    for o0 in tiles:
        o1 = min(o0 + tile, n_out)
        win = _windows(x, starts, o0, o1, N)               # [t, N, batch]
        y[o0:o1] = torch.matmul(taps[o0:o1, None, :].double(),
                                win)[:, 0].float()
    return y.t() if raw else word2int(y).t()


def resample_gather_fixed_reference(x: torch.Tensor, taps: torch.Tensor,
                                    starts: torch.Tensor,
                                    coef: torch.Tensor | None = None, *,
                                    tile: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`resample_gather_fixed` (same
    contract), on the tensors' own device: the int16 dots as exact float64
    matmuls wrapped to int32, then the Q15 epilogue (the cubic mix of the 4
    accumulators for an interpolated filter)."""
    n_out, N = taps.shape[0], taps.shape[-1]
    batch = x.shape[0]
    interp = taps.dim() == 3
    t3 = taps if interp else taps[:, None, :]
    y = torch.empty((n_out, batch), dtype=torch.int16, device=x.device)
    tiles, tile = _gather_tiles(n_out, N, batch, tile)
    for o0 in tiles:
        o1 = min(o0 + tile, n_out)
        win = _windows(x, starts, o0, o1, N)               # [t, N, batch]
        acc = wrap_int32(torch.matmul(t3[o0:o1].double(), win))
        if interp:
            y[o0:o1] = fixed_interp_mix_rows(
                acc[:, :, None, :], coef[o0:o1, :, None])[:, 0]
        else:
            y[o0:o1] = sat32pshr15(acc[:, 0])
    return y.t()
