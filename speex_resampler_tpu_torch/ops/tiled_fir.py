"""Phase-tiled polyphase FIR launch: the kernel of the batched serving path.

Counterpart of the v3 family in ``speex_resampler_tpu/ops/pallas_fir.py``
(``resample_conv_tm_pallas_v3``), schemes ``"highest"`` and ``"int8"``.

Layout: time-major int16 ``[rows, B]`` with the lane axis minor, as in the
JAX package, so the same host slabs feed both.  Output block k (R rows)
reads K rows of the virtual axis ``hist ++ x`` from origin
``(k // P) * S + offsets[k % P]`` and applies the weights of block phase
``k % P``.

Device weights (built once per step, never per launch; see
:func:`device_weights`):

- ``"highest"``: ``(w f32[P, K, R], taps int32[P, R // ROW_TILE, 2])``
- ``"int8"``: ``(planes int8[D, P, K, R], bias f32[P, R], taps)``

``w`` and ``planes`` keep the JAX package's ``[.., K, R]`` layout (the TPU
kernel transposed to ``[R, K]`` for the MXU; the CUDA kernel reads R-wide
tap rows, which that layout already gives).  ``taps[m, i] = (lo, hi)`` is
the range of tap rows in which weight columns ``[i*ROW_TILE, (i+1)*ROW_TILE)``
of phase m have a nonzero entry; the CUDA kernel skips the rest, which
changes no result (the skipped products are exact zeros).

:func:`resample_tiled` launches the CUDA kernel (``csrc/tiled_fir.cu``) for
CUDA tensors and runs :func:`resample_tiled_reference`, its plain PyTorch
version, for CPU tensors.  It never falls back from one to the other.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from . import _build, int8_planes
from .convert import word2int

__all__ = ["int8_weights", "int8_weights_auto", "tap_ranges",
           "device_weights", "resample_tiled", "resample_tiled_reference",
           "ROW_TILE"]

#: Output rows of one block handled by one CTA (``kRowTile`` in the CUDA
#: source); R must be a multiple of it.
ROW_TILE = 64

#: Launches of each CUDA kernel in this process, by scheme; only
#: resample_tiled adds to it, once per launch.  Callers reset the counts to
#: count one run.
launches = {"highest": 0, "int8": 0}


def int8_weights(w, digits: int = 3):
    """Host-side int8 digit-plane decomposition (ops/int8_planes.py) for
    the "int8" scheme: returns (planes int8[D, P, K, R], bias f32[P, R],
    scales tuple, err_bound).  Exactness is gated by the decomposition's
    rigorous certificate."""
    sw = {3: 23, 4: 31}.get(digits, 23)
    pl8 = int8_planes.decompose(np.asarray(w, dtype=np.float32), sw=sw,
                                digits=digits)
    return (pl8.planes, pl8.bias, tuple(float(s) for s in pl8.scales),
            float(pl8.err_bound))


def int8_weights_auto(w, gate: float):
    """Smallest digit count whose certificate clears ``gate`` (3 then 4);
    None if even 4 digits cannot."""
    for digits in (3, 4):
        planes = int8_weights(w, digits=digits)
        if planes[3] <= gate:
            return planes
    return None


def tap_ranges(nonzero: np.ndarray) -> np.ndarray:
    """``nonzero``: bool[P, K, R] -> int32[P, R // ROW_TILE, 2], the
    [lo, hi) tap rows holding a nonzero weight in each row tile (0, 0 for
    an all-zero tile)."""
    P, K, R = nonzero.shape
    assert R % ROW_TILE == 0, R
    tiles = nonzero.reshape(P, K, R // ROW_TILE, ROW_TILE).any(axis=3)
    out = np.zeros((P, R // ROW_TILE, 2), dtype=np.int32)
    for m in range(P):
        for i in range(R // ROW_TILE):
            rows = np.flatnonzero(tiles[m, :, i])
            if rows.size:
                out[m, i] = rows[0], rows[-1] + 1
    return out


def device_weights(w, scheme: str, device) -> tuple:
    """Host weights -> the kernel's device weights (see module docstring).
    ``w``: f32[P, K, R] for "highest", ``(planes, bias)`` for "int8"."""
    if scheme == "highest":
        w = np.asarray(w, dtype=np.float32)
        return (torch.from_numpy(w.copy()).to(device),
                torch.from_numpy(tap_ranges(w != 0)).to(device))
    if scheme == "int8":
        planes, bias = (np.asarray(a) for a in w)
        assert planes.dtype == np.int8 and bias.dtype == np.float32
        return (torch.from_numpy(planes.copy()).to(device),
                torch.from_numpy(bias.copy()).to(device),
                torch.from_numpy(tap_ranges((planes != 0).any(axis=0)))
                .to(device))
    raise NotImplementedError(
        f"scheme {scheme!r} has no port yet (ROADMAP.md K1c/K1d/K1e)")


def _check(hist, x, w, offsets, S, n_blocks, scheme, scales):
    if scheme not in ("highest", "int8"):
        raise NotImplementedError(
            f"scheme {scheme!r} has no port yet (ROADMAP.md K1c/K1d/K1e)")
    for t in (hist, x, offsets, *w):
        if t.device != x.device:
            raise ValueError(f"tensor on {t.device}, expected {x.device}")
        if not t.is_contiguous():
            raise ValueError("tensors must be contiguous")
    if hist.dtype != torch.int16 or x.dtype != torch.int16:
        raise TypeError("hist and x must be int16")
    if hist.ndim != 2 or x.ndim != 2 or hist.shape[1] != x.shape[1]:
        raise ValueError(f"hist {tuple(hist.shape)} / x {tuple(x.shape)}")
    if offsets.dtype != torch.int32:
        raise TypeError("offsets must be int32")
    if scheme == "highest":
        wt, taps = w
        if wt.dtype != torch.float32 or wt.ndim != 3:
            raise TypeError("highest weights must be f32[P, K, R]")
        P, K, R = wt.shape
    else:
        planes, bias, taps = w
        if planes.dtype != torch.int8 or planes.ndim != 4:
            raise TypeError("int8 planes must be int8[D, P, K, R]")
        D, P, K, R = planes.shape
        if tuple(bias.shape) != (P, R) or bias.dtype != torch.float32:
            raise TypeError("int8 bias must be f32[P, R]")
        if len(scales) != D or not 1 <= D <= 4:
            raise ValueError(f"{len(scales)} scales for {D} digit planes")
    if tuple(offsets.shape) != (P,) or n_blocks % P or S <= 0:
        raise ValueError(f"n_blocks {n_blocks}, offsets "
                         f"{tuple(offsets.shape)} for P = {P}")
    if R % ROW_TILE or tuple(taps.shape) != (P, R // ROW_TILE, 2):
        raise ValueError(f"taps {tuple(taps.shape)} for R = {R}")
    return P, K, R


def resample_tiled(hist: torch.Tensor, x: torch.Tensor, w: tuple,
                   offsets: torch.Tensor, *, S: int, n_blocks: int,
                   scheme: str = "highest",
                   scales: tuple = ()) -> torch.Tensor:
    """One launch: int16[n_blocks * R, B].

    hist: int16[H, B] trailing history, H = round16(filt_len - 1)
    x:    int16[T_c, B] chunk, real rows [0, n_in), zeros [n_in, n_in + K)
    w:    device weights (module docstring), offsets: int32[P]
    scales: the int8 digit scales (one per plane), () for "highest".

    Rows of the virtual axis at or past H + T_c read as zero.  CUDA
    tensors launch the kernel on the current stream (asynchronously; a
    launch error raises); CPU tensors run the plain version."""
    P, K, R = _check(hist, x, w, offsets, S, n_blocks, scheme, scales)
    if x.device.type == "cpu":
        return resample_tiled_reference(hist, x, w, offsets, S=S,
                                        n_blocks=n_blocks, scheme=scheme,
                                        scales=scales)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    lib = _build.load()
    if lib.tiled_fir_row_tile() != ROW_TILE:
        raise RuntimeError("csrc/tiled_fir.cu row tile disagrees with "
                           "ROW_TILE")
    H, B = hist.shape
    y = torch.empty((n_blocks * R, B), dtype=torch.int16, device=x.device)
    if y.numel() == 0:
        return y
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        geo = (H, x.shape[0], B, R, K, P, S, n_blocks, stream)
        head = (hist.data_ptr(), x.data_ptr(), y.data_ptr(),
                offsets.data_ptr(), w[-1].data_ptr())
        if scheme == "highest":
            err = lib.tiled_fir_f32(*head, w[0].data_ptr(), *geo)
        else:
            s = tuple(scales) + (0.0,) * (4 - len(scales))
            err = lib.tiled_fir_int8(*head, w[0].data_ptr(), w[1].data_ptr(),
                                     len(scales), *s, *geo)
    if err:
        raise RuntimeError("tiled FIR kernel launch failed: "
                           + lib.tiled_fir_error_string(err).decode())
    launches[scheme] += 1
    return y


@contextlib.contextmanager
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def resample_tiled_reference(hist: torch.Tensor, x: torch.Tensor, w: tuple,
                             offsets: torch.Tensor, *, S: int, n_blocks: int,
                             scheme: str = "highest",
                             scales: tuple = ()) -> torch.Tensor:
    """Plain PyTorch version of :func:`resample_tiled` (same contract), on
    the tensors' own device: each block's patch is gathered with an index
    tensor, then one batched product over all blocks.

    "highest": f32 matmul with TF32 off, then WORD2INT.  "int8": each
    digit's integer dot ``sum w_d * (x - 128)`` in float64, exact because
    its magnitude stays below 2^31 (the certificate refuses planes where
    it would not), converted to int32, then the kernel's f32 epilogue in
    the same order."""
    P, K, R = _check(hist, x, w, offsets, S, n_blocks, scheme, scales)
    B = hist.shape[1]
    dev = x.device
    k = torch.arange(n_blocks, device=dev)
    phase = k % P
    v0 = (k // P) * S + offsets.long()[phase]
    idx = v0[:, None] + torch.arange(K, device=dev)[None, :]   # [nb, K]
    virt = torch.cat([hist, x, x.new_zeros((K, B))])
    idx = idx.clamp(max=virt.shape[0] - 1)                   # zero rows
    patch = virt[idx]                                          # [nb, K, B]
    if scheme == "highest":
        with _no_tf32():
            y = torch.matmul(w[0][phase].transpose(1, 2), patch.float())
    else:
        planes, bias = w[0], w[1]
        xs = patch.double() - 128.0
        acc = torch.zeros((n_blocks, R, B), dtype=torch.float32, device=dev)
        for d, s in enumerate(scales):
            dot = torch.matmul(planes[d][phase].double().transpose(1, 2), xs)
            acc = acc + dot.to(torch.int32).float() * s
        y = acc + bias[phase][:, :, None]
    return word2int(y).reshape(n_blocks * R, B)
