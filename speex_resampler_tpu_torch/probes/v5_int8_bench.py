"""The two float schemes' arithmetic at the flagship's geometry without the
halo (probe P9).

Counterpart of ``experiments/v5_int8_bench.py`` (``conv_int8`` :76, its
``pallas_call`` :77; ``conv_split5`` :94, its ``pallas_call`` :95): the
phase-tiled weights of 44.1 kHz -> 48 kHz q7
(``build_phase_tiled_weights(phase_table, 147, 160, 0)``: P 20, R 128, K
264, S 2352, no history), 4 periods (80 blocks), x int16 [T, B] with T =
``ceil((3 S + offsets[-1] + K) / 16) * 16``, B = 2048.  Block (j, m)
reads ``x[j * S + offsets[m] : + K]``; the schemes:

- ``int8``: the JAX package's ``_dot_int8`` with the digit planes of
  ``int8_planes.decompose(w, sw=23)`` (D = 3, scales 2^-23, 2^-15, 2^-7,
  certificate <= 0.35 LSB): six exact int8 dots a block, the f32 combine
  in digit order, the bias, WORD2INT;
- ``split5``: ``_dot_scheme``'s split5 with the planes of
  ``split5_weights(w)``: five bf16 dots summed in f32, WORD2INT.

:func:`bench` returns a scheme's int16 [n_blocks * R, B]: the kernel
(``csrc/probes/v5_bench.cu``: the served K1b and K1c bodies under a
launcher with no history) for CUDA tensors, the plain version
:func:`bench_reference` (``tiled_fir.apply_weights`` on an empty history)
for CPU tensors.  :func:`gold` is the experiment's float64 gold on one
lane.
"""

from __future__ import annotations

import dataclasses
import functools
import time

import numpy as np
import torch

from ..ops import _build, int8_planes
from ..ops import filter_design as fd
from ..ops import phase as ph
from ..ops import tiled_fir as tf
from ..ops.convert import lsb_tie_limit
from . import check_offsets_launch
from . import tc_rate as tr

__all__ = ["B", "N_PERIODS", "SW", "SCHEMES", "Geometry", "geometry",
           "weights", "launch_kw", "inputs", "bench_reference", "bench",
           "BenchLaunch", "gold", "stats", "library_call", "measure", "run",
           "launches"]

B = 2048
N_PERIODS = 4
SW = 23
SCHEMES = ("int8", "split5")

launches = 0


@dataclasses.dataclass(frozen=True)
class Geometry:
    """The experiment's module constants: weights f32 [P, K, R], its int8
    planes int8 [3, P, K, R], bias f32 [P, R], scales and certificate."""

    P: int
    K: int
    R: int
    S: int
    T: int
    offsets: tuple
    w: np.ndarray
    planes: np.ndarray
    bias: np.ndarray
    scales: tuple
    err_bound: float


@functools.lru_cache(maxsize=1)
def _phase_table() -> np.ndarray:
    return fd.design_filter(147, 160, 7).phase_table


@functools.lru_cache(maxsize=1)
def geometry() -> Geometry:
    ptw = ph.build_phase_tiled_weights(_phase_table(), 147, 160, 0)
    offs = tuple(int(o) for o in ptw.offsets)
    T = -(-((N_PERIODS - 1) * ptw.S + offs[-1] + ptw.K) // 16) * 16
    pl8 = int8_planes.decompose(ptw.w, sw=SW)
    if pl8.err_bound > 0.35:
        raise AssertionError(f"certificate {pl8.err_bound} > 0.35 LSB")
    return Geometry(P=ptw.P, K=ptw.K, R=ptw.R, S=ptw.S, T=T, offsets=offs,
                    w=np.asarray(ptw.w, dtype=np.float32),
                    planes=pl8.planes, bias=pl8.bias,
                    scales=tuple(float(s) for s in pl8.scales),
                    err_bound=float(pl8.err_bound))


def weights(g: Geometry, scheme: str, device="cpu") -> tuple:
    """The served tiled device weights (``tiled_fir.device_weights``):
    int8 ``(planes int8 [3, P, R, K_pad] K-major and permuted, bias f32 [P,
    R], slices, taps int32 [P, R / 64, 2])``; split5 ``(planes bf16 [3, P,
    K, R], taps)``."""
    if scheme == "int8":
        return tf.device_weights((g.planes, g.bias), "int8", device)
    if scheme == "split5":
        return tf.device_weights(tf.split5_weights(g.w), "split5", device)
    raise ValueError(f"scheme {scheme!r} not in {SCHEMES}")


def launch_kw(g: Geometry, scheme: str, device="cpu",
              n_periods: int = N_PERIODS) -> dict:
    return dict(offsets=torch.tensor(g.offsets, dtype=torch.int32,
                                     device=device),
                S=g.S, n_blocks=n_periods * g.P,
                scales=g.scales if scheme == "int8" else ())


def inputs(g: Geometry, B: int = B, seed: int = 0, device="cpu",
           T: int | None = None) -> torch.Tensor:
    """The experiment's x: ``rng.integers(-32768, 32768, (T, B)) // 2``
    from ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    T = g.T if T is None else T
    x = (rng.integers(-32768, 32768, size=(T, B)) // 2).astype(np.int16)
    return torch.from_numpy(x).to(device)


def _check(scheme, x, w, offsets, S, n_blocks, scales):
    if scheme not in SCHEMES:
        raise ValueError(f"scheme {scheme!r} not in {SCHEMES}")
    if x.dtype != torch.int16 or x.dim() != 2:
        raise TypeError(f"x must be int16 [T, B], got {x.dtype} "
                        f"{tuple(x.shape)}")
    hist = x.new_zeros((0, x.shape[1]))
    P, K, R = check_offsets_launch(hist, x, w, offsets, S, n_blocks, scheme,
                                   scales)
    if scheme == "int8" and len(scales) != 3:
        raise ValueError(f"{len(scales)} digit planes, the probe takes 3")
    return P, K, R


def bench_reference(scheme: str, x: torch.Tensor, w: tuple, *,
                    offsets: torch.Tensor, S: int, n_blocks: int,
                    scales: tuple = ()) -> torch.Tensor:
    """The plain version, int16 [n_blocks * R, B]: each block's patch of x
    gathered (rows past T read as zero), then the scheme's plain steps
    (``tiled_fir.apply_weights``: int8 the exact digit dots in float64 and
    the f32 combine in order; split5 the five float32 matmuls, TF32 off,
    summed in order), then WORD2INT."""
    P, K, R = _check(scheme, x, w, offsets, S, n_blocks, scales)
    k = torch.arange(n_blocks, device=x.device)
    v0 = (k // P) * S + offsets.long()[k % P]
    hist = x.new_zeros((0, x.shape[1]))
    if scheme == "int8":
        w = (tf.int8_n_major(w[0]), w[1])
    return tf.apply_weights(hist, x, w, v0, scheme, scales)


class BenchLaunch:
    """One scheme's launches on CUDA tensors (y int16 [n_blocks * R, B]);
    ``run()`` launches on the current stream."""

    def __init__(self, scheme: str, x: torch.Tensor, w: tuple, *,
                 offsets: torch.Tensor, S: int, n_blocks: int,
                 scales: tuple = ()):
        P, K, R = _check(scheme, x, w, offsets, S, n_blocks, scales)
        if x.shape[1] % 8 or x.data_ptr() % 16:
            raise ValueError("B must be a multiple of 8 and x 16-byte "
                             "aligned")
        self.lib = _build.load_probes()
        self.scheme, self.x, self.w, self.offsets = scheme, x, w, offsets
        self.S, self.n_blocks, self.P, self.K, self.R = S, n_blocks, P, K, R
        self.scales = tuple(scales) + (0.0,) * (3 - len(scales))
        self.slices = int(w[2]) if scheme == "int8" else 0
        self.y = torch.empty((n_blocks * R, x.shape[1]), dtype=torch.int16,
                             device=x.device)

    def run(self) -> torch.Tensor:
        global launches
        dev, int8 = self.x.device, self.scheme == "int8"
        with torch.cuda.device(dev):
            err = self.lib.probe_v5_bench(
                self.x.data_ptr(), self.y.data_ptr(),
                self.offsets.data_ptr(), self.w[-1].data_ptr(),
                self.w[0].data_ptr(), self.w[1].data_ptr() if int8 else None,
                SCHEMES.index(self.scheme), *self.scales, self.slices,
                self.x.shape[0], self.x.shape[1], self.R, self.K, self.P,
                self.S, self.n_blocks, _build.stream_handle(dev))
        if err:
            raise RuntimeError("v5_bench kernel launch failed: "
                               + self.lib.probe_error_string(err).decode())
        launches += 1
        return self.y


def bench(scheme: str, x: torch.Tensor, w: tuple, *, offsets: torch.Tensor,
          S: int, n_blocks: int, scales: tuple = ()) -> torch.Tensor:
    """The probe's function, int16 [n_blocks * R, B]: the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    kw = dict(offsets=offsets, S=S, n_blocks=n_blocks, scales=scales)
    if x.device.type == "cpu":
        return bench_reference(scheme, x, w, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return BenchLaunch(scheme, x, w, **kw).run()


def gold(x: torch.Tensor, n_blocks: int, lane: int = 0,
         R: int = 128) -> torch.Tensor:
    """The experiment's accuracy reference (and ``experiments/v3_bench.py``'s),
    int32 [n_blocks * R]: output i (t = 147 i) is x[t // 160 : + filt_len,
    lane] . phase_table[t % 160] in float64 (44.1 kHz -> 48 kHz q7), rounded
    half up and clipped to int16."""
    table = _phase_table()
    n = n_blocks * R
    t = np.arange(n, dtype=np.int64) * 147
    starts, taps = t // 160, table[t % 160].astype(np.float64)
    N = table.shape[1]
    xi = x[:, lane].cpu().numpy().astype(np.float64)
    idx = starts[:, None] + np.arange(N)[None, :]
    v = np.einsum("ik,ik->i", xi[idx], taps)
    return torch.from_numpy(np.clip(np.floor(0.5 + v), -32768,
                                    32767).astype(np.int32))


def stats(y: torch.Tensor, want: torch.Tensor, lane: int = 0) -> dict:
    """max |d| and the share of outputs that differ, lane ``lane`` of y
    int16 [n_blocks * R, B] against the gold int32 [n_blocks * R], as the
    experiment prints them."""
    d = (y[:, lane].cpu().to(torch.int32) - want).abs()
    return {"max_abs_d": int(d.max()), "rate": float((d > 0).double().mean())}


def library_call(scheme: str, x: torch.Tensor, w: tuple, *,
                 offsets: torch.Tensor, S: int, n_blocks: int):
    """The yardstick, as a function, where PyTorch has one: split5's five
    products as one bf16 ``torch.bmm`` with a float32 result, the planes
    and x's two bf16 parts concatenated along K ([w_hi, w_hi, w_mid, w_mid,
    w_lo] . [x_hi, x_lo, x_hi, x_lo, x_hi]), operands gathered in device
    memory (no WORD2INT); None for int8, whose yardstick ``chip_smoke.py``
    builds (``int8_exact_bmm``: one float64 bmm of the stacked digit
    planes, exact).  The port never calls it."""
    if scheme != "split5":
        return None
    planes = w[0]
    P, K = planes.shape[1], planes.shape[2]
    k = torch.arange(n_blocks, device=x.device)
    v0 = (k // P) * S + offsets.long()[k % P]
    virt = torch.cat([x, x.new_zeros((K, x.shape[1]))])
    patch = virt[v0[:, None] + torch.arange(K, device=x.device)].float()
    xh = patch.to(torch.bfloat16)
    xl = (patch - xh.float()).to(torch.bfloat16)
    a = torch.cat([planes[p][k % P] for p in (0, 0, 1, 1, 2)],
                  dim=1).transpose(1, 2).contiguous()      # [nb, R, 5K]
    b = torch.cat([xh, xl, xh, xl, xh], dim=1).contiguous()  # [nb, 5K, B]
    return lambda: torch.bmm(a, b, out_dtype=torch.float32)


def measure(scheme: str, seed: int = 0) -> dict:
    """One scheme on the card: held against the plain version (int8 0
    mismatches; split5 max |err| <= 1 within the tie bound), its max |d|
    and tie rate against the float64 gold on lane 0, then ms a launch
    (median of 5 groups of 20)."""
    t0 = time.perf_counter()
    g = geometry()
    x = inputs(g, seed=seed, device="cuda")
    w, kw = weights(g, scheme, "cuda"), launch_kw(g, scheme, "cuda")
    bl = BenchLaunch(scheme, x, w, **kw)
    got = bl.run().clone()
    d = (got.int() - bench_reference(scheme, x, w, **kw).int()).abs()
    err, mism = int(d.max()), int((d > 0).sum())
    if (scheme == "int8" and mism) or err > 1 \
            or mism > lsb_tie_limit(d.numel()):
        raise AssertionError(f"v5_bench {scheme}: max |err| {err}, {mism} "
                             "mismatches")
    ms = tr.events_ms(lambda: [bl.run() for _ in range(20)]) / 20
    return {"scheme": scheme, "max_abs_err": err, "mismatches": mism,
            "gold": stats(got, gold(x, kw["n_blocks"])), "ms": ms,
            "out_per_s": kw["n_blocks"] * g.R * B / (ms * 1e-3),
            "seconds": time.perf_counter() - t0}


def run(log=print) -> dict:
    """Both schemes, as the experiment prints them: max |d| and tie rate
    against the gold on lane 0, ms a launch and G out samples/s."""
    out = {s: measure(s) for s in SCHEMES}
    for s in SCHEMES:
        r = out[s]
        log(f"{s}: max|d|={r['gold']['max_abs_d']} tie rate="
            f"{r['gold']['rate']:.2e}; {r['ms']:.4f} ms/launch "
            f"{r['out_per_s'] / 1e9:.1f} G out/s ({r['mismatches']} ties "
            "against the plain version)")
    return out
