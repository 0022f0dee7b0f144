"""The resident-operand tensor-core rate kernel (probes P3 and P4).

Counterpart of the Pallas kernel of ``experiments/mxu_peak.py`` (``make_fn``,
``pallas_call`` :68) and of ``experiments/mxu_shape_probe.py`` (``make_fn``,
:53): with W [C, K] and x [8, K, LB], values in [-128, 128) as int8 (int32
sums) or bf16 (f32 sums, stored as int32), a grid step i writes

    out[i % 16] = sum_{r < 8} W . x[r]

so the function of a launch of 16 or more steps is that body in all 16
slots, int32 [16, C, LB].  :func:`tc_rate` returns it.

The kernel (``csrc/probes/tc_rate.cu``) holds its operands resident in
shared memory and repeats the body ``iters`` times on every SM; the rate
is the slope of the launch time between two iteration counts
(:func:`measure`).  Its operand roles are the served kernels': the lanes
are the wgmma's M and x the register operand (int8: the taps of each
32-tap group in ``tiled_fir.K_PERM`` order, as an ldmatrix.trans of the
[tap][lane] rows gives them; :func:`pack` permutes W's columns to match),
W the shared-memory operand, its C rows the wgmma's N in tiles of 32, 64,
128 or 256 (:func:`plan`).  K is padded with zero weights to a multiple of
32.  Where one CTA cannot hold its W tile and all 8 x blocks (227 KB), the
8 dot chains are split over 8 / rs CTAs whose partial tiles a second
kernel adds.

The same kernel runs probe P7's wider integer forms (``na`` bytes of W,
``nb`` of x; :mod:`.mosaic_int_dot_bench`): the operands' byte planes, the
digit products with a + b < 4 on the int8 tensor cores
(:meth:`RateLaunch.of_planes`).

:func:`rate_reference` is the plain version: integer products exact in
int64 (``torch.matmul`` on CPU int64; float64 on the card, exact below
2^53), reduced mod 2^32; bf16 products as float32 matmuls with TF32 off.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..ops import _build
from ..ops.tiled_fir import _no_tf32, full_perm, wrap_int32

__all__ = ["N_REPS", "SLOTS", "DTYPES", "N_TILES", "DIGIT_CASES",
           "DATASHEET_MACS",
           "pad_k", "smem_bytes", "Plan", "plan", "pack", "exact_matmul",
           "rate_reference", "tc_rate", "RateLaunch", "operands",
           "measure", "library_call", "library_rate", "events_ms", "slope_ms",
           "launches"]

N_REPS = 8             # x blocks a body sums (the TPU probe's N_REPS)
SLOTS = 16             # output slots: step i writes slot i % 16
LANES = 64             # a CTA's lanes: the wgmma's M
K_STEP = 32            # K is padded to a multiple of it
DTYPES = ("int8", "bf16")
N_TILES = (32, 64, 128, 256)
#: (na, nb, N-tile) of the wider integer forms the source instantiates:
#: the widest N-tile whose accumulators fit beside the fragments
DIGIT_CASES = ((2, 1, 128), (2, 2, 128), (4, 4, 64))
MAX_SMEM = 232448      # dynamic shared memory a CTA can have on the H100
SM_SMEM = 233472       # shared memory of an SM
CTA_RESERVED = 1024    # of it, reserved for each resident CTA
#: NVIDIA H100 SXM datasheet, dense, at 700 W: 1,979 TOP/s int8 and 989
#: TFLOP/s bf16, two operations a multiply-add
DATASHEET_MACS = {"int8": 989.5e12, "bf16": 494.5e12}

#: kernel launches (the rate kernel's; the partial sum rides with them)
launches = 0


def pad_k(K: int) -> int:
    return -(-K // K_STEP) * K_STEP


def smem_bytes(dtype: str, n: int, K_pad: int, rs: int, na: int = 1,
               nb: int = 1) -> int:
    """A CTA's dynamic shared memory (``smem_bytes`` in the source): W's
    na digit tiles [n, K_pad], rs x blocks of nb digits [K_pad, 64 lanes]
    with 16-byte padded rows, 128 bytes of alignment."""
    es = 2 if dtype == "bf16" else 1
    return na * n * K_pad * es + rs * nb * K_pad * (LANES * es + 16) + 128


@dataclasses.dataclass(frozen=True)
class Plan:
    """A launch's tiling: wgmma N-tile n, rs x blocks a CTA (8 / rs groups
    of CTAs split the 8 dot chains); na and nb bytes of W and of x."""

    dtype: str
    C: int
    K: int
    LB: int
    n: int
    rs: int
    na: int = 1
    nb: int = 1

    @property
    def kernel(self) -> str:
        """The kernel's name with its template arguments."""
        return (f"tc_rate_kernel<{str(self.dtype == 'bf16').lower()}, "
                f"{self.n}, {self.na}, {self.nb}>")

    @property
    def K_pad(self) -> int:
        return pad_k(self.K)

    @property
    def groups(self) -> int:
        return N_REPS // self.rs

    @property
    def units(self) -> int:
        return (self.C // self.n) * (self.LB // LANES) * self.groups

    @property
    def smem(self) -> int:
        return smem_bytes(self.dtype, self.n, self.K_pad, self.rs, self.na,
                          self.nb)

    @property
    def needed_macs(self) -> int:
        """Multiply-adds of one body, the TPU probe's N_REPS * C * K * LB."""
        return N_REPS * self.C * self.K * self.LB

    @property
    def walked_macs(self) -> int:
        """Multiply-adds the tiles walk for one body (K_pad taps)."""
        return N_REPS * self.C * self.K_pad * self.LB


def plan(dtype: str, C: int, K: int, LB: int, n: int | None = None,
         per_sm: int = 1, na: int = 1, nb: int = 1) -> Plan:
    """The tiling of one case: N-tile ``n`` (default: C, at most 256; for
    na, nb > 1 the form's own, DIGIT_CASES) and the most x blocks a CTA
    (fewest partial tiles) such that ``per_sm`` CTAs (one warpgroup each)
    fit in an SM's shared memory.  Without ``n``, a smaller N-tile is taken
    where not even one x block fits beside the W tile.  Raises ValueError
    if nothing fits."""
    if dtype not in DTYPES:
        raise ValueError(f"dtype {dtype!r} not in {DTYPES}")
    if (na, nb) != (1, 1):
        tile = {(a, b): t for a, b, t in DIGIT_CASES}.get((na, nb))
        if dtype != "int8" or tile is None or n not in (None, tile):
            raise ValueError(f"no {dtype} form of {na}, {nb} bytes at N-tile "
                             f"{n}: {DIGIT_CASES}")
        n = tile
    if LB % LANES or C <= 0 or K <= 0:
        raise ValueError(f"LB {LB} must be a multiple of {LANES}")
    limit = min(MAX_SMEM, SM_SMEM // per_sm - CTA_RESERVED)
    tiles = [n] if n is not None else [t for t in N_TILES[::-1]
                                       if t <= min(C, 256)]
    for t in tiles:
        if t not in N_TILES or C % t:
            raise ValueError(f"N-tile {t} must be one of {N_TILES} and "
                             f"divide C = {C}")
        for rs in (8, 4, 2, 1):
            p = Plan(dtype, C, K, LB, t, rs, na, nb)
            if p.smem <= limit:
                return p
    raise ValueError(f"no tiling of {dtype} [{C}, {K}] x {LB} fits "
                     f"{limit} bytes")


def pack(w: torch.Tensor, x: torch.Tensor, dtype: str):
    """(W int8 / bf16 [C, K_pad], x [8, K_pad, LB]) as the kernel reads
    them, on the inputs' device: K padded with zeros; for int8 each 32-tap
    group of W's columns in K_PERM order (column 32*i + k holds tap 32*i +
    K_PERM[k]), which the fragment's tap order needs; x in tap order."""
    C, K = w.shape
    K_pad = pad_k(K)
    t = torch.int8 if dtype == "int8" else torch.bfloat16
    wp = torch.zeros((C, K_pad), dtype=t, device=w.device)
    wp[:, :K] = w.to(t)
    xp = torch.zeros((x.shape[0], K_pad, x.shape[2]), dtype=t,
                     device=x.device)
    xp[:, :K] = x.to(t)
    if dtype == "int8":
        perm = torch.from_numpy(full_perm(K_pad)).to(w.device)
        wp = wp[:, perm].contiguous()
    return wp, xp


def exact_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b exactly, int64, for integer-valued tensors whose sums stay
    below 2^53 in magnitude: int64 matmul on the CPU, float64 on the card
    (which has no int64 matmul)."""
    if a.device.type == "cpu":
        return torch.matmul(a.to(torch.int64), b.to(torch.int64))
    return torch.matmul(a.to(torch.float64),
                        b.to(torch.float64)).round().to(torch.int64)


def _check(w: torch.Tensor, x: torch.Tensor, dtype: str) -> None:
    if dtype not in DTYPES:
        raise ValueError(f"dtype {dtype!r} not in {DTYPES}")
    if w.dim() != 2 or x.dim() != 3 or x.shape[0] != N_REPS \
            or x.shape[1] != w.shape[1]:
        raise ValueError(f"w [C, K] and x [{N_REPS}, K, LB]: got "
                         f"{tuple(w.shape)}, {tuple(x.shape)}")
    if w.device != x.device:
        raise ValueError(f"w on {w.device}, x on {x.device}")
    for t in (w, x):
        if t.is_floating_point() and not torch.equal(t, t.round()):
            raise ValueError("w and x must hold integers")
        if t.numel() and (int(t.min()) < -128 or int(t.max()) > 127):
            raise ValueError("w and x must lie in [-128, 128)")


def rate_reference(w: torch.Tensor, x: torch.Tensor,
                   dtype: str = "int8") -> torch.Tensor:
    """The plain version: int32 [16, C, LB], the body sum_r W . x[r] in
    every slot (int8: exact, mod 2^32; bf16: float32 sums of exact
    products with TF32 off, r in order, cast to int32)."""
    _check(w, x, dtype)
    if dtype == "int8":
        acc = sum(exact_matmul(w, x[r]) for r in range(N_REPS))
        body = wrap_int32(acc)
    else:
        wf = w.to(torch.bfloat16).to(torch.float32)
        xf = x.to(torch.bfloat16).to(torch.float32)
        with _no_tf32():
            acc = torch.zeros((w.shape[0], x.shape[2]), dtype=torch.float32,
                              device=w.device)
            for r in range(N_REPS):
                acc = acc + torch.matmul(wf, xf[r])
        body = acc.to(torch.int32)
    return body.unsqueeze(0).repeat(SLOTS, 1, 1)


class RateLaunch:
    """The kernel's launches on packed operands (CUDA tensors): out int32
    [16, C, LB], the partial tiles where 8 / rs > 1, the CTA copies'
    scratch tiles.  ``run(iters)`` launches on the current stream."""

    def __init__(self, w: torch.Tensor, x: torch.Tensor, dtype: str,
                 n: int | None = None, fill: bool = True, per_sm: int = 1):
        _check(w, x, dtype)
        p = plan(dtype, w.shape[0], w.shape[1], x.shape[2], n, per_sm)
        self._setup(p, *pack(w, x, dtype), fill)

    @classmethod
    def of_planes(cls, wp: torch.Tensor, xp: torch.Tensor, p: Plan,
                  fill: bool = True) -> "RateLaunch":
        """A launch of operands already in the kernel's layout: an integer
        form's byte planes, W's uint8 [na, C, K_pad] (each 32-tap group in
        K_PERM order) and x's [nb, 8, K_pad, LB], tiled by ``p``."""
        self = cls.__new__(cls)
        self._setup(p, wp, xp, fill)
        return self

    def _setup(self, p: Plan, wp: torch.Tensor, xp: torch.Tensor,
               fill: bool) -> None:
        self.plan = p
        self.lib = lib = _build.load_probes()
        bf16 = int(p.dtype == "bf16")
        if lib.probe_tc_rate_smem(bf16, p.n, p.na, p.nb, p.K_pad,
                                  p.rs) != p.smem:
            raise RuntimeError("csrc/probes/tc_rate.cu shared memory "
                               "disagrees with probes/tc_rate.smem_bytes")
        self.wp, self.xp = wp, xp
        C, LB, dev = p.C, p.LB, wp.device
        with torch.cuda.device(dev):
            n_ctas = (lib.probe_tc_rate_fill(bf16, p.n, p.na, p.nb, C,
                                             p.K_pad, LB, p.rs)
                      if fill else p.units)
        if n_ctas < 0:
            raise RuntimeError("tc_rate occupancy query failed: "
                               + lib.probe_error_string(n_ctas).decode())
        self.n_ctas = n_ctas
        self.out = torch.empty((SLOTS, C, LB), dtype=torch.int32, device=dev)
        self.partial = (torch.empty((p.groups, SLOTS, C, LB),
                                    dtype=torch.int32, device=dev)
                        if p.groups > 1 else None)
        self.scratch = torch.empty((max(n_ctas - p.units, 1), p.n, LANES),
                                   dtype=torch.int32, device=dev)
        self._bf16 = bf16

    @property
    def bodies_per_iter(self) -> float:
        """Bodies (W . x over the 8 blocks) an iteration computes."""
        return self.n_ctas / self.plan.units

    @property
    def needed_macs(self) -> float:
        """Multiply-adds one iteration of the launch needs (every copy)."""
        return self.bodies_per_iter * self.plan.needed_macs

    @property
    def walked_macs(self) -> float:
        return self.bodies_per_iter * self.plan.walked_macs

    def run(self, iters: int) -> torch.Tensor:
        global launches
        p, dev = self.plan, self.wp.device
        with torch.cuda.device(dev):
            err = self.lib.probe_tc_rate(
                self.wp.data_ptr(), self.xp.data_ptr(), self.out.data_ptr(),
                None if self.partial is None else self.partial.data_ptr(),
                self.scratch.data_ptr(), self._bf16, p.n, p.na, p.nb, p.C,
                p.K_pad, p.LB, p.rs, self.n_ctas, iters, 0,
                _build.stream_handle(dev))
        if err:
            raise RuntimeError("tc_rate kernel launch failed: "
                               + self.lib.probe_error_string(err).decode())
        launches += 1
        return self.out


def tc_rate(w: torch.Tensor, x: torch.Tensor, dtype: str = "int8", *,
            n: int | None = None, iters: int = SLOTS) -> torch.Tensor:
    """The probe's function, int32 [16, C, LB]: the kernel for CUDA
    tensors (one launch of ``iters`` >= 16 iterations, one copy of each
    tile), the plain version for CPU tensors."""
    if w.device.type == "cpu" and x.device.type == "cpu":
        return rate_reference(w, x, dtype)
    if w.device.type != "cuda":
        raise ValueError(f"no kernel for device {w.device}")
    if iters < SLOTS:
        raise ValueError(f"iters {iters} < {SLOTS} leaves slots unwritten")
    return RateLaunch(w, x, dtype, n, fill=False).run(iters).clone()


def operands(C: int, K: int, LB: int, seed: int = 0, device="cpu"):
    """The TPU probe's operands: W [C, K] and x [8, K, LB], int16 values in
    [-128, 128) from ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    w = rng.integers(-128, 128, size=(C, K)).astype(np.int16)
    x = rng.integers(-128, 128, size=(N_REPS, K, LB)).astype(np.int16)
    return (torch.from_numpy(w).to(device), torch.from_numpy(x).to(device))


def events_ms(fn, reps: int = 5) -> float:
    """Median device ms of ``fn()`` between two CUDA events, after one
    warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def slope_ms(run, work_per_iter: float, peak: float,
             target_ms: float = 20.0) -> dict:
    """ms an iteration of ``run(iters)``: the slope of its launch time
    between two iteration counts, sized so the longer launch takes about
    ``target_ms`` at half of ``peak`` (a rate, for ``work_per_iter``);
    launch and fill costs fall out of the difference."""
    est_ms = work_per_iter / (0.5 * peak) * 1e3
    it2 = int(min(max(target_ms / est_ms, 8 * SLOTS), 1 << 22))
    it1 = max(SLOTS, it2 // 8)
    ms1 = events_ms(lambda: run(it1))
    ms2 = events_ms(lambda: run(it2))
    return {"it1": it1, "it2": it2, "ms1": ms1, "ms2": ms2,
            "slope_ms": (ms2 - ms1) / (it2 - it1)}


def library_call(w: torch.Tensor, x: torch.Tensor, dtype: str):
    """The yardstick, as a function: one PyTorch call computing the body,
    [W ... W] (8 copies along K) . [x[0]; ...; x[7]], operands in device
    memory: ``torch._int_mm`` (int8 -> int32) or a bf16 ``torch.mm`` with a
    float32 result.  The port never calls it."""
    K = w.shape[1]
    wcat = w.repeat(1, N_REPS)                            # [C, 8K]
    xcat = x.reshape(N_REPS * K, -1)                      # [8K, LB]
    if dtype == "int8":
        a = wcat.to(torch.int8).contiguous()
        b = xcat.to(torch.int8).t().contiguous().t()       # column-major
        return lambda: torch._int_mm(a, b)
    a = wcat.to(torch.bfloat16).contiguous()
    b = xcat.to(torch.bfloat16).contiguous()
    return lambda: torch.mm(a, b, out_dtype=torch.float32)


def library_rate(w: torch.Tensor, x: torch.Tensor, dtype: str) -> dict:
    """:func:`library_call`'s ms (median of 5 after a warm-up), T
    multiply-adds a second and mismatches against the plain version."""
    fn = library_call(w, x, dtype)
    got = fn().to(torch.int32)
    want = rate_reference(w, x, dtype)[0]
    ms = events_ms(fn)
    return {"ms": ms, "tmacs": N_REPS * w.numel() * x.shape[2] / ms / 1e9,
            "mismatches": int((got != want).sum())}


def _library_or_error(w, x, dtype) -> dict:
    """:func:`library_rate`, or the error it raised: a yardstick that the
    installed PyTorch refuses leaves the probe's own numbers standing."""
    try:
        return library_rate(w, x, dtype)
    except (RuntimeError, TypeError) as e:
        return {"error": str(e).splitlines()[0][:200]}


def measure(dtype: str, C: int, K: int, LB: int = 128,
            n: int | None = None, seed: int = 0, target_ms: float = 20.0,
            per_sm: int = 1) -> dict:
    """One case on the card: the kernel held against its plain version (a
    mismatch raises), then its rate from the slope (every SM busy, the
    copies of the function's tiles counted), over the needed and the walked
    multiply-adds, and the library call's rate at the same product."""
    w, x = operands(C, K, LB, seed, device="cuda")
    t0 = time.perf_counter()
    rl = RateLaunch(w, x, dtype, n, per_sm=per_sm)
    got = rl.run(SLOTS).clone()
    want = rate_reference(w, x, dtype)
    mism = int((got != want).sum())
    if mism:
        raise AssertionError(f"tc_rate {dtype} [{C}, {K}] x {LB} n "
                             f"{rl.plan.n}: {mism} mismatches")
    peak = DATASHEET_MACS[dtype]
    s = slope_ms(rl.run, rl.walked_macs, peak, target_ms)
    needed = rl.needed_macs / (s["slope_ms"] * 1e-3)
    walked = rl.walked_macs / (s["slope_ms"] * 1e-3)
    p = rl.plan
    return {"dtype": dtype, "C": C, "K": K, "LB": LB, "K_pad": p.K_pad,
            "n": p.n, "rs": p.rs, "groups": p.groups, "smem": p.smem,
            "units": p.units, "n_ctas": rl.n_ctas, "per_sm": per_sm,
            "mismatches": mism,
            **s, "tmacs_needed": needed / 1e12, "tmacs_walked": walked / 1e12,
            "share_of_datasheet": needed / peak,
            "library": _library_or_error(w, x, dtype),
            "seconds": time.perf_counter() - t0}
