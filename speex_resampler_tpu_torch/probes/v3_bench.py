"""The f32 conv without history and the production-shaped step around it
(probe P12).

Counterpart of ``experiments/v3_bench.py`` (``conv_v3`` :57, its
``pallas_call`` :58; its ``step`` :99): the phase-tiled weights of 44.1
kHz -> 48 kHz q7 (``build_phase_tiled_weights(phase_table, 147, 160,
0)``), 4 periods (80 blocks), x int16 [T, B], T = 9552.

- ``conv_v3`` is probe P6's ``full`` variant exactly (the same weights, T
  and read ``x[j * S + offsets[m] : + K]``): :func:`conv` launches P6's
  kernel (``csrc/probes/f32_anatomy.cu``, ``f32_anatomy_kernel<0>``, the
  served highest body) through :mod:`.kernel_anatomy`, whose launch count
  it moves; the plain version is P6's.
- ``step``: ``X = concat(hist [filt_len - 1, B], chunk [n_in, B], zeros
  [17, B])``, then the conv, then the next history ``X[n_in : n_in +
  filt_len - 1]``, plain torch around the kernel (:func:`step`), timed
  eagerly and as a CUDA graph replay beside the served ``highest`` step
  at the flagship (``make_batched_step``, the step that reads its history
  inside the kernel): the gap between the step and the conv alone is the
  concat's copy.
"""

from __future__ import annotations

import functools
import time

import torch

from ..ops import filter_design as fd
from ..ops.convert import lsb_tie_limit
from ..parallel import batch as tb
from . import kernel_anatomy as ka
from . import tc_rate as tr
from . import v5_int8_bench as v5

__all__ = ["B", "N_PERIODS", "TARGET_IN", "filt_len", "inputs",
           "conv_reference", "conv", "step", "step_reference", "served_step",
           "graph_ms", "measure", "run"]

B = ka.B
N_PERIODS = ka.N_PERIODS
TARGET_IN = 9408          # the served flagship's quantum (4 periods)


@functools.lru_cache(maxsize=1)
def filt_len() -> int:
    return fd.design_filter(147, 160, 7).filt_len


def inputs(g: ka.Geometry, B: int = B, seed: int = 0, device="cpu"):
    """The experiment's x int16 [T, B] (``rng.integers(-32768, 32768) //
    2``) at P6's geometry (:func:`.kernel_anatomy.geometry`, the
    experiment's P, K, R, S, T and weights; its weights and launch
    keywords are P6's too), and its step's chunk (x's first n_in rows) and
    first history (zeros, [filt_len - 1, B])."""
    x = ka.inputs(g, B=B, seed=seed, device=device)
    n_in = N_PERIODS * g.S
    hist = x.new_zeros((filt_len() - 1, x.shape[1]))
    return x, x[:n_in], hist


def conv_reference(x: torch.Tensor, w: tuple, *, offsets: torch.Tensor,
                   S: int, n_blocks: int) -> torch.Tensor:
    """The plain version of ``conv_v3``: P6's ``full``
    (:func:`.kernel_anatomy.anatomy_reference`)."""
    return ka.anatomy_reference("full", x, w, offsets=offsets, S=S,
                                n_blocks=n_blocks)


def conv(x: torch.Tensor, w: tuple, *, offsets: torch.Tensor, S: int,
         n_blocks: int) -> torch.Tensor:
    """``conv_v3``, int16 [n_blocks * R, B]: P6's ``full`` kernel for CUDA
    tensors, its plain version for CPU tensors."""
    return ka.anatomy("full", x, w, offsets=offsets, S=S, n_blocks=n_blocks)


def _step(fn, hist, chunk, w, kw):
    N1, T = hist.shape[0], ka.geometry().T
    pad = chunk.new_zeros((T - N1 - chunk.shape[0], chunk.shape[1]))
    X = torch.cat([hist, chunk, pad])
    y = fn(X, w, **kw)
    n_in = chunk.shape[0]
    return X[n_in:n_in + N1], y


def step(hist: torch.Tensor, chunk: torch.Tensor, w: tuple, *,
         offsets: torch.Tensor, S: int, n_blocks: int):
    """The experiment's ``step``: (next history int16 [filt_len - 1, B], y
    int16 [n_blocks * R, B]) from the concat of hist, chunk and zero rows
    up to T, the conv (:func:`conv`: the kernel for CUDA tensors) and the
    concat's rows n_in .. n_in + filt_len - 1."""
    return _step(conv, hist, chunk, w,
                 dict(offsets=offsets, S=S, n_blocks=n_blocks))


def step_reference(hist: torch.Tensor, chunk: torch.Tensor, w: tuple, *,
                   offsets: torch.Tensor, S: int, n_blocks: int):
    """:func:`step` with the conv's plain version."""
    return _step(conv_reference, hist, chunk, w,
                 dict(offsets=offsets, S=S, n_blocks=n_blocks))


def served_step(device="cuda", B: int = B, seed: int = 0):
    """The served ``highest`` step at the flagship (``make_batched_step``,
    44.1 kHz -> 48 kHz q7, 9408-frame quanta) and its inputs (a random
    history and chunk, zeros past the chunk): (step, hist, x)."""
    spec = fd.design_filter(147, 160, 7)
    bspec = tb._launch_geometry(spec, TARGET_IN)
    st = tb.make_batched_step(spec, bspec, device=device, scheme="highest")
    g = torch.Generator().manual_seed(seed)
    hist = torch.randint(-32768, 32768, (st.hist_rows, B), generator=g,
                         dtype=torch.int32).to(torch.int16)
    x = torch.zeros((st.chunk_rows, B), dtype=torch.int16)
    x[:bspec.in_per_launch] = torch.randint(
        -16384, 16384, (bspec.in_per_launch, B), generator=g,
        dtype=torch.int32).to(torch.int16)
    return st, hist.to(device), x.to(device)


def graph_ms(fn, reps: int = 20) -> float:
    """Device ms of one call of ``fn``: ``reps`` calls captured in one CUDA
    graph (after 3 on a side stream), the replay timed between two events
    (median of 5), over ``reps``: the device's time without the host's."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    ms = tr.events_ms(graph.replay) / reps
    del graph
    return ms


def measure(seed: int = 0) -> dict:
    """On the card: the conv held against its plain version (max |err| <=
    1 within the tie bound), its max |d| and tie rate against the float64
    gold on lane 0; ms a launch of the conv alone, of the step (eager, 20
    queued, and from a CUDA graph) and of the served highest step (both
    ways); the step less the conv is the concat's cost."""
    t0 = time.perf_counter()
    g = ka.geometry()
    x, chunk, hist = inputs(g, seed=seed, device="cuda")
    w, kw = ka.weights(g, "cuda"), ka.launch_kw(g, "cuda")
    got = conv(x, w, **kw).clone()
    d = (got.int() - conv_reference(x, w, **kw).int()).abs()
    err, mism = int(d.max()), int((d > 0).sum())
    if err > 1 or mism > lsb_tie_limit(d.numel()):
        raise AssertionError(f"v3_bench conv: max |err| {err}, {mism} "
                             "mismatches")
    h2, y2 = step(hist, chunk, w, **kw)
    h3, y3 = step_reference(hist, chunk, w, **kw)
    ds = (y2.int() - y3.int()).abs()
    if not torch.equal(h2, h3) or not torch.equal(h2, chunk[-hist.shape[0]:]) \
            or int(ds.max()) > 1 \
            or int((ds > 0).sum()) > lsb_tie_limit(ds.numel()):
        raise AssertionError("v3_bench step: not its plain version")
    al = ka.AnatomyLaunch("full", x, w, **kw)
    conv_ms = tr.events_ms(lambda: [al.run() for _ in range(20)]) / 20
    state = [hist]

    def one():
        state[0] = step(state[0], chunk, w, **kw)[0]
    step_ms = tr.events_ms(lambda: [one() for _ in range(20)]) / 20
    step_graph = graph_ms(one)
    st, sh, sx = served_step(seed=seed)
    served_ms = tr.events_ms(
        lambda: [st.fn(sh, sx, st.w) for _ in range(20)]) / 20
    served_graph = graph_ms(lambda: st.fn(sh, sx, st.w))
    return {"max_abs_err": err, "mismatches": mism,
            "gold": v5.stats(got, v5.gold(x, kw["n_blocks"])),
            "conv_ms": conv_ms, "step_ms": step_ms,
            "step_graph_ms": step_graph,
            "concat_ms": step_graph - conv_ms,
            "served_step_ms": served_ms, "served_step_graph_ms": served_graph,
            "seconds": time.perf_counter() - t0}


def run(log=print) -> dict:
    """The conv, the step and the served step, as the experiment prints
    them: lane 0 against the gold, ms a launch and G samples/s."""
    r = measure()
    g = ka.geometry()
    n = N_PERIODS * g.P * g.R * B
    log(f"v3 lane0 max|d|={r['gold']['max_abs_d']} rate="
        f"{r['gold']['rate']:.2e}")
    for name in ("conv", "step", "step_graph", "served_step",
                 "served_step_graph"):
        ms = r[f"{name}_ms"]
        log(f"{name:18s} {ms:.4f} ms/launch  {n / ms / 1e6:.1f} Gsample/s "
            "out")
    log(f"concat (step graph - conv) {r['concat_ms']:.4f} ms")
    return r
