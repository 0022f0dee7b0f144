"""Variants of the fixed-point tensor-core kernel (K2d streamed, K1e / K1d
tiled: ``streamed_fir_fixed_kernel<n_accum>`` in both geometries), timed
and checked on one GPU.

    python3 tools/fixed_ablate.py [--parent CSRC_DIR] [--only NAME ...]
        [--launch KEY ...] [--lanes B]

Builds the port's kernel library once per variant of
``speex_resampler_tpu_torch/csrc/fixed_wgmma.cuh`` (a copy of ``csrc/``
with the variant's text edits under ``build/fixed_variants/<name>/``,
``tools/_variants.py``), then for each variant and each fixed launch of
``chip_smoke.py`` (44.1 kHz -> 48 kHz q7 tiled, n_accum 4; 48 kHz -> 44.1
kHz q10 streamed, n_accum 4; 24 kHz -> 48 kHz q5 tiled, n_accum 1, and its
weights on the streamed kernel) prints the kernel's time at B = 2048,
launches queued back to back and replayed from a CUDA graph
(``chip_smoke.cuda_ms``), its share of the bound, the rate of its
shared-memory copies (:func:`stage_bytes`: the streamed walk's stages of
weights and x, or the resident walk's x stages and band loads), and the
mismatch count
against the plain version at f0 = 0 and after the path's flush, B = 2048,
130, 129 (2-byte x loads) and 64, with the wrap input (an int32
accumulator past 2^31) on every third lane and x = -32768 and 32767 rows on
the others.  The variants:

- ``as built``: 16 rows x 4 column sets a warpgroup at n_accum 4 (N = 64,
  3 x 32 accumulator registers), 32 rows at n_accum 1, 64-lane CTAs;
  at n_accum 4 persistent CTAs (``fir_tiles``: min(tiles, SMs)), each
  holding a (phase, row tile) band resident in shared memory while it
  walks a contiguous run of tiles in band-major order and streaming x
  alone, where the launch's widest band fits and at least 6 tiles share
  a band (the resident walk; at every n_accum 4 launch here at B =
  2048), else walking every G-th tile with the weights streamed beside x
  (the streamed walk); at n_accum 1 a CTA a tile (``fir_tile``); the
  persistent CTA's copies 6 stages ahead (a ring of 8), the one-tile
  CTA's 3 (a ring of 5); 1 CTA an SM at n_accum 4, 2 (at most 128
  registers a thread) at n_accum 1;
- ``streamed band``: = as built on the streamed walk alone: every stage
  restages its weights (the parent's walk, but that x rows of a K-slice
  past a tile's band are not copied);
- ``one tile a CTA``: = as built, a CTA a tile at n_accum 4 too;
- ``n_accum 1 persistent``: = as built, persistent CTAs at n_accum 1 too
  (it spills);
- ``lead 3``, ``lead 5``: = as built, the persistent ring 3 or 5 stages
  ahead (6 as built, the most whose ring of 8 fits shared memory);
- ``1 CTA an SM``: = as built, 1 CTA an SM at n_accum 1 too;
- ``2 CTAs an SM``: = as built, 2 CTAs an SM at n_accum 4 too (it spills),
  with the one-tile ring 2 stages ahead (a ring of 4);
- ``resident walk alone``: = as built without the Q15 mix and the row
  stores (the accumulators folded into one word that a never-taken
  branch stores, so all 3 x 32 stay live);
- ``streamed walk alone``: = streamed band without the mix and the
  stores;
- ``equal runs``: = as built, each CTA's run of n_items / G tiles,
  not balanced by the bands' K-slices (at 44.1 kHz -> 48 kHz q7 a tenth
  of the bands span 6 K-slices, the rest 5; the band loads printed are
  the balanced runs');
- ``walk alone``: = one tile a CTA, without the mix and the stores;
- ``no walk``: = one tile a CTA without the walk: the tap table, the
  origin and the epilogue (the bias and coef loads, the mix and the
  stores) only.

Before a variant is timed, its SASS is held to :data:`PINS`: its fixed
kernels' IGMMA count and least registers from ``cuobjdump -sass`` and the
ptxas report, and no spill (but where the variant spills by design); a
variant off its pins is not timed and fails the run.  ``--launch``
restricts the launches (:data:`LAUNCHES`' keys); ``--lanes B`` times them
at B lanes instead of 2048 (and checks B among the lane counts): at 48
kHz -> 44.1 kHz q10, one block a phase, B <= 320 leaves fewer than 6
tiles a band, so the persistent CTAs walk it streamed.

With ``--parent``, a ``csrc/`` directory of an earlier checkout is built
too (``git archive <commit> speex_resampler_tpu_torch/csrc`` into
``build/``); its streamed fixed entry point (the CUDA-core kernel of a
checkout older than ``fixed_wgmma.cuh``: int16 weights [P, K, C] in tap
order and a 64-row tap table; else the tensor-core kernel on the step's
own weights, with the widest band's slice count where its entry point
takes one; both
geometries at their closed-form origins) is timed at the same launches
and every variant is held against it: all take exact sums mod 2^32 and
the same Q15 epilogue, so 0 outputs may differ.

Exits non-zero without a CUDA device, and after all variants have run if
any output of one differed from the plain version or the parent, or a
variant's SASS was off its pins.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import fixed_inputs  # noqa: E402  (tests/, put on the path by chip_smoke)
from speex_resampler_tpu_torch.ops import _build  # noqa: E402
from speex_resampler_tpu_torch.ops import streamed_fir as sf  # noqa: E402
from speex_resampler_tpu_torch.ops import tiled_fir as tf  # noqa: E402
from speex_resampler_tpu_torch.parallel import batch as tb  # noqa: E402
from tools import _variants  # noqa: E402

HEADER = "fixed_wgmma.cuh"
_MIN_BLOCKS = "kMinBlocks = kAccum == 1 ? 2 : 1;"
_PERSISTENT = "static constexpr bool kPersistent = kAccum == 4;"
_ONE_TILE = {_PERSISTENT: "static constexpr bool kPersistent = false;"}
_TILE_LEAD = "static constexpr int kTileLead = 6;"
# the resident walk's runs, balanced by K-slices
_RUNS = "    balanced_run(g, row_tiles, per_band, out, first, last);\n"
_EQUAL_RUNS = """    first = (int)((long long)blockIdx.x * n_items / n_ctas);
    last = (int)((long long)(blockIdx.x + 1) * n_items / n_ctas);
"""
# the launcher's rule for the resident walk, off
_STREAMED = {"streamed_fir.cu": {
    "return Shape::kPersistent && per_band >= Shape::kTileLead &&":
        "return false && per_band >= Shape::kTileLead &&"}}
# fir_tile's epilogue: its first barrier, after the walk's last wgmma wait
_EPILOGUE = ("  // every warpgroup's wgmmas are done before the ring takes the "
             "output tile\n  __syncthreads();\n")
_FOLD = """    unsigned fold = 0;
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int i = 0; i < Sh::kAcc; ++i) fold ^= (unsigned)acc[j][i];
    if (fold == 0x9e3779b9u && g.B < 0) g.y[tid] = (int16_t)fold;
"""
_WALK_ALONE = ("  {  // the walk alone: its sums kept, no Q15 mix and no "
               "stores\n" + _FOLD + "    return;\n  }\n")
_N_STAGES = """  const int n_stages =
      c.t_hi > t_begin ? (c.t_hi - t_begin + kStageTaps - 1) / kStageTaps : 0;
"""
# fir_tiles' epilogue, after the tile's last wgmma wait
_TILE_EPILOGUE = """    mix(head);
    __syncthreads();
    store(yrow, lane0);
"""
_TILES_WALK_ALONE = (
    "    {  // the walk alone: its sums kept, no Q15 mix and no stores\n"
    + "".join("  " + line + "\n" for line in _FOLD.splitlines())
    + "    }\n")
#: name -> (edits of the header, edits of other sources, computes the
#: function)
VARIANTS = {
    "as built": ({}, {}, True),
    # the persistent CTAs of the parent: weights restaged every stage
    "streamed band": ({}, _STREAMED, True),
    # the one-tile CTA of earlier checkouts, launched one a tile
    "one tile a CTA": (_ONE_TILE, {}, True),
    "n_accum 1 persistent": (
        {_PERSISTENT: "static constexpr bool kPersistent = true;"}, {},
        True),
    "lead 3": ({_TILE_LEAD: "static constexpr int kTileLead = 3;"}, {},
               True),
    "lead 5": ({_TILE_LEAD: "static constexpr int kTileLead = 5;"}, {},
               True),
    "1 CTA an SM": ({_MIN_BLOCKS: "kMinBlocks = 1;"}, {}, True),
    "2 CTAs an SM": ({_MIN_BLOCKS: "kMinBlocks = 2;",
                      "constexpr int kLead = 3;": "constexpr int kLead = 2;"},
                     {}, True),
    # the persistent walks without their epilogue's mix and stores
    "resident walk alone": ({_TILE_EPILOGUE: _TILES_WALK_ALONE}, {},
                            False),
    "streamed walk alone": ({_TILE_EPILOGUE: _TILES_WALK_ALONE}, _STREAMED,
                            False),
    "equal runs": ({_RUNS: _EQUAL_RUNS}, {}, True),
    # the one-tile CTA's split
    "walk alone": ({**_ONE_TILE, _EPILOGUE: _WALK_ALONE}, {}, False),
    # t_hi is read (the tap table's load stays), no stage is walked
    "no walk": ({**_ONE_TILE,
                 _N_STAGES: "  const int n_stages = c.t_hi < 0 ? 1 : 0;\n"},
                {}, False),
}
K2D, K1E, K1D = ("streamed_fir_fixed_kernel<4, false>",
                 "streamed_fir_fixed_kernel<4, true>",
                 "streamed_fir_fixed_kernel<1, true>")
#: variant -> {kernel: (IGMMA count, least registers)}; every other
#: variant's fixed kernels are printed, not held.  The persistent
#: kernel holds both walks, 8 IGMMA each
PINS = {
    "as built": {K2D: (16, 0), K1E: (16, 0), K1D: (8, 0)},
    "streamed band": {K2D: (16, 0), K1E: (16, 0), K1D: (8, 0)},
    "equal runs": {K2D: (16, 0), K1E: (16, 0), K1D: (8, 0)},
    "one tile a CTA": {K2D: (8, 0), K1E: (8, 0), K1D: (8, 0)},
    # three accumulators of 32 registers live through the walk
    "resident walk alone": {K2D: (16, 3 * 32), K1E: (16, 3 * 32)},
    "streamed walk alone": {K2D: (16, 3 * 32), K1E: (16, 3 * 32)},
    "walk alone": {K2D: (8, 3 * 32), K1E: (8, 3 * 32)},
    "no walk": {K2D: (8, 0), K1E: (8, 0)},
}
#: variants that spill by design (n_accum 1's persistent CTA: 20 bytes
#: at its 128-register cap)
SPILLS = {"2 CTAs an SM", "n_accum 1 persistent"}
#: variants whose persistent CTAs walk every launch streamed
STREAMED = {"streamed band", "streamed walk alone", "one tile a CTA",
            "walk alone", "no walk"}
#: name -> (chip_smoke path, geometry override)
LAUNCHES = {"q7": (cs.FIXED_FLAGSHIP, None), "q10": (cs.FIXED_SLICE, None),
            "q5": (cs.FIXED_DIRECT, None),
            "q5-streamed": (cs.FIXED_DIRECT, "streamed")}
CHECK_LANES = (cs.LANES, 130, 129, 64)
#: the parent's streamed fixed entry point: (hist, x, y, taps, w, coef,
#: n_accum, geometry ..., stream)
_PARENT_SIGNATURES = {
    "streamed_fir_fixed": (ctypes.c_int, [ctypes.c_void_p] * 6
                           + [ctypes.c_int] * 12 + [ctypes.c_void_p]),
}


def _fixed(kernel: str) -> bool:
    return "fixed" in kernel


def edge_inputs(step, n_in: int, B: int, seed: int, device="cuda"):
    """Launch inputs with the wrap input on every third lane (lane 0 mod 3,
    ``fixed_inputs.launch_inputs``) and rows of -32768 and 32767 on the
    other lanes, on ``device``."""
    hist, x = fixed_inputs.launch_inputs(step, n_in, B, seed, wrap=True)
    x[0:n_in:97, 1::3] = -32768
    x[1:n_in:89, 2::3] = 32767
    hist[::5, 1::3] = -32768
    return torch.from_numpy(hist).to(device), torch.from_numpy(x).to(device)


def stage_bytes(step, B: int = cs.LANES, ctas: int = 132) -> tuple:
    """(tiles, streamed bytes, resident bytes, band loads) of one launch's
    shared-memory copies at B lanes in the shipped kernel
    (``csrc/fixed_wgmma.cuh``), computed on the host from the step's tap
    table: each output tile walks its tap table entry's band, s K-slices
    from t_lo rounded down to 32 (1 where the entry is empty), in
    ceil(s / 2) 64-tap stages, and copies x's [32 s taps x 64 lanes]
    int16.  The streamed walk copies with each stage the two planes'
    [rows * n_accum x 64 taps] int8; the resident walk copies each band
    its CTA's run meets once (``streamed_fir.resident_runs`` on ``ctas``
    CTAs): its s K-slices of both planes and its rows * n_accum biases and
    as many coefs."""
    n_accum = step.kernel_kw["n_accum"]
    rows = tf.FIXED_ROWS[n_accum]
    taps = step.w[-1].cpu().numpy().astype(np.int64)        # [P, tiles, 2]
    lo, hi = taps[..., 0] // 32 * 32, taps[..., 1]
    slices = np.where(hi > lo, -(-(hi - lo) // 32), 1)      # [P, tiles]
    P, row_tiles = slices.shape
    n_blocks = step.kernel_kw["n_blocks"]
    lanes = -(-B // 64)
    walked = int(slices[np.arange(n_blocks) % P].sum()) * lanes
    staged = int(-(-slices[np.arange(n_blocks) % P] // 2).sum()) * lanes
    weights = 2 * rows * n_accum * 32                # a K-slice, two planes
    x = walked * 32 * 64 * 2
    tiles = n_blocks * row_tiles * lanes
    per_band = n_blocks // P * lanes
    runs = sf.resident_runs(step.w[-2], per_band, min(tiles, ctas))
    loaded = [b for first, last in runs if last > first
              for b in range(first // per_band, (last - 1) // per_band + 1)]
    band = sum(int(slices[divmod(b, row_tiles)]) * weights
               + 2 * rows * n_accum * 4 for b in loaded)
    return tiles, x + staged * 2 * weights, x + band, len(loaded)


def tiles_of(step, B: int = cs.LANES) -> int:
    """The output tiles of a fixed step's launch at B lanes."""
    kw = step.kernel_kw
    R = step.w[0].shape[2] // kw["n_accum"]
    return (kw["n_blocks"] * (R // tf.FIXED_ROWS[kw["n_accum"]])
            * -(-B // 64))


def parent_weights(step) -> tuple:
    """The CUDA-core parent's weights for ``step``: int16[P, K, C] taps in
    tap order (:func:`tiled_fir.fixed_taps16`), coef (n_accum 4) and its
    64-row tap table."""
    w16 = tf.fixed_taps16(step.w[0])
    n_accum = step.kernel_kw["n_accum"]
    P, K, C = w16.shape
    nonzero = (w16.reshape(P, K, n_accum, C // n_accum) != 0).any(dim=2)
    taps = torch.from_numpy(tf.tap_ranges(nonzero.cpu().numpy()))
    taps = taps.to(w16.device)
    return w16, (step.w[2] if n_accum == 4 else None), taps


def tensor_core_parent(csrc: Path) -> bool:
    """Whether a ``csrc/`` holds the tensor-core fixed kernel (the step's
    own weights) or the CUDA-core one."""
    return (csrc / HEADER).exists()


def parent_library(csrc: Path):
    """The library of another checkout's ``csrc/``, with the argument
    types of its streamed fixed entry point: the CUDA-core kernel's
    (:data:`_PARENT_SIGNATURES`), or the tensor-core kernel's, the step's
    own (``ops/_build``), without the launched-CTA count where its source
    has none."""
    out = ROOT / "build" / "fixed_variants" / "parent" / "libfir.so"
    shutil.rmtree(out.parent, ignore_errors=True)
    _build.use_csrc(csrc)
    _build.compile_library(out)
    lib = ctypes.CDLL(str(out))
    signatures = dict(_PARENT_SIGNATURES)
    if tensor_core_parent(csrc):
        restype, argtypes = _build._SIGNATURES["streamed_fir_fixed"]
        src = (csrc / "streamed_fir.cu").read_text()
        if "int* band_tiles" not in src:    # no slice count, no band count
            argtypes = argtypes[:8] + argtypes[9:-1]
            if "int* ctas" not in src:
                argtypes = argtypes[:-1]
        signatures["streamed_fir_fixed"] = (restype, argtypes)
    for name, (restype, argtypes) in signatures.items():
        getattr(lib, name).restype = restype
        getattr(lib, name).argtypes = argtypes
    print(f"parent {csrc}: " + _variants.ptxas(out.parent, _fixed))
    return lib


def parent_launch(lib, hist, x, step, weights):
    """The parent's kernel on one launch (``weights``: the CUDA-core
    kernel's, :func:`parent_weights`, or None: the step's own, for the
    tensor-core kernel): a function that launches it on the current
    stream, and its output."""
    kw = step.kernel_kw
    n_accum = kw["n_accum"]
    H, B = hist.shape
    if weights is None:
        _, P, C, K = step.w[0].shape
        ptrs = [step.w[-1].data_ptr(), step.w[0].data_ptr(),
                step.w[1].data_ptr(),
                step.w[2].data_ptr() if n_accum == 4 else None]
        # 23 arguments: the slice count and two counts (CTAs, tiles a
        # band); 21: the CTA count; 20: neither
        n_counts = {23: 2, 21: 1}.get(len(lib.streamed_fir_fixed.argtypes),
                                      0)
        extra = [ctypes.byref(ctypes.c_int(0)) for _ in range(n_counts)]
    else:
        w16, coef, taps = weights
        P, K, C = w16.shape
        ptrs = [taps.data_ptr(), w16.data_ptr(),
                coef.data_ptr() if coef is not None else None]
        extra = []
    R = C // n_accum
    y = torch.empty((kw["n_blocks"] * R, B), dtype=torch.int16,
                    device="cuda")

    # the widest band's slice count, where the entry point takes one
    slices = [step.w[-2].widest] if len(extra) == 2 else []

    def run():
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.streamed_fir_fixed(
            hist.data_ptr(), x.data_ptr(), y.data_ptr(), *ptrs, n_accum,
            *slices, H, x.shape[0], B, R, K, P, kw["n_blocks"], kw["shift"],
            kw["num"], kw["den"], kw["f0"], stream, *extra)
        if err:
            raise RuntimeError(f"parent kernel launch failed ({err})")
    return run, y


def sass_pins(name: str) -> list:
    """The loaded variant's streamed fixed kernels against :data:`PINS`
    (``_variants.sass_pins``); returns what is off its pins."""
    return _variants.sass_pins(
        name, lambda k: _fixed(k) and k.startswith("streamed"), PINS, SPILLS)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--only", nargs="*", default=None)
    ap.add_argument("--launch", nargs="*", default=None,
                    choices=sorted(LAUNCHES))
    ap.add_argument("--lanes", type=int, default=cs.LANES)
    args = ap.parse_args()
    lanes = args.lanes
    check = (lanes,) + tuple(B for B in CHECK_LANES if B != lanes)
    if not torch.cuda.is_available():
        sys.exit("fixed_ablate: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    cases = []
    for key, (path, kernel) in LAUNCHES.items():
        if args.launch and key not in args.launch:
            continue
        for f0 in sorted({0, path.f0_flush}):
            bspec = path.geometry(f0)
            if kernel is not None:
                bspec = dataclasses.replace(bspec, kernel=kernel)
            step = tb.make_batched_step(path.spec, bspec, device="cuda")
            assert step.scheme == "fixed" and step.kernel == bspec.kernel
            n_accum = step.kernel_kw["n_accum"]
            inputs = [edge_inputs(step, bspec.in_per_launch, B, seed=B + f0)
                      for B in check]
            want = [cs.plain(h, x, step).cpu().numpy() for h, x in inputs]
            bound = cs.launch_bound(path.spec, step, bspec, lanes)
            cases.append((f"{path.name} on {step.kernel} "
                          f"({cs.kernel_name(step.kernel, 'fixed', n_accum)})"
                          f" f0 {f0}", step, inputs, want, bound))
    parent = None
    if args.parent is not None:
        lib = parent_library(args.parent)
        parent = []
        for label, step, inputs, _, _ in cases:
            weights = (None if tensor_core_parent(args.parent)
                       else parent_weights(step))
            outs = []
            for h, x in inputs:
                run, y = parent_launch(lib, h, x, step, weights)
                run()
                torch.cuda.synchronize()
                outs.append(y.cpu().numpy())
            parent.append(outs)
            run, _ = parent_launch(lib, *inputs[0], step, weights)
            print(f"   parent, {label}: {cs.cuda_ms(run, 20):.4f} ms back "
                  f"to back, graph {cs.cuda_ms(run, 20, mode='graph'):.4f} "
                  f"ms at B = {lanes}")
            del weights
    bad = []
    for name, (edits, also, exact) in VARIANTS.items():
        if args.only and name not in args.only:
            continue
        print(f"== {name}: " + _variants.build("fixed_variants", name, HEADER,
                                               edits, _fixed, also))
        off = sass_pins(name)
        if off:
            bad.append(f"{name}: SASS off its pins: " + "; ".join(off))
            print(f"   {name}: not timed, SASS off its pins: "
                  + "; ".join(off))
            continue
        for c, (label, step, inputs, want, bound) in enumerate(cases):
            line = []
            for b, ((h, x), w) in enumerate(zip(inputs, want)):
                if not exact:
                    break
                got = cs.launch(h, x, step).cpu().numpy()
                n = [int((got != w).sum())]
                line.append(f"B={h.shape[1]} mismatches {n[0]}")
                if parent is not None:
                    n.append(int((got != parent[c][b]).sum()))
                    line[-1] += f", vs parent {n[1]} differ"
                if any(n):
                    bad.append(f"{name}, {label}, B={h.shape[1]}")
            h, x = inputs[0]
            fn = lambda: cs.launch(h, x, step)  # noqa: E731
            ms, graph_ms = cs.cuda_ms(fn, 20), cs.cuda_ms(fn, 20, mode="graph")
            lib = _build.load()
            kw = step.kernel_kw
            ctas = min(torch.cuda.get_device_properties(0)
                       .multi_processor_count, tiles_of(step, lanes))
            tiles, streamed, resident, loads = stage_bytes(step, lanes, ctas)
            if name in STREAMED or not lib.fixed_fir_band_tiles(
                    kw["n_accum"], step.w[-2].widest, kw["n_blocks"],
                    step.w[-1].shape[0], lanes):
                nbytes, what = streamed, "stages of weights and x"
            else:
                nbytes, what = resident, f"x stages and {loads} band loads"
            line.append(f"{ms:.4f} ms back to back, graph {graph_ms:.4f} ms,"
                        f" {bound[0] / ms:.3f} of the bound {bound[0]:.4f} ms"
                        f"; {tiles} tiles copy {nbytes / 1e9:.3f} GB of "
                        f"{what}: {nbytes / ms / 1e9:.2f} TB/s")
            print(f"   {name}, {label}: " + "; ".join(line))
    if bad:
        sys.exit("fixed_ablate: failed: " + "; ".join(bad))


if __name__ == "__main__":
    main()
