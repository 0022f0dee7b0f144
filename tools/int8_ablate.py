"""Variants of the int8 tensor-core kernels, the tiled K1b
(``tiled_fir_int8_kernel``) and the streamed K2b
(``streamed_fir_int8_kernel``), timed and checked on one GPU.

    python3 tools/int8_ablate.py [--parent CSRC_DIR] [--only NAME ...]

Builds the port's kernel library once per variant of
``speex_resampler_tpu_torch/csrc/int8_wgmma.cuh`` (a copy of ``csrc/``
with the variant's text edits under ``build/int8_variants/<name>/``,
``tools/_variants.py``), then for each variant and each int8 launch it
concerns prints the kernel's time at B = 2048, launches queued back to
back and replayed from a CUDA graph (``chip_smoke.cuda_ms``), its share of
the bound, and the mismatch count against the plain version at f0 = 0 and
after the path's flush, B = 2048, 130, 129 (2-byte x loads) and 64, with x
= -32768 and 32767 rows in every launch.  The launches: the tiled flagship
(44.1 kHz -> 48 kHz q7, "auto" = int8, D = 3), and the streamed 48 kHz ->
44.1 kHz q10 ("auto", D = 4, explicit "int8", D = 3, and its weights
decomposed into D = 2 and 1 digit planes, :func:`with_digits`), each with
the rate of its shared-memory copies (:func:`stage_bytes`,
:func:`streamed_bytes`).  Before a variant is timed, its SASS is held to
:data:`PINS` (``_variants.sass_pins``: the int8 kernels' IGMMA count and
least registers, and no spill); a variant off its pins is not timed and
fails the run.  The variants:

- ``as built``: the tiled kernel keeps a row tile's digit band resident
  and walks kGroup = 8 output tiles a CTA, each warpgroup its own tiles
  (64 rows, m64n64k32, for D <= 2 and for D = 3 with 16-byte x copies;
  else 32 rows of every tile) through its own ring of kRing = 4 x stages
  (3 ahead); the streamed kernel (K2b) splits an even D's digit planes
  between its warpgroups (all 64 rows each), an odd D's rows (32 each);
  where the digits pair up, its widest band fits one band buffer beside
  the x ring and at least 6 tiles share a band (the resident walk, every
  even-D q10 launch here at B = 2048), min(tiles, SMs) persistent CTAs
  walk K-slice-balanced runs of tiles in band-major order, each band
  resident and x alone staged, a ring of 8 x stages copied 6 ahead across
  tiles (``fir_tiles``); else a CTA a tile, its weights staged with x 3
  stages ahead (a ring of 5; ``fir_tile``, the streamed walk); 64-lane
  CTAs, one walk for all D digits;
- ``streamed walk``: = as built, the streamed kernel on the streamed walk
  at every launch (the parent's walk);
- ``tile lead 4``: = as built, the resident walk's copies 4 stages ahead
  (a ring of 6);
- ``G 1`` / ``G 2`` / ``G 4``: = as built, kGroup output tiles a tiled
  CTA (G 1 copies the band once per tile, as the streamed kernel does);
- ``ring 3`` / ``ring 8``: = as built, kRing x stage buffers a warpgroup
  (2 or 7 stages ahead);
- ``row split``: = as built, the streamed kernel's two warpgroups taking
  the tile's two 32-row halves at every D (m64n32k32, 2*D accumulators
  of 16 registers), where as built they split an even D's digit planes
  (m64n64k32 over all 64 rows, D accumulators of 32; ``digit_split``);
- ``32 rows a warpgroup``: = as built, every D at 32 rows of every tile a
  warpgroup (m64n32k32), each warpgroup copying the x it reads;
- ``lead 2``: = streamed walk, its copies 2 stages ahead (a ring of 4);
- ``resident walk alone``: = as built without the resident walk's
  epilogue (the accumulators folded into one word that a never-taken
  branch stores, so all D x 32 stay live);
- timing only (they do not compute the function): ``no band copy`` (=
  as built, the resident walk loading its run's first band alone),
  ``no epilogue`` and ``row split, no epilogue`` (the streamed walk
  alone, each split), ``wgmmas doubled``,
  ``one wgmma a slice`` (of 2*D), ``no ldmatrix``, ``no x copies``
  (after the first kRing stages), ``no band copy``, ``one epilogue a
  warpgroup`` and ``no global stores``, each one part of the resident
  kernel's work doubled or dropped, to show what its time is made of.

With ``--parent``, a ``csrc/`` directory of an earlier checkout is built
too (``git archive <commit> speex_resampler_tpu_torch/csrc`` into
``build/``): one whose streamed int8 kernel takes K-major planes and
whose tiled int8 kernel is the resident one (K-major planes and the band
span), at the closed-form origins as this checkout's, or at a table of
origins (a ``tiled_fir.cu`` with its own ``tiled_fir_row_tile`` entry
point, before the one launcher: the table is the closed form's first
period).  Both are timed at the same launches and every variant is held
against them: all take exact integer sums and the same f32 epilogue, so
0 outputs may differ.

Exits non-zero without a CUDA device, and after all variants have run if
any output of one differed from the plain version or the parent, or a
variant's SASS was off its pins.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import math
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from speex_resampler_tpu_torch.ops import _build  # noqa: E402
from speex_resampler_tpu_torch.ops import filter_design as fd  # noqa: E402
from speex_resampler_tpu_torch.ops import streamed_fir as sf  # noqa: E402
from speex_resampler_tpu_torch.ops import tiled_fir as tf  # noqa: E402
from speex_resampler_tpu_torch.parallel import batch as tb  # noqa: E402
from tools import _variants  # noqa: E402

HEADER = "int8_wgmma.cuh"
_G = "constexpr int kGroup = 8;"
_RING = "constexpr int kRing = 4;"
_MMA = ("          mma(acc[2 * d], xh[j], b, slice > 0);\n"
        "          mma(acc[2 * d + 1], xl[j], b, slice > 0);\n")
_DIGITS = "  return digits % 2 == 0;"
_EPI = ("  if constexpr (kDigits)\n"
        "    store_tile_digits<kD>(g, c.k, c.rt, c.lane0, acc,\n"
        "                          bias + (size_t)c.m * g.R + c.rt * "
        "kRowTile, scales,\n"
        "                          stage_at(1), ring, [] {});\n"
        "  else\n"
        "    store_tile<kD, kN, true>(g, c.k, c.rt, c.m, c.lane0, wg_row, "
        "acc, bias,\n"
        "                             0, scales, ring);\n")
_NO_EPI = ('  asm volatile("wgmma.wait_group.sync.aligned 0;\\n" ::: '
           '"memory");\n')
# the launcher's rule for the resident walk, off: every launch streams
_STREAMED = {"streamed_fir.cu": {
    "return fir::int8tc::digit_split(kD) && per_band >= "
    "fir::int8tc::kTileLead &&":
        "return false && per_band >= fir::int8tc::kTileLead &&"}}
_TILE_LEAD = "constexpr int kTileLead = 6;"
# the resident walk's epilogue, after the tile's last stage
_TILES_EPI = ("    store_tile_digits<kD>(g, k, rt, lt * kLanes, acc, bias_m, "
              "scales, part,\n                          out, [&] {")
_TILES_FOLD = """    {  // the walk alone: its sums kept, no epilogue math or stores
      asm volatile("wgmma.wait_group.sync.aligned 0;\\n" ::: "memory");
#pragma unroll
      for (int j = 0; j < kD; ++j) pin(acc[j]);
      unsigned fold = 0;
#pragma unroll
      for (int j = 0; j < kD; ++j)
#pragma unroll
        for (int i = 0; i < 32; ++i) fold ^= (unsigned)acc[j][i];
      if (fold == 0x9e3779b9u && g.B < 0) g.y[tid] = (int16_t)fold;
      __syncthreads();
    }
    [&](auto freed) { freed(); }([&] {"""
_BAND_LOAD = "                              slices = load_band(++b_cur, slot);"
#: name -> (edits of the header, edits of other sources, the geometries
#: whose launches it is timed at, computes the function)
VARIANTS = {
    "as built": ({}, {}, ("tiled", "streamed"), True),
    "G 1": ({_G: "constexpr int kGroup = 1;"}, {}, ("tiled",), True),
    "G 2": ({_G: "constexpr int kGroup = 2;"}, {}, ("tiled",), True),
    "G 4": ({_G: "constexpr int kGroup = 4;"}, {}, ("tiled",), True),
    "ring 3": ({_RING: "constexpr int kRing = 3;"}, {}, ("tiled",), True),
    "ring 8": ({_RING: "constexpr int kRing = 8;"}, {}, ("tiled",), True),
    "32 rows a warpgroup": (
        {"return kD <= 2 || (kD == 3 && kVec) ? kRowTile : kN;":
         "return kN;"}, {}, ("tiled",), True),
    "streamed walk": ({}, _STREAMED, ("streamed",), True),
    "tile lead 4": ({_TILE_LEAD: "constexpr int kTileLead = 4;"}, {},
                    ("streamed",), True),
    "lead 2": ({"kLead = 3;": "kLead = 2;"}, _STREAMED, ("streamed",), True),
    "row split": ({_DIGITS: "  return false;"}, {}, ("streamed",), True),
    "resident walk alone": ({_TILES_EPI: _TILES_FOLD}, {}, ("streamed",),
                            False),
    # timing only: one part of the resident kernel's work doubled or
    # dropped
    "wgmmas doubled": (
        {_MMA: _MMA + "          mma(acc[2 * d], xh[j], b, 1);\n"
                      "          mma(acc[2 * d + 1], xl[j], b, 1);\n"},
        {}, ("tiled",), False),
    "one wgmma a slice": (
        {_MMA: "          if (d == 0) mma(acc[2 * d], xh[j], b, slice > 0);\n"},
        {}, ("tiled",), False),
    "no ldmatrix": (
        {"        load_split(buf + j * kK * kRawPitch + frag, xh[j], xl[j]);":
         "        if (slice < 0)\n"
         "          load_split(buf + j * kK * kRawPitch + frag, xh[j], xl[j]);"},
        {}, ("tiled",), False),
    "no x copies": (
        {"        if (s * kStageTaps + tap < n_slices * kK)":
         "        if (q < kRing && s * kStageTaps + tap < n_slices * kK)"},
        {}, ("tiled",), False),
    "no band copy": ({"  copy_band();\n#pragma unroll": "#pragma unroll"}, {},
                     ("tiled",), False),
    "one epilogue a warpgroup": (
        {"    store_tile<kD, kWgN, false>(": "    if (it == n_mine - 1)\n"
                                            "      store_tile<kD, kWgN, false>("},
        {}, ("tiled",), False),
    "no band copy": (
        {_BAND_LOAD: "                              slices = band_width("
                     "g.taps + 2 * ++b_cur);"}, {}, ("streamed",), False),
    "no epilogue": ({_EPI: _NO_EPI}, _STREAMED, ("streamed",), False),
    "row split, no epilogue": ({_EPI: _NO_EPI, _DIGITS: "  return false;"},
                               {}, ("streamed",), False),
    "no global stores": (
        {"    if (rt * kRowTile + row >= g.R || lane >= g.B) continue;":
         "    if (rt * kRowTile + row >= g.R || lane >= g.B || !kCta) "
         "continue;"}, {}, ("tiled",), False),
}
#: (in, out, quality, target frames, scheme, digit planes: None for the
#: scheme's own)
LAUNCHES = [(44100, 48000, 7, 9408, "auto", None),
            (48000, 44100, 10, 20480, "auto", None),
            (48000, 44100, 10, 20480, "int8", None),
            (48000, 44100, 10, 20480, "int8", 2),
            (48000, 44100, 10, 20480, "int8", 1)]
CHECK_LANES = (cs.LANES, 130, 129, 64)
K2B = "streamed_fir_int8_kernel<{}, {}, false>"
#: variant -> {kernel: (IGMMA count, least registers)}: the served
#: instances (lane tiles fastest; K1b's 16-byte x copies).  K2b's even-D
#: kernels hold both walks, 2 x D/2 IGMMA a K-slice and two slices a stage
#: each (16 at D = 4, 8 at D = 2); its odd-D kernels the streamed walk
#: alone (the row split: 2 x D a slice); K1b 12 at D = 3
_SERVED = {K2B.format(4, "true"): (16, 0), K2B.format(2, "true"): (8, 0),
           K2B.format(3, "false"): (12, 0), K2B.format(1, "false"): (4, 0),
           "tiled_fir_int8_kernel<3, true>": (12, 0)}
PINS = {
    "as built": _SERVED,
    "streamed walk": _SERVED,
    "tile lead 4": _SERVED,
    # D accumulators of 32 registers live through the resident walk
    "resident walk alone": {K2B.format(4, "true"): (16, 4 * 32),
                            K2B.format(2, "true"): (8, 2 * 32)},
}
#: a parent's tiled int8 entry point at a table of origins (hist, x, y,
#: offsets, taps, planes, bias, D, s0..s3, span, geometry ..., S,
#: n_blocks, stream)
_TABLE_SIGNATURE = (ctypes.c_int, [ctypes.c_void_p] * 7 + [ctypes.c_int]
                    + [ctypes.c_float] * 4 + [ctypes.c_int] * 9
                    + [ctypes.c_void_p])


def _int8(kernel: str) -> bool:
    return "int8" in kernel


def stage_bytes(step, B: int = cs.LANES, group: int = 8) -> tuple:
    """(CTAs, bytes) of one tiled int8 launch's shared-memory copies at B
    lanes and ``group`` output tiles a CTA (``csrc/int8_wgmma.cuh``,
    fir_tile_resident, where each warpgroup sums all 64 rows of its
    tiles): each CTA copies its row tile's D digit bands once (64 rows x
    32 bytes a K-slice a digit, the K-slices from t_lo rounded down to 32
    until t_hi is covered) and, for each output tile, the x rows of those
    K-slices (32 taps x 64 lanes x 2 bytes a slice).  Computed on the
    host, from the step's tap table."""
    D = step.w[0].shape[0]
    taps = step.w[-1].cpu().numpy().astype(np.int64)        # [P, tiles, 2]
    lo, hi = taps[..., 0] // 32 * 32, taps[..., 1]
    slices = np.where(hi > lo, -(-(hi - lo) // 32), 0)      # [P, tiles]
    n_periods = step.kernel_kw["n_blocks"] // taps.shape[0]
    items = n_periods * -(-B // 64)
    groups = -(-items // group)
    band = int(slices.sum()) * groups * D * 64 * 32
    x = int(slices.sum()) * items * 32 * 64 * 2
    return slices.size * groups, band + x


def streamed_bytes(step, B: int = cs.LANES, ctas: int = 132) -> tuple:
    """(tiles, streamed bytes, resident bytes, band loads) of one streamed
    int8 launch's shared-memory copies at B lanes (``csrc/int8_wgmma.cuh``),
    computed on the host from the step's tap table: an output tile's band
    spans s K-slices from t_lo rounded down to 32.  The streamed walk
    (``fir_tile``) copies ceil(s / 2) stages of the D digit planes' [64
    rows x 64 taps] and 64 x rows of 64 lanes (none where the band is
    empty); the resident walk (``fir_tiles``) the x rows of its s K-slices
    (1 where the band is empty) and each band its CTA's run meets once
    (``streamed_fir.resident_runs`` on ``ctas`` CTAs): its D x s K-slice
    tiles and 64 biases."""
    D = step.w[0].shape[0]
    taps = step.w[-1].cpu().numpy().astype(np.int64)        # [P, tiles, 2]
    lo, hi = taps[..., 0] // 32 * 32, taps[..., 1]
    walked = np.where(hi > lo, -(-(hi - lo) // 32), 0)      # fir_tile's
    resident = np.maximum(walked, 1)                        # fir_tiles'
    P, row_tiles = walked.shape
    n_blocks = step.kernel_kw["n_blocks"]
    lanes = -(-B // 64)
    phases = np.arange(n_blocks) % P
    staged = int(-(-walked[phases] // 2).sum()) * lanes
    streamed = staged * (D * 2 * 64 * 32 + 64 * 64 * 2)
    x = int(resident[phases].sum()) * lanes * 32 * 64 * 2
    tiles = n_blocks * row_tiles * lanes
    per_band = n_blocks // P * lanes
    widths = tf.band_widths(taps)
    runs = sf.resident_runs(widths, per_band, min(tiles, ctas))
    loaded = [b for first, last in runs if last > first
              for b in range(first // per_band, (last - 1) // per_band + 1)]
    band = sum(D * widths.slices[b] * 64 * 32 + 64 * 4 for b in loaded)
    return tiles, streamed, x + band, len(loaded)


def with_digits(step, spec, f0: int, D: int):
    """A streamed int8 step with its weights decomposed into D digit
    planes (``tiled_fir.int8_weights(digits=D)`` of the K_pad-padded
    phase-tiled weights, as the step builds its own)."""
    ptw = tb._tiled_weights(spec, f0)
    K_pad = step.w[0].shape[-1]
    w_np = np.pad(ptw.w, ((0, 0), (0, K_pad - ptw.K), (0, 0)))
    planes, bias, scales, _ = tf.int8_weights(w_np, digits=D)
    w = sf.device_weights_streamed((planes, bias), "int8", step.w[0].device)
    return dataclasses.replace(step, w=w,
                               kernel_kw={**step.kernel_kw, "scales": scales})


def parent_library(csrc: Path):
    """The library of another checkout's ``csrc/``, with the argument
    types of its int8 entry points (a streamed one without the widest
    band and the launch's counts where its source has no resident
    walk)."""
    out = ROOT / "build" / "int8_variants" / "parent" / "libfir.so"
    shutil.rmtree(out.parent, ignore_errors=True)
    _build.use_csrc(csrc)
    _build.compile_library(out)
    lib = _build.declare(ctypes.CDLL(str(out)),
                         ("tiled_fir_int8", "streamed_fir_int8"))
    lib.origin_table = hasattr(lib, "tiled_fir_row_tile")
    if lib.origin_table:
        lib.tiled_fir_int8.restype, lib.tiled_fir_int8.argtypes = \
            _TABLE_SIGNATURE
    lib.band_counts = hasattr(lib, "int8_fir_band_tiles")
    if not lib.band_counts:
        restype, argtypes = _build._SIGNATURES["streamed_fir_int8"]
        lib.streamed_fir_int8.restype = restype
        lib.streamed_fir_int8.argtypes = argtypes[:11] + argtypes[12:-2]
    print(f"parent {csrc}: " + _variants.ptxas(out.parent, _int8))
    return lib


def parent_launch(lib, hist, x, step):
    """The parent's int8 kernel on one launch (a resident step: the
    resident kernel on the K-major planes and the band span, at the
    closed-form origins or their table; else the streamed kernel on the
    K-major planes as they are): a function that launches it on the
    current stream, and its output."""
    kw = step.kernel_kw
    planes, bias, taps = step.w[0], step.w[1], step.w[-1]
    D, P, R, K = planes.shape
    origin = dict(shift=kw["shift"], num=kw["num"], den=kw["den"],
                  f0=kw["f0"])
    table = sf.origins(P, R, **origin, device="cuda").int()
    s = tuple(kw["scales"]) + (0.0,) * (4 - D)
    H, B = hist.shape
    y = torch.empty((kw["n_blocks"] * R, B), dtype=torch.int16,
                    device="cuda")

    # the streamed kernel's widest band and its two counts, where its
    # entry point takes them
    resident = type(step.w[2]) is int
    widest = [] if resident or not lib.band_counts else [step.w[2].widest]
    counts = ([ctypes.byref(ctypes.c_int(0)) for _ in range(2)]
              if widest else [])

    def run():
        stream = torch.cuda.current_stream().cuda_stream
        if resident and lib.origin_table:
            err = lib.tiled_fir_int8(
                hist.data_ptr(), x.data_ptr(), y.data_ptr(),
                table.data_ptr(), taps.data_ptr(), planes.data_ptr(),
                bias.data_ptr(), D, *s, step.w[2], H, x.shape[0], B, R, K,
                P, P * R * kw["num"] // kw["den"], kw["n_blocks"], stream)
        elif resident:
            err = lib.tiled_fir_int8(
                hist.data_ptr(), x.data_ptr(), y.data_ptr(), taps.data_ptr(),
                planes.data_ptr(), bias.data_ptr(), D, *s, step.w[2], H,
                x.shape[0], B, R, K, P, kw["n_blocks"], *origin.values(),
                stream)
        else:
            err = lib.streamed_fir_int8(
                hist.data_ptr(), x.data_ptr(), y.data_ptr(), taps.data_ptr(),
                planes.data_ptr(), bias.data_ptr(), D, *s, *widest, H,
                x.shape[0], B, R, K, P, kw["n_blocks"], kw["shift"],
                kw["num"], kw["den"], kw["f0"], stream, *counts)
        if err:
            raise RuntimeError(f"parent kernel launch failed ({err})")
    return run, y


#: variants whose streamed int8 launches all take the streamed walk
_STREAMED_VARIANTS = {name for name, (_, also, _, _) in VARIANTS.items()
                      if also is _STREAMED} | {"row split",
                                               "row split, no epilogue"}


def _group(edits: dict) -> int:
    """The kGroup a variant's header edits leave."""
    return int(edits.get(_G, _G).split("= ")[1].rstrip(";"))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--only", nargs="*", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("int8_ablate: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    cases = []
    for i, o, q, target, scheme, digits in LAUNCHES:
        g = math.gcd(i, o)
        spec = fd.design_filter(i // g, o // g, q)
        flush = (cs.FLAGSHIP if i == 44100 else cs.SLICE).f0_flush
        for f0 in (0, flush):
            bspec = tb._launch_geometry(spec, target, f0=f0)
            step = tb.make_batched_step(spec, bspec, device="cuda",
                                        scheme=scheme)
            assert step.scheme == "int8"
            if digits is not None:
                step = with_digits(step, spec, f0, digits)
            inputs = [cs.card_inputs(step, bspec.in_per_launch, B,
                                     seed=B + f0, edges=True)
                      for B in CHECK_LANES]
            want = [cs.plain(h, x, step).cpu().numpy() for h, x in inputs]
            bound = cs.launch_bound(spec, step, bspec, cs.LANES)
            cases.append((f"{i}->{o} q{q} {step.kernel} {scheme} "
                          f"D={step.w[0].shape[0]} f0 {f0}", step, inputs,
                          want, bound))
    parent = None
    if args.parent is not None:
        lib = parent_library(args.parent)
        parent = []
        for label, step, inputs, _, _ in cases:
            outs = []
            for h, x in inputs:
                run, y = parent_launch(lib, h, x, step)
                run()
                torch.cuda.synchronize()
                outs.append(y.cpu().numpy())
            parent.append(outs)
            run, _ = parent_launch(lib, *inputs[0], step)
            print(f"   parent, {label}: {cs.cuda_ms(run, 20):.4f} ms back "
                  f"to back, graph {cs.cuda_ms(run, 20, mode='graph'):.4f} "
                  f"ms at B = {cs.LANES}")
    bad = []
    for name, (edits, also, kernels, exact) in VARIANTS.items():
        if args.only and name not in args.only:
            continue
        print(f"== {name}: " + _variants.build("int8_variants", name, HEADER,
                                               edits, _int8, also))
        off = _variants.sass_pins(name, _int8, PINS)
        if off:
            bad.append(f"{name}: SASS off its pins: " + "; ".join(off))
            print(f"   {name}: not timed, SASS off its pins: "
                  + "; ".join(off))
            continue
        for c, (label, step, inputs, want, bound) in enumerate(cases):
            if step.kernel not in kernels:
                continue
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
            line.append(f"{ms:.4f} ms back to back, graph {graph_ms:.4f} ms,"
                        f" {bound[0] / ms:.3f} of the bound {bound[0]:.4f} ms")
            if step.kernel == "tiled":
                ctas, nbytes = stage_bytes(step, group=_group(edits))
                line[-1] += (f"; {ctas} CTAs copy {nbytes / 1e9:.3f} GB: "
                             f"{nbytes / ms / 1e9:.2f} TB/s")
            else:
                D, P = step.w[0].shape[:2]
                sms = torch.cuda.get_device_properties(0) \
                    .multi_processor_count
                tiles, streamed, resident, loads = streamed_bytes(
                    step, cs.LANES, sms)
                if "streamed walk" in name or name in _STREAMED_VARIANTS \
                        or not _build.load().int8_fir_band_tiles(
                            D, step.w[2].widest, step.kernel_kw["n_blocks"],
                            P, cs.LANES):
                    nbytes, what = streamed, "stages of weights and x"
                else:
                    nbytes, what = resident, f"x stages and {loads} band loads"
                line[-1] += (f"; {tiles} tiles copy {nbytes / 1e9:.3f} GB of "
                             f"{what}: {nbytes / ms / 1e9:.2f} TB/s")
            print(f"   {name}, {label}: " + "; ".join(line))
    if bad:
        sys.exit("int8_ablate: outputs differ: " + "; ".join(bad))


if __name__ == "__main__":
    main()
