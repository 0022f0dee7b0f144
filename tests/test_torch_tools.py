"""The kernel-variant machinery of the ablation tools, on the CPU.

``tools/{f32,split5,dense,int8,fixed,gather}_ablate.py`` build their
variants as text edits of a source of ``speex_resampler_tpu_torch/csrc/``
(``tools/_variants.py``).  Every edit must still find its text in the
header as it stands, or the tool fails on the card; and the loader pointed
at an edited copy must name another library, so no stale build loads.
The fixed tool's host-side helpers (the CUDA-core parent's weights, the
edge inputs) run here on CPU tensors.  Nothing here compiles or launches a
kernel.
"""

import importlib
import re
import shutil

import numpy as np
import pytest
import torch

from speex_resampler_tpu_torch.ops import _build
from speex_resampler_tpu_torch.ops import tiled_fir as ttf
from speex_resampler_tpu_torch.parallel import batch as tb

import fixed_inputs

TOOLS = ["f32_ablate", "split5_ablate", "dense_ablate", "int8_ablate",
         "fixed_ablate", "gather_ablate"]


@pytest.mark.parametrize("tool", TOOLS)
def test_variant_edits_apply(tool):
    """Each variant's edits apply to the shipped header, and each changes
    it (the tool's unedited baseline excepted) without renaming a
    constant it declares."""
    variants = importlib.import_module("tools._variants")
    mod = importlib.import_module(f"tools.{tool}")
    text = (variants.CSRC / mod.HEADER).read_text()
    assert mod.VARIANTS

    def declared(t):
        return sorted(re.findall(r"constexpr int (\w+) =", t))

    for name, (edits, *also, _) in mod.VARIANTS.items():
        out = variants.patched(text, edits, name)
        assert declared(out) == declared(text), name
        others = also[0] if also else {}
        for file, file_edits in others.items():
            src = (variants.CSRC / file).read_text()
            assert variants.patched(src, file_edits, name) != src, name
        assert (out == text) == (not edits), name or others


def test_variant_edit_missing_raises():
    variants = importlib.import_module("tools._variants")
    with pytest.raises(AssertionError, match="not found"):
        variants.patched("int a;", {"int b;": "int c;"}, "probe")


def test_use_csrc_names_another_library(tmp_path):
    """An edited header gives another library name; a copy without a
    header (an earlier checkout's) builds without it; pointing back at the
    package's csrc/ gives the package's library name again."""
    own = _build._CSRC
    name = _build.lib_path()
    copy = tmp_path / "csrc"
    shutil.copytree(own, copy)
    try:
        _build.use_csrc(copy)
        assert _build.lib_path() == name
        f32 = copy / "f32_fir.cuh"
        f32.write_text(f32.read_text() + "\n// edited\n")
        assert _build.lib_path() != name
        f32.unlink()
        _build.use_csrc(copy)
        assert [h.name for h in _build._HEADERS] == [
            "fir_common.cuh", "split5_wgmma.cuh", "int8_wgmma.cuh",
            "fixed_wgmma.cuh"]
    finally:
        _build.use_csrc(own)
    assert _build.lib_path() == name and _build._CSRC == own


def _fixed_cpu_step(path, kernel=None):
    """A chip_smoke fixed path's step at f0 = 0 on the CPU."""
    import dataclasses
    bspec = path.geometry(0)
    if kernel is not None:
        bspec = dataclasses.replace(bspec, kernel=kernel)
    return bspec, tb.make_batched_step(path.spec, bspec, device="cpu")


@pytest.mark.parametrize("which", ["flagship", "direct-streamed"])
def test_fixed_ablate_parent_weights(which):
    """The CUDA-core parent's weights: the int16 taps [P, K_pad, C] in tap
    order (the host weights, zero-padded), the step's coefficients and a
    64-row tap table over the column sets."""
    fa = importlib.import_module("tools.fixed_ablate")
    path, kernel = {"flagship": (fa.cs.FIXED_FLAGSHIP, None),
                    "direct-streamed": (fa.cs.FIXED_DIRECT, "streamed")}[which]
    bspec, step = _fixed_cpu_step(path, kernel)
    w16, coef, taps = fa.parent_weights(step)
    n_accum = step.kernel_kw["n_accum"]
    ptw = tb._tiled_weights(path.spec, 0)
    K = ptw.K if step.kernel == "tiled" else -(-ptw.K // 128) * 128
    host = tb._fixed_host_weights(path.spec, 0, K)
    assert w16.dtype == torch.int16
    assert np.array_equal(w16.numpy()[:, :K], host[0])
    assert not w16.numpy()[:, K:].any()
    assert (coef is None) == (n_accum == 1)
    if coef is not None:
        assert torch.equal(coef, step.w[2])
    P, _, C = host[0].shape
    nonzero = (host[0].reshape(P, K, n_accum, C // n_accum) != 0).any(axis=2)
    assert np.array_equal(taps.numpy(), ttf.tap_ranges(nonzero))
    assert taps.shape == (P, bspec.R // ttf.ROW_TILE, 2)


@pytest.mark.parametrize("B", [130, 64])
def test_fixed_ablate_edge_inputs(B):
    """Lanes 0 mod 3 keep the wrap input (their accumulator past 2^31);
    the others carry rows of -32768 and 32767 in the chunk and -32768
    history rows."""
    fa = importlib.import_module("tools.fixed_ablate")
    bspec, step = _fixed_cpu_step(fa.cs.FIXED_FLAGSHIP)
    n_in = bspec.in_per_launch
    hist, x = fa.edge_inputs(step, n_in, B, seed=3, device="cpu")
    base_h, base_x = fixed_inputs.launch_inputs(step, n_in, B, 3, wrap=True)
    assert hist.device.type == x.device.type == "cpu"
    assert np.array_equal(x.numpy()[:, 0::3], base_x[:, 0::3])
    assert np.array_equal(hist.numpy()[:, 0::3], base_h[:, 0::3])
    assert (x.numpy()[0:n_in:97, 1::3] == -32768).all()
    assert (x.numpy()[1:n_in:89, 2::3] == 32767).all()
    assert (hist.numpy()[::5, 1::3] == -32768).all()
    assert not x.numpy()[n_in:].any()


def test_fixed_ablate_stage_bytes():
    """The copy counts of the flagship fixed launch, tile by tile: a tile
    per (block, 32-row tile, 64-lane tile) walks s = ceil((t_hi -
    floor32(t_lo)) / 32) K-slices (1 where empty) in ceil(s / 2) stages,
    copying 4 KB of x a K-slice; the streamed walk 16 KB of planes a stage
    besides, the resident walk 8 KB of planes a K-slice and 1 KB of biases
    and coefs each band load, the bands each CTA's contiguous band-major
    run (``streamed_fir.resident_runs``) meets."""
    fa = importlib.import_module("tools.fixed_ablate")
    bspec, step = _fixed_cpu_step(fa.cs.FIXED_FLAGSHIP)
    taps = step.w[-1].numpy()
    n_blocks = step.kernel_kw["n_blocks"]
    P, row_tiles, _ = taps.shape
    lanes, ctas = 3, 5

    def slices(lo, hi):
        start = lo // 32 * 32
        return -(-(hi - start) // 32) if hi > start else 1

    x = staged = 0
    for k in range(n_blocks):
        for lo, hi in taps[k % P]:
            x += slices(lo, hi) * 4096 * lanes
            staged += -(-slices(lo, hi) // 2) * lanes
    tiles = n_blocks * row_tiles * lanes
    per_band = n_blocks // P * lanes
    bands = set()
    band = loads = 0
    widths = step.w[-2]
    runs = fa.sf.resident_runs(widths, per_band, ctas)
    assert [r[0] for r in runs[1:]] == [r[1] for r in runs[:-1]]
    for first, last in runs:
        for b in sorted({i // per_band for i in range(first, last)}):
            m, rt = divmod(b, row_tiles)
            band += slices(*taps[m, rt]) * 8192 + 1024
            loads += 1
            bands.add(b)
    assert bands == set(range(P * row_tiles))
    assert fa.stage_bytes(step, B=130, ctas=ctas) == (
        tiles, x + staged * 16384, x + band, loads)
    assert tiles == n_blocks * (bspec.R // 32) * lanes
    assert loads == fa.sf.resident_bands(widths, per_band, ctas)


@pytest.mark.parametrize("B,group", [(2048, 8), (136, 4), (2048, 1)])
def test_int8_ablate_stage_bytes(B, group):
    """The tiled flagship int8 launch's shared-memory copies, CTA by CTA:
    each (phase, 64-row tile) has ceil(n_periods * lane tiles / group)
    CTAs, each copying its D digit bands once (64 rows x 32 bytes a
    K-slice from t_lo rounded down to 32) and, for each of its output
    tiles, those K-slices' x rows (32 taps x 64 lanes x 2 bytes)."""
    ia = importlib.import_module("tools.int8_ablate")
    spec = ia.fd.design_filter(147, 160, 7)
    bspec = tb._launch_geometry(spec, 9408)
    step = tb.make_batched_step(spec, bspec, device="cpu")
    assert step.scheme == "int8"
    D = step.w[0].shape[0]
    taps = step.w[-1].numpy()
    lane_tiles = -(-B // 64)
    items = bspec.n_blocks // bspec.P * lane_tiles
    want_ctas = want_bytes = 0
    for m in range(bspec.P):
        for lo, hi in taps[m]:
            start = lo // 32 * 32
            slices = -(-(hi - start) // 32) if hi > start else 0
            for item0 in range(0, items, group):
                tiles = min(group, items - item0)
                want_ctas += 1
                want_bytes += D * 64 * 32 * slices + tiles * slices * 4096
    assert ia.stage_bytes(step, B=B, group=group) == (want_ctas, want_bytes)
    assert ia._group(ia.VARIANTS["G 4"][0]) == 4
    assert ia._group(ia.VARIANTS["as built"][0]) == 8
