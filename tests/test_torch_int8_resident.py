"""K2b's persistent, band-resident walk (``csrc/int8_wgmma.cuh``'s
``fir_tiles``), modelled on the CPU.

Where a streamed int8 launch's digits pair up, its widest band fits one
band buffer beside the x ring and at least the ring's lead of tiles share
a band (``csrc/streamed_fir.cu``'s ``int8_band_tiles``), min(tiles, SMs)
persistent CTAs each walk a contiguous, K-slice-balanced run of output
tiles in band-major order, hold each band resident and stage x alone.
Nothing here launches a kernel; the tests pin what the walk and its
counters assume against the source text and the host's models
(``streamed_fir.resident_runs`` / ``resident_bands``, ``int8_tiles``).
The kernel itself is held against the plain version and the streamed walk
by tests/test_torch_gpu.py and chip_smoke.py on the card.
"""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from speex_resampler_tpu_torch.ops import filter_design as fd
from speex_resampler_tpu_torch.ops import streamed_fir as tsf
from speex_resampler_tpu_torch.ops import tiled_fir as ttf
from speex_resampler_tpu_torch.parallel import batch as tb

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "speex_resampler_tpu_torch" / "csrc"
HEADER = (CSRC / "int8_wgmma.cuh").read_text()
LAUNCHER = (CSRC / "streamed_fir.cu").read_text()
MAX_SMEM = 232448                     # a CTA's most on the H100 (kMaxSmem)


@pytest.fixture(scope="module")
def q10():
    """The float 48k->44.1k q10 step (``stage.q10``'s; "auto": D = 4) on
    the CPU, at f0 = 0."""
    spec = fd.design_filter(160, 147, 10)
    bspec = tb._launch_geometry(spec, 20480)
    step = tb.make_batched_step(spec, bspec, device="cpu")
    assert (step.kernel, step.scheme) == ("streamed", "int8")
    return bspec, step


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", HEADER)[1])


def _band_tiles(D: int, slices: int, n_blocks: int, P: int, B: int) -> int:
    """The launcher's rule (``int8_band_tiles``), from the header's
    constants: the tiles a band where the digits pair up, at least
    kTileLead tiles share a band and ``tiles_smem`` fits, else 0."""
    lead, lanes = _constant("kTileLead"), _constant("kLanes")
    raw = 2 * _constant("kK") * (lanes * 2 + 16)           # kRawBytes
    smem = ((lead + 2) * raw + 64 * (lanes * 2 + 16)       # ring, kOutBytes
            + 16 * (1 + D // 2) * 128 * 4 + 2 * 64 * 4     # exchange, biases
            + D * slices * 32 * 64 + 128)                  # band, alignment
    per_band = n_blocks // P * -(-B // lanes)
    return per_band if D % 2 == 0 and per_band >= lead \
        and smem <= MAX_SMEM else 0


def test_rule_model_is_the_source():
    """The model above is what the header and the launcher say."""
    for line in ("constexpr int kTileLead = 6;",
                 "  return 16 * (1 + digits / 2) * 128 * 4;",
                 "  return (kTileLead + 2) * kRawBytes + kOutBytes + "
                 "exchange_bytes(kD) +",
                 "         2 * kRowTile * 4 + kD * slices * kTileBytes + 128;",
                 "constexpr int kRawBytes = kStageTaps * kRawPitch;",
                 "constexpr int kOutBytes = kRowTile * kRawPitch;",
                 "constexpr int kRawPitch = kLanes * 2 + 16;",
                 f"constexpr int kMaxSmem = {MAX_SMEM};"):
        assert line in HEADER, line
    for line in ("      n_blocks / P * ((B + fir::int8tc::kLanes - 1) / "
                 "fir::int8tc::kLanes);",
                 "  return fir::int8tc::digit_split(kD) && per_band >= "
                 "fir::int8tc::kTileLead &&",
                 "fir::int8tc::tiles_smem<kD>(slices) <= "
                 "fir::int8tc::kMaxSmem",
                 "*band_tiles = int8_band_tiles<kD>(slices, n_blocks, g.P, "
                 "g.B);",
                 "    *ctas = std::min(n_kr * lane_tiles, sms);"):
        assert line in LAUNCHER, line


@pytest.mark.parametrize("D,slices,B,want", [
    (4, 12, 2048, 32), (4, 12, 384, 6), (4, 12, 320, 0), (4, 15, 2048, 32),
    (4, 16, 2048, 0), (3, 12, 2048, 0), (1, 1, 2048, 0), (2, 32, 2048, 32),
    (2, 33, 2048, 0)],
    ids=["q10-B2048", "lead-tiles", "fewer-than-lead", "widest-that-fits",
         "past-one-buffer", "odd-D3", "odd-D1", "D2-widest", "D2-past"])
def test_engage_rule_at_its_edges(D, slices, B, want):
    """The resident walk engages at q10 (one block a phase, P = 147) at B
    = 2048 (32 tiles a band); with 6 lanes' tiles a band (the ring's
    lead) but not 5; up to 15 K-slices a band at D = 4 (32 at D = 2), one
    band buffer beside the x ring, the output tile, the exchange and two
    bias slots in 232,448 bytes; never where D is odd (the row split)."""
    assert _band_tiles(D, slices, 147, 147, B) == want


def test_q10_bands(q10):
    """The q10 step's streamed int8 weights carry their tap table's band
    widths: 294 bands (147 phases x 2 row tiles), 40 of 11 K-slices and
    254 of 12, so the resident walk engages at 2048 lanes."""
    bspec, step = q10
    w = step.w[2]
    assert type(w) is ttf.BandWidths and len(step.w) == 4
    assert w.slices == ttf.band_widths(step.w[3].numpy()).slices
    assert len(w.slices) == 294 and w.widest == 12
    assert (w.slices.count(11), w.slices.count(12)) == (40, 254)
    assert step.w[0].shape[0] == 4
    assert _band_tiles(4, w.widest, step.kernel_kw["n_blocks"], bspec.P,
                       2048) == 32


def _decode(item: int, per_band: int, row_tiles: int, lane_tiles: int,
            P: int) -> tuple:
    """fir_tiles' item -> (block k, row tile, lane tile)."""
    b, r = divmod(item, per_band)
    m, rt = divmod(b, row_tiles)
    j, lt = divmod(r, lane_tiles)
    return m + P * j, rt, lt


@pytest.mark.parametrize("ctas", [132, 7, 1])
@pytest.mark.parametrize("B", [2048, 1001])
def test_runs_cover_every_tile_in_band_major_order(q10, B, ctas):
    """``resident_runs`` (the kernel's ``balanced_run``) at q10: the runs
    are contiguous and together every tile once; item i is band (m, rt) =
    divmod(i / per_band, row tiles), block m + P j, lane tile (the
    header's decode), so items run band by band and every tile of the
    launch appears once; each run's K-slices lie within one tile's of the
    launch's mean (within 2 x the widest band of each other)."""
    for line in ("balanced_run(g, row_tiles, per_band, out, first, last);",
                 "const int b = item / per_band, r = item - b * per_band;",
                 "const int m = b / row_tiles, j = r / lane_tiles;",
                 "k = m + g.P * j;",
                 "const int per_band = n_kr / row_tiles / g.P * lane_tiles;"):
        assert line in HEADER, line
    bspec, step = q10
    widths = step.w[2]
    n_blocks, P, R = step.kernel_kw["n_blocks"], bspec.P, bspec.R
    row_tiles, lane_tiles = R // 64, -(-B // 64)
    per_band = n_blocks // P * lane_tiles
    n_items = tsf.int8_tiles(n_blocks, R, B)
    assert n_items == len(widths.slices) * per_band
    runs = tsf.resident_runs(widths, per_band, min(n_items, ctas))
    assert runs[0][0] == 0 and runs[-1][1] == n_items
    assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))
    tiles = [_decode(i, per_band, row_tiles, lane_tiles, P)
             for i in range(n_items)]
    assert len(set(tiles)) == n_items
    assert sorted(tiles) == sorted((k, rt, lt) for k in range(n_blocks)
                                   for rt in range(row_tiles)
                                   for lt in range(lane_tiles))
    bands = [(k % P) * row_tiles + rt for k, rt, _ in tiles]
    assert bands == sorted(bands)
    work = [sum(widths.slices[i // per_band] for i in range(*r))
            for r in runs]
    assert max(work) - min(work) <= 2 * widths.widest


def _walk(slices: list, runs: list, per_band: int, lead: int) -> list:
    """A model of fir_tiles, CTA by CTA: a band's tiles walk ceil(s / 2)
    stages; the copy cursor runs `lead` stages ahead into a ring of lead +
    2 x buffers, one group a stage; the first band loads before the
    walk, each later one where the run's next tile enters it, once the
    tile before has retired its wgmmas (its epilogue), into the one band
    buffer.  Returns each CTA's events: ("band", b), ("copy", q, tile),
    ("walk", q, tile, band held) and ("epilogue", tile)."""
    out = []
    for first, last in runs:
        seq = [(i, s) for i in range(first, last)
               for s in range(-(-slices[i // per_band] // 2))]
        events, cursor = [], 0

        def copy_next():
            nonlocal cursor
            if cursor < len(seq):
                events.append(("copy", cursor, seq[cursor][0]))
            cursor += 1

        held = first // per_band if last > first else None
        if held is not None:
            events.append(("band", held))
        for _ in range(lead):
            copy_next()
        for q, (i, s) in enumerate(seq):
            events.append(("walk", q, i, held))
            copy_next()
            if s == -(-slices[i // per_band] // 2) - 1:
                events.append(("epilogue", i))
                if i + 1 < last and (i + 1) // per_band != held:
                    held += 1
                    events.append(("band", held))
        out.append(events)
    return out


@pytest.mark.parametrize("ctas", [132, 5])
def test_walk_model_holds_each_tiles_band(q10, ctas):
    """The one band buffer at q10, B = 2048: every tile is walked against
    its own band (loaded before its first stage, replaced only after the
    last tile of the band before has been through its epilogue); each x
    stage is copied before it is walked, at most kTileLead = 6 stages
    ahead, into a ring buffer whose last stage (8 back) was walked; the
    band loads add up to ``resident_bands``, what the wrapper counts, ~22
    tiles a load on 132 CTAs."""
    for line in ("const bool enters = item + 1 < last && (item + 1) / "
                 "per_band != b_cur;",
                 "slices = load_band(++b_cur, slot);",
                 "constexpr int kXStages = kTileLead + 2;",
                 "const uint32_t buf = ring + (c_q % kXStages) * kRawBytes;",
                 "  freed();\n"):
        assert line in HEADER, line
    bspec, step = q10
    widths = step.w[2]
    lead, per_band = 6, 32
    n_items = tsf.int8_tiles(step.kernel_kw["n_blocks"], bspec.R, 2048)
    runs = tsf.resident_runs(widths, per_band, ctas)
    loads, walked = 0, []
    for events in _walk(list(widths.slices), runs, per_band, lead):
        copied, walked_q = {}, set()
        for at, ev in enumerate(events):
            if ev[0] == "band":
                loads += 1
            elif ev[0] == "copy":
                _, q, _ = ev
                assert q - (lead + 2) in walked_q or q < lead + 2
                copied[q] = at
            elif ev[0] == "walk":
                _, q, i, held = ev
                assert held == i // per_band
                assert q in copied
                ahead = sum(1 for e in events[copied[q]:at] if e[0] == "walk")
                assert ahead <= lead
                walked_q.add(q)
                walked.append(i)
    assert sorted(set(walked)) == list(range(n_items))
    assert loads == tsf.resident_bands(widths, per_band, ctas)
    if ctas == 132:
        assert 20 < n_items / loads < 25


def test_counts_at_q10(q10):
    """The counters' arithmetic at q10, B = 2048: 9,408 tiles (147 blocks x
    2 row tiles x 32 lane tiles) on 132 CTAs, 71.3 a CTA; each band loaded
    once where a run meets it: 294 bands plus one a CTA boundary inside a
    band, ~22 tiles a band load; none on the streamed walk."""
    bspec, step = q10
    tiles = tsf.int8_tiles(step.kernel_kw["n_blocks"], bspec.R, 2048)
    assert tiles == 9408
    loads = tsf.resident_bands(step.w[2], 32, 132)
    assert 294 < loads <= 294 + 131
    assert 20 < tiles / loads < 25
    assert tsf.resident_bands(step.w[2], 0, 9408) == 0


def test_int8_counters_start_at_zero_and_reset():
    """The port's counters of the streamed int8 launches are 0 at import,
    add up launch by launch, are apart from the fixed ones, and
    utils/launches.reset_launches() sets them back to 0 (a fresh process:
    nothing here launches)."""
    code = (
        "from speex_resampler_tpu_torch.ops import streamed_fir as sf\n"
        "from speex_resampler_tpu_torch.utils import launches as ul\n"
        "assert ul.int8_counts() == (0, 0, 0, 0)\n"
        "sf.count_int8(132, 9408, 426)\n"
        "assert ul.int8_counts() == (1, 132, 9408, 426)\n"
        "sf.count_int8(9408, 9408)\n"
        "assert ul.int8_counts() == (2, 9540, 18816, 426)\n"
        "assert ul.fixed_counts() == (0, 0, 0, 0)\n"
        "ul.reset_launches()\n"
        "assert ul.int8_counts() == (0, 0, 0, 0)\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   timeout=120)


def test_plain_version_takes_the_band_widths(q10):
    """The streamed int8 weights with their band widths run the plain
    version on CPU tensors (a small B), equal to the same launch's weights
    with any widths of the table's shape: the widths choose a walk, never
    the sums."""
    bspec, step = q10
    B = 3
    rng = np.random.default_rng(4)
    hist = torch.from_numpy(rng.integers(-32768, 32768,
                                         (step.hist_rows, B), np.int16))
    x = torch.from_numpy(rng.integers(-32768, 32768,
                                      (step.chunk_rows, B), np.int16))
    y = tsf.resample_streamed(hist, x, step.w, **step.kernel_kw)
    other = ttf.BandWidths((1,) * len(step.w[2].slices))
    assert torch.equal(tsf.resample_streamed(
        hist, x, (step.w[0], step.w[1], other, step.w[3]),
        **step.kernel_kw), y)
