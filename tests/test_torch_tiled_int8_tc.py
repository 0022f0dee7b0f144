"""The tiled int8 kernel's tensor-core layout and work list, on the CPU.

``csrc/int8_wgmma.cuh`` (``fir_tile_resident``) runs the int8 scheme of
the tiled kernel (K1b, what "auto" serves at the 44.1 kHz -> 48 kHz q7
flagship) on the int8 tensor cores.  Every block of one phase applies the
same weights, so a CTA takes one (phase m, 64-row tile), copies that row
tile's digit band into shared memory once and walks ``kGroup`` of the
output tiles that share it (its work list), streaming only x.  The device
planes are K-major, int8[D, P, R, K_pad] (K padded to a multiple of 32),
each 32-tap group permuted to the fragment's tap order
(``tiled_fir.K_PERM``), with the most K-slices a band spans beside them.
Nothing here launches a kernel; the tests pin what the kernel assumes:

- the device planes map back to the host planes, the K_pad taps zero;
- the tap table (64 rows, tap order) equals the table of the old
  ``[D, P, K, R]`` layout, and the span is its widest band;
- the plain version on the new layout equals the JAX package's v3 int8
  kernel (interpret mode) bit for bit, D = 3 and 4, f0 = 0 and after a
  flush, B = 4 and 130;
- ``weights_from_jax`` gives the same device weights;
- a NumPy model of the launch's work list covers every (block, row tile,
  lane tile, row) once across the CTAs' warpgroups, a model of the
  resident band's byte layout, read through the wgmma descriptor, gives
  each warpgroup's weight tile, and the epilogue's register and store
  maps cover each warpgroup's outputs once, all tied to the sources' text;
- the ring schedule never refills a buffer a stage still reads;
- the wrapper's guards (the resident kernel's slice count and period),
  and CPU tensors never launch.

The kernel itself is held against the plain version by
tests/test_torch_gpu.py and chip_smoke.py on the card.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speex_resampler_tpu.ops import filter_design as jfd
from speex_resampler_tpu.ops import pallas_fir as jpf
from speex_resampler_tpu.parallel import batch as jb
from speex_resampler_tpu_torch.ops import filter_design as tfd
from speex_resampler_tpu_torch.ops import phase as tph
from speex_resampler_tpu_torch.ops import streamed_fir as tsf
from speex_resampler_tpu_torch.ops import tiled_fir as ttf
from speex_resampler_tpu_torch.parallel import batch as tb

torch.set_num_threads(1)

CSRC = Path(tb.__file__).resolve().parent.parent / "csrc"
HEADER = (CSRC / "int8_wgmma.cuh").read_text()
LAUNCHER = (CSRC / "tiled_fir.cu").read_text()
KK, ROWS, LANES, THREADS, N = 32, 64, 64, 256, 32   # kK, kRowTile, kLanes,
TILE_BYTES = KK * ROWS                              # kThreads, kN


def _constant(name: str) -> int:
    """An int constant of int8_wgmma.cuh (``constexpr int name = v;``)."""
    m = re.search(rf"constexpr int {name} = (\d+);", HEADER)
    assert m, name
    return int(m.group(1))


def _host_planes(D: int, P: int, K: int, R: int, seed: int):
    """Random int8 digit planes [D, P, K, R], zero outside a band per
    (phase, row tile) (one row tile all zero), a bias and D scales."""
    rng = np.random.default_rng(seed)
    planes = rng.integers(-128, 128, (D, P, K, R), dtype=np.int8)
    for m in range(P):
        for rt in range(R // ROWS):
            lo = 7 + 23 * m + 11 * rt
            cols = slice(rt * ROWS, (rt + 1) * ROWS)
            planes[:, m, :lo, cols] = 0
            planes[:, m, lo + 100 + 9 * rt:, cols] = 0
    planes[:, P - 1, :, :ROWS] = 0
    bias = (rng.standard_normal((P, R)) * 100).astype(np.float32)
    scales = tuple(float(2.0 ** (8 * d - 31)) for d in range(D))
    return planes, bias, scales


@pytest.mark.parametrize("D", [3, 4])
def test_tiled_planes_map_back(D):
    """K 200 -> K_pad 224: the device planes are contiguous, 16-byte
    aligned, K-major and permuted; mapped back they are the host planes,
    the taps past K zero; bias, tap table and span alongside."""
    planes, bias, _ = _host_planes(D, 3, 200, 128, seed=D)
    w = ttf.device_weights((planes, bias), "int8", "cpu")
    assert len(w) == 4 and type(w[2]) is int
    assert w[0].shape == (D, 3, 128, 224) and w[0].is_contiguous()
    assert w[0].data_ptr() % 16 == 0
    back = ttf.int8_n_major(w[0]).numpy()
    assert np.array_equal(back[:, :, :200], planes)
    assert not back[:, :, 200:].any()
    kt = w[0].numpy().reshape(D, 3, 128, 7, 32)
    padded = np.pad(planes, ((0, 0), (0, 0), (0, 24), (0, 0)))
    assert np.array_equal(kt[..., 9], padded.transpose(0, 1, 3, 2)
                          .reshape(D, 3, 128, 7, 32)[..., ttf.K_PERM[9]])
    assert np.array_equal(w[1].numpy(), bias)
    assert w[2] == ttf.band_slices(w[3].numpy())


def _port_step(f0: str, scheme: str = "int8"):
    spec = tfd.design_filter(147, 160, 7)
    if f0 == "flush":   # the phase a flush of 3368 staged frames leaves
        m = tph.producible_outputs(3368, 0, 0, spec.num, spec.den)
        f0 = (m * spec.num) % spec.den
        assert f0 != 0
    bspec = tb._launch_geometry(spec, 2352, f0=int(f0))
    return spec, bspec, tb.make_batched_step(spec, bspec, device="cpu",
                                             scheme=scheme)


@pytest.mark.parametrize("f0", ["0", "flush"])
def test_tap_table_equals_old_layout(f0):
    """The flagship step's 64-row tap table is the one the [D, P, K, R]
    planes give (computed in tap order, before the permutation), and its
    span, 7 K-slices at f0 = 0, is the widest band's."""
    spec, bspec, step = _port_step(f0)
    planes, bias, slices, taps = step.w
    host = tb._resolve_scheme(tb._tiled_weights(spec, bspec.f0).w,
                              "int8")[1][0]
    old = ttf.tap_ranges((host != 0).any(axis=0))
    assert np.array_equal(taps.numpy(), old)
    back = ttf.int8_n_major(planes).numpy()
    assert np.array_equal(ttf.tap_ranges((back != 0).any(axis=0)), old)
    lo, hi = old[..., 0] // 32 * 32, old[..., 1]
    assert slices == int((-(-(hi - lo) // 32)).max())
    if f0 == "0":
        assert slices == 7 and planes.shape[3] == 288


def _inputs(hist_rows, chunk_rows, n_in, B, seed):
    rng = np.random.default_rng(seed)
    hist = rng.integers(-32768, 32768, (hist_rows, B), dtype=np.int16)
    x = np.zeros((chunk_rows, B), dtype=np.int16)
    x[:n_in] = rng.integers(-32768, 32768, (n_in, B), dtype=np.int16)
    x[0:n_in:97] = -32768
    x[1:n_in:89] = 32767
    return hist, x


@pytest.mark.parametrize("B", [4, 130])
@pytest.mark.parametrize("f0", ["0", "flush"])
@pytest.mark.parametrize("D", [3, 4])
def test_plain_on_k_major_equals_jax_v3(D, f0, B):
    """The flagship's geometry (P 20, R 128, K 264 -> 288), two weight
    periods, its weights decomposed into D digit planes by both packages:
    the port's plain version on its K-major planes equals the JAX
    package's v3 int8 kernel in interpret mode, every output row."""
    spec, bspec, step = _port_step(f0, scheme="highest")
    w = tb._tiled_weights(spec, bspec.f0).w
    jp = jpf.int8_weights(w, D)
    planes, bias, scales, _ = ttf.int8_weights(w, digits=D)
    assert np.array_equal(jp[0], planes) and tuple(jp[2]) == scales
    kw = step.kernel_kw
    ptw = tb._tiled_weights(spec, bspec.f0)
    hist, x = _inputs(step.hist_rows, step.chunk_rows, bspec.in_per_launch,
                      B, seed=B + D)
    jy = jpf.resample_conv_tm_pallas_v3(
        jnp.asarray(hist), jnp.asarray(x),
        (jnp.asarray(jp[0]), jnp.asarray(jp[1])),
        offsets=tuple(int(o) for o in ptw.offsets), S=ptw.S,
        n_blocks=kw["n_blocks"], interpret=True, scheme="int8",
        scales=tuple(jp[2]))
    dw = ttf.device_weights((planes, bias), "int8", "cpu")
    ty = tsf.resample_streamed_reference(
        torch.from_numpy(hist), torch.from_numpy(x), dw,
        **{**kw, "scheme": "int8", "scales": scales})
    assert ty.shape == (kw["n_blocks"] * bspec.R, B)
    assert np.array_equal(ty.numpy(), np.asarray(jy))


def test_weights_from_jax_tiled_int8():
    """The JAX step's tiled int8 weights (planes [D, P, K, R], bias)
    through weights_from_jax equal the port's own device weights."""
    spec = jfd.design_filter(147, 160, 7)
    jspec = jb._launch_geometry(spec, 2352, use_pallas=True)
    jstep = jb.make_batched_step(spec, jspec, use_pallas=True,
                                 pallas_interpret=True, scheme="int8")
    _, _, step = _port_step("0")
    got = tb.weights_from_jax(tuple(np.asarray(a) for a in jstep.w),
                              "int8", device="cpu", kernel="tiled")
    assert len(got) == 4 and got[2] == step.w[2]
    for a, b in ((got[0], step.w[0]), (got[1], step.w[1]),
                 (got[3], step.w[3])):
        assert torch.equal(a, b)


# -- the launch's work list -------------------------------------------------

def test_work_list_matches_the_sources():
    """The expressions the work-list model below mirrors, as the kernel,
    its launcher and fir_tile_resident write them."""
    for line in (
            "const int items = n_periods * lane_tiles;",
            "const int groups = (items + kGroup - 1) / kGroup;",
            "const int mr = blockIdx.x / groups, item0 = blockIdx.x % "
            "groups * kGroup;",
            "const int m = mr / (g.R / kRowTile);",
            "g, m, mr % (g.R / kRowTile), item0, min(kGroup, items - "
            "item0),",
            "lane_tiles, fir::origin(g, o, m), S, planes, bias, scales, "
            "max_slices);",
            "tiled_fir_int8_kernel<kD, kVec><<<g.P * (g.R / kRowTile) * "
            "groups, kThreads,"):
        assert line in LAUNCHER, line
    for line in (
            "return kD <= 2 || (kD == 3 && kVec) ? kRowTile : kN;",
            "constexpr bool kSplit = kWgN == kRowTile;",
            "const int r0 = kSplit ? 0 : h * kWgN;",
            "const int first = kSplit ? h : 0, step = kSplit ? 2 : 1;",
            "const int n_mine = kSplit ? (n_items - h + 1) / 2 : n_items;",
            "const int item = item0 + first + step * (q / n_st), "
            "s = q % n_st;",
            "const int v = v_m + item / lane_tiles * S + t_begin + s * "
            "kStageTaps;",
            "const int lane0 = item % lane_tiles * kLanes;",
            "const int item = item0 + first + step * it;",
            "store_tile<kD, kWgN, false>(g, m + g.P * (item / lane_tiles), "
            "rt, m,",
            "item % lane_tiles * kLanes, r0, acc, bias,"):
        assert line in HEADER, line


def _wg_rows(D: int, B: int) -> int:
    """resident_rows<D, kVec>: 64 rows a warpgroup for D <= 2, and for D =
    3 with 16-byte x copies (B % 8 == 0; the tests' buffers are aligned),
    else 32."""
    return ROWS if D <= 2 or (D == 3 and B % 8 == 0) else N


def _work_list(P, R, n_periods, B, G, D):
    """The kernel's warpgroups as the launcher and fir_tile_resident lay
    them out: {(cta, warpgroup): [(block k, row tile, lane0, first row,
    period, phase)]}; a warpgroup sums 64 rows of its own tiles or 32 rows
    of every tile of its CTA (:func:`_wg_rows`)."""
    lane_tiles = -(-B // LANES)
    items = n_periods * lane_tiles
    groups = -(-items // G)
    row_tiles = R // ROWS
    wg_rows = _wg_rows(D, B)
    split = wg_rows == ROWS
    out = {}
    for cta in range(P * row_tiles * groups):
        mr, item0 = cta // groups, cta % groups * G
        m, rt = mr // row_tiles, mr % row_tiles
        n_items = min(G, items - item0)
        for h in range(2):
            first, step = (h, 2) if split else (0, 1)
            n_mine = (n_items - h + 1) // 2 if split else n_items
            r0 = 0 if split else h * wg_rows
            out[cta, h] = [
                (m + P * (item // lane_tiles), rt,
                 item % lane_tiles * LANES, r0, item // lane_tiles, m)
                for item in (item0 + first + step * i
                             for i in range(n_mine))]
    return out, wg_rows


@pytest.mark.parametrize("D", [2, 3, 4])
@pytest.mark.parametrize("P,n_periods,B,G", [
    (20, 4, 2048, 8), (20, 4, 130, 4), (20, 4, 129, 8), (20, 4, 64, 2),
    (20, 1, 130, 8), (1, 3, 129, 1), (10, 2, 2048, 8), (3, 5, 64, 4),
    (20, 4, 2048, 3)],
    ids=lambda v: str(v))
def test_work_list_covers_every_tile_once(P, n_periods, B, G, D):
    """Every (block, row tile, lane tile, row) of the launch is one
    warpgroup's, exactly once; each tile's origin, its period's S past its
    phase's closed-form origin, is its block's closed-form origin (num /
    den = S / (P R), so P R num / den = S); a CTA's tiles share one
    (phase, row tile), the CTAs of a phase are neighbours, only a CTA's
    last group may be short, and its two warpgroups' loads differ by at
    most one tile."""
    R, S = 128, 2352
    origin = tsf.origins(n_periods * P, R, shift=5, num=S, den=P * R,
                         f0=P * R - 1).numpy()
    work, wg_rows = _work_list(P, R, n_periods, B, G, D)
    lane_tiles = -(-B // LANES)
    seen = {}
    for (cta, h), tiles in work.items():
        assert len({(t[5], t[1]) for t in tiles}) <= 1
        for k, rt, lane0, r0, period, m in tiles:
            assert k % P == m and k // P == period
            assert period * S + origin[m] == origin[k]
            for row in range(r0, r0 + wg_rows):
                key = (k, rt, lane0, row)
                assert key not in seen
                seen[key] = cta
    want = {(k, rt, lt * LANES, row) for k in range(n_periods * P)
            for rt in range(R // ROWS) for lt in range(lane_tiles)
            for row in range(ROWS)}
    assert set(seen) == want
    for m in range(P):
        ctas = sorted({c for (k, _, _, _), c in seen.items() if k % P == m})
        assert ctas == list(range(ctas[0], ctas[0] + len(ctas)))
    groups = -(-n_periods * lane_tiles // G)
    for cta in {c for c, _ in work}:
        n = [len(work[cta, h]) for h in range(2)]
        assert 0 <= n[0] - n[1] <= 1 if wg_rows == ROWS else n[0] == n[1]
        if (sum(n) if wg_rows == ROWS else n[0]) < G:
            assert cta % groups == groups - 1


# -- the resident band's byte layout and the ring ---------------------------

def test_band_model_matches_the_header():
    for line in (
            "constexpr int kHalves = kK / 16;",
            "const int per_row = kHalves * n_slices;",
            "const int cc = e % per_row, n = e / per_row % kRowTile;",
            "const int d = e / (per_row * kRowTile);",
            "const int t = t_begin + cc * 16;",
            "copy16(band + (d * n_slices + cc / kHalves) * kTileBytes +",
            "core_offset(n, cc % kHalves),",
            "for (int e = tid; e < kD * kRowTile * per_row; e += kThreads) {",
            "const uint32_t w_row = band + (r0 / 8) * 256;",
            "descriptor(w_row + (d * n_slices + slice) * kTileBytes);",
            "const int t_begin = t_lo & ~(kK - 1);",
            "const int n_slices = t_hi > t_begin ? (t_hi - t_begin + kK - 1)"
            " / kK : 0;",
            "return (n / 8) * 256 + c * 128 + (n % 8) * 16;",
            "((uint64_t)(128 >> 4) << 16) |",
            "((uint64_t)(256 >> 4) << 32)",
            "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8",
            "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8"):
        assert line in HEADER, line
    assert _constant("kN") == N and _constant("kK") == KK


def _core_offset(n, c):
    return (n // 8) * 256 + c * 128 + (n % 8) * 16


@pytest.mark.parametrize("D,t_lo,t_hi,K,B", [(3, 37, 223, 288, 2048),
                                             (3, 37, 223, 288, 129),
                                             (4, 0, 32, 64, 2048),
                                             (1, 200, 288, 288, 130),
                                             (4, 70, 71, 96, 64)])
def test_band_model_gives_each_warpgroup_tile(D, t_lo, t_hi, K, B):
    """Every thread's band copies (permuted K-major planes of row tile 1,
    phase 1) into a model of shared memory; each (digit, K-slice,
    warpgroup) B tile read back through the descriptor's core-matrix
    layout (128 bytes between a slice's 16-tap halves, 256 between 8-row
    groups; N = 64 rows from the tile's first row, or N = 32 from row 32h:
    :func:`_wg_rows`) is that warpgroup's rows of the slice's 32 taps."""
    P, R, m, rt = 2, 128, 1, 1
    rng = np.random.default_rng(D)
    planes = rng.integers(-128, 128, (D, P, R, K), dtype=np.int64)
    t_begin = t_lo & ~(KK - 1)
    n_slices = -(-(t_hi - t_begin) // KK) if t_hi > t_begin else 0
    per_row = 2 * n_slices
    smem = np.full(D * n_slices * TILE_BYTES, 999, dtype=np.int64)
    for tid in range(THREADS):
        for e in range(tid, D * ROWS * per_row, THREADS):
            cc, n = e % per_row, e // per_row % ROWS
            d = e // (per_row * ROWS)
            t = t_begin + cc * 16
            dst = (d * n_slices + cc // 2) * TILE_BYTES + _core_offset(
                n, cc % 2)
            row = planes[d, m, rt * ROWS + n]
            smem[dst:dst + 16] = [row[t + i] if t + i < K else 0
                                  for i in range(16)]
    assert (smem != 999).all()
    wg_rows = _wg_rows(D, B)
    n_idx, k_idx = np.meshgrid(np.arange(wg_rows), np.arange(KK),
                               indexing="ij")
    read = (n_idx // 8) * 256 + (k_idx // 16) * 128 + (n_idx % 8) * 16 \
        + k_idx % 16                                      # [wg_rows, KK]
    for h in range(2):
        r0 = 0 if wg_rows == ROWS else h * wg_rows
        for s in range(n_slices):
            for d in range(D):
                base = (r0 // 8) * 256 + (d * n_slices + s) * TILE_BYTES
                taps = t_begin + s * KK + np.arange(KK)
                want = planes[d, m, rt * ROWS + r0:
                              rt * ROWS + r0 + wg_rows][:, taps]
                assert np.array_equal(smem[base + read], want), (h, s, d)


@pytest.mark.parametrize("wg_rows,cta", [(32, True), (64, False),
                                         (32, False)])
def test_epilogue_map_covers_the_rows_once(wg_rows, cta):
    """store_tile: accumulator register i of thread (warp w, lane l) of a
    warpgroup is output (lane 16w + l/4 + 8*((i/2)%2), row r0 + 8*(i/4) +
    2*(l%4) + i%2), the m64nNk32 accumulator layout, so a warpgroup's
    wg_rows/2 registers cover its 64 lanes x wg_rows rows once; the row
    stores of the threads sharing the output buffer (the CTA's 256, or the
    warpgroup's 128) cover their rows' 16-byte chunks once."""
    for line in ("const int lane = 16 * w + l / 4 + 8 * ((i / 2) % 2);",
                 "const int row = r0 + 8 * (i / 4) + 2 * (l % 4) + i % 2;",
                 "constexpr int kSharers = kCta ? kThreads : 128;",
                 "constexpr int kRows = kCta ? kRowTile : kWgN;",
                 "for (int r = 0; r < kRows * kLanes / 8 / kSharers; ++r) {",
                 "const int chunk = tid % kSharers + r * kSharers;",
                 "const int row = row0 + chunk / (kLanes / 8), cl = chunk % "
                 "(kLanes / 8) * 8;"):
        assert line in HEADER, line
    for h in range(2):
        r0 = h * 32 if wg_rows == 32 else 0
        outs = {(16 * w + l // 4 + 8 * ((i // 2) % 2),
                 r0 + 8 * (i // 4) + 2 * (l % 4) + i % 2)
                for w in range(4) for l in range(32)
                for i in range(wg_rows // 2)}
        assert outs == {(lane, r0 + r) for lane in range(LANES)
                        for r in range(wg_rows)}
    sharers, rows = (THREADS, ROWS) if cta else (128, wg_rows)
    for h in range(2 if not cta else 1):
        row0 = 0 if cta else (h * 32 if wg_rows == 32 else 0)
        chunks = [(row0 + c // 8, c % 8 * 8)
                  for tid in range(sharers)
                  for r in range(rows * LANES // 8 // sharers)
                  for c in [tid + r * sharers]]
        assert sorted(chunks) == [(row0 + r, 8 * c) for r in range(rows)
                                  for c in range(8)]


def test_ring_schedule_never_refills_a_buffer_in_use():
    """The header's ring (kRing buffers, copies kRingLead stages ahead,
    stage q's copy issued after its first slice into buffer (q +
    kRingLead) % kRing, ``cp.async.wait_group kRingLead - 1`` at each
    stage's end): the refilled buffer is the previous stage's, whose reads
    ended at the last barrier, never one of the stages q .. q + kRingLead
    - 1 still to be read; and each wait leaves the next stage landed."""
    ring, lead = _constant("kRing"), _constant("kRing") - 1
    assert "constexpr int kRingLead = kRing - 1;" in HEADER
    assert 'asm volatile("cp.async.wait_group %0;\\n" ::"n"(kRingLead - 1)' \
        in HEADER
    assert "if (j == 0) copy_stage(q + kRingLead);" in HEADER
    for r in (2, 3, ring, 6):
        la = r - 1
        for q in range(40):
            target = (q + la) % r
            assert target == (q - 1) % r
            assert target not in {(q + i) % r for i in range(la)}
            committed = la + q + 1            # prologue + one a stage
            assert committed - (la - 1) >= q + 2
    assert lead >= 1


def test_resident_smem_fits_the_flagship():
    """resident_smem<kD>(slices): the band, each warpgroup's ring and
    output tile, 128 bytes of alignment; at the flagship (7 K-slices) one
    CTA an SM for every D, and the streamed kernel takes the GPU tests' long
    band (33 K-slices) at D = 3 and 4."""
    assert ("return kD * slices * kTileBytes + 2 * (kRing * kRawBytes + "
            "kOutBytes) +") in HEADER
    raw = 64 * (LANES * 2 + 16)

    def smem(D, slices):
        return D * slices * TILE_BYTES + 2 * (_constant("kRing") * raw +
                                              ROWS * (LANES * 2 + 16)) + 128
    for D in (1, 2, 3, 4):
        assert smem(D, 7) <= 232448
        assert (smem(D, 33) > 232448) == (D >= 3)


# -- the wrapper's guards -----------------------------------------------------

def test_tiled_int8_guards():
    """N-major planes, K % 32 != 0, planes or bias off a 16-byte boundary,
    an impossible span and, for the resident kernel, a weight period that
    is no whole multiple of 16 rows (P R num / den) are refused before any
    launch; the weights with their band widths in the span's place are
    the streamed kernel's, the same function; a third entry that is neither a slice count nor the
    tap table's band widths, or widths of another table's shape or past
    K, are refused; CPU tensors run the plain version and count no
    launch."""
    planes, bias, scales = _host_planes(3, 2, 200, 128, seed=5)
    w = ttf.device_weights((planes, bias), "int8", "cpu")
    hist = torch.zeros((32, 4), dtype=torch.int16)
    x = torch.randint(-32768, 32768, (600, 4), dtype=torch.int16)
    # origins floor16(80 k + 3): a period of S = 2 * 128 * 5 / 8 = 160 rows
    kw = dict(n_blocks=4, shift=3, num=5, den=8, f0=0, scheme="int8",
              scales=scales)
    before = dict(tsf.launches)
    y = tsf.resample_streamed(hist, x, w, **kw)
    assert tsf.launches == before and y.shape == (4 * 128, 4)
    bands = ttf.band_widths(w[3].numpy())
    assert torch.equal(tsf.resample_streamed(hist, x, (w[0], w[1], bands,
                                                       w[3]), **kw), y)
    with pytest.raises(ValueError, match="period"):
        tsf.resample_streamed(hist, x, w, **{**kw, "num": 1, "den": 3})
    with pytest.raises((TypeError, ValueError)):
        tsf.resample_streamed(hist, x, (torch.from_numpy(planes), *w[1:]),
                              **kw)
    with pytest.raises(ValueError, match="multiple of 32"):
        tsf.resample_streamed(hist, x,
                              (w[0][..., :208].contiguous(), *w[1:]), **kw)
    buf = torch.zeros(w[0].numel() + 1, dtype=torch.int8)
    off = buf[1:].view(w[0].shape)
    off.copy_(w[0])
    assert off.is_contiguous() and off.data_ptr() % 16 == 1
    with pytest.raises(ValueError, match="16-byte aligned"):
        tsf.resample_streamed(hist, x, (off, *w[1:]), **kw)
    fbuf = torch.zeros(w[1].numel() + 1, dtype=torch.float32)
    boff = fbuf[1:].view(w[1].shape)
    boff.copy_(w[1])
    assert boff.data_ptr() % 16 == 4
    with pytest.raises(ValueError, match="16-byte aligned"):
        tsf.resample_streamed(hist, x, (w[0], boff, *w[2:]), **kw)
    for bad in ((w[0], w[1], np.int64(w[2]), w[3]), (w[0], w[1], 8, w[3]),
                (w[0], w[1], -1, w[3])):
        with pytest.raises(ValueError, match="slices"):
            tsf.resample_streamed(hist, x, bad, **kw)
    with pytest.raises(ValueError, match="int8 weights"):
        tsf.resample_streamed(hist, x, (w[0], w[1]), **kw)
    with pytest.raises(ValueError, match="int8 weights"):
        tsf.resample_streamed(hist, x, (w[0], w[1], w[3]), **kw)
    for bad in (ttf.BandWidths(bands.slices[:-1]),
                ttf.BandWidths((w[0].shape[3] // 32 + 1,) * 4)):
        with pytest.raises(ValueError, match="BandWidths"):
            tsf.resample_streamed(hist, x, (w[0], w[1], bad, w[3]), **kw)
    assert tsf.launches == before


def test_band_slices():
    """The widest band in whole K-slices from lo rounded down to 32."""
    taps = np.array([[[37, 223], [0, 0]], [[64, 65], [0, 288]]])
    assert ttf.band_slices(taps) == 9
    assert ttf.band_slices(taps[:1]) == 6
    assert ttf.band_slices(np.array([[[31, 33]]])) == 2
    assert ttf.band_slices(np.zeros((2, 2, 2), dtype=np.int32)) == 0
