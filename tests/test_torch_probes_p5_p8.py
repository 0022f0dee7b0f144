"""Probes P5-P8's plain versions against the TPU probes' arithmetic, on the
CPU.

``speex_resampler_tpu_torch.probes`` ports the Pallas kernels of
``experiments/v3_overhead_anatomy.py`` (P5), ``kernel_anatomy.py`` (P6),
``mosaic_int_dot_bench.py`` (P7) and ``prec_bench.py`` (P8).  P5 and P7 run
the experiments' own kernel factories (``_make_variant``, ``make_fn``)
through ``pl.pallas_call(..., interpret=True)``: P5 at the flagship
geometry with B = 128 lanes (the module's ``B`` patched), x drawn as the
experiment draws it plus rows of -32768 and 32767 and a nonzero history;
P7 at its real shape and a grid of 2, with full-range int16 and int32
operands for the wide forms.  P6 and P8 run their work at import, so their
kernels are restated here as the experiments write them (P8 with the TPU's
lowering of each precision spelled out: bf16 casts with float32 sums, and
HIGH's bf16_3x split, since JAX's CPU backend ignores ``precision=``), at a
grid of 2 on 128 lanes; a source-pin test fails when a restated expression
no longer occurs in ``experiments/``.

Tolerance: 0 mismatches for P5's five variants, P7's five forms (bf16: the
drawn data keep every partial sum below 2^24, so its float32 sums are
exact) and P6's nodot (integer column sums below 2^24, exact in float32).
P6's full, noslice and nocvt and P8's HIGHEST, HIGH and DEFAULT: max |err|
<= 1 LSB with at most the Poisson tie count of ``conftest.lsb_tie_limit``
(both sides round their operands alike; their float32 sums run in another
order, so an output on a rounding boundary may tie).  P8's statistics
against the float64 gold: the plain version's max |d| within 1 of the
restated kernel's, its count of differing outputs within the tie bound of
the restated kernel's.  Nothing here compiles or launches a kernel.
"""

import functools
import importlib.util
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.experimental import pallas as pl

from speex_resampler_tpu_torch.ops import _build
from speex_resampler_tpu_torch.ops import tiled_fir as ttf
from speex_resampler_tpu_torch.probes import (
    kernel_anatomy as p6, mosaic_int_dot_bench as p7, prec_bench as p8,
    v3_overhead_anatomy as p5)

from conftest import assert_lsb_close, lsb_tie_limit

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
EXPERIMENTS = REPO / "experiments"
GRID = 2
LANES = 128


def _experiment(name: str):
    """An experiment's module, loaded from its file (its main() not run)."""
    spec = importlib.util.spec_from_file_location(
        f"experiment_{name}", EXPERIMENTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def interpret(monkeypatch):
    """Every ``pl.pallas_call`` in interpret mode for the test."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


# -- P5: the flagship's int8 launch in parts --------------------------------

@pytest.fixture(scope="module")
def v3():
    """The experiment's module and geometry, and the launch's inputs on 128
    lanes: x as the experiment draws it with rows of -32768 and 32767 in
    every block's window, a random nonzero history."""
    mod = _experiment("v3_overhead_anatomy")
    g = mod._geometry()
    pg = p5.geometry()
    hist, x = p5.inputs(pg, B=LANES, seed=3)
    x[0:pg.in_per_launch:97] = -32768
    x[1:pg.in_per_launch:89] = 32767
    rng = np.random.default_rng(4)
    hist = torch.from_numpy(rng.integers(-32768, 32768, hist.shape)
                            .astype(np.int16))
    return mod, g, pg, hist, x


def test_v3_geometry_and_weights_equal_the_experiment(v3):
    """The port's flagship geometry, int8 planes, bias and scales (its
    ``_resolve_scheme`` on its ``_tiled_weights``) are the experiment's
    ``_geometry()``, bit for bit."""
    _, g, pg, _, _ = v3
    ptw = g["ptw"]
    assert (pg.S, pg.K, pg.P, pg.R, pg.H, pg.gp, pg.V, pg.n_periods,
            pg.n_blocks, pg.chunk_rows) == (
        ptw.S, ptw.K, ptw.P, ptw.R, g["H"], g["gp"], g["V"],
        g["n_periods"], g["bspec"].n_blocks, g["chunk_rows"])
    assert (pg.S, pg.K, pg.P, pg.R, pg.V, pg.n_blocks, pg.chunk_rows) == (
        2352, 264, 20, 128, 3, 80, 14112)
    assert pg.offsets == g["offsets"] and pg.scales == g["scales"]
    assert pg.scales == (2.0 ** -23, 2.0 ** -15, 2.0 ** -7)
    planes, bias = (np.asarray(a) for a in g["int8p"][:2])
    assert planes.dtype == pg.planes.dtype == np.int8
    assert planes.shape == pg.planes.shape == (3, 20, 264, 128)
    np.testing.assert_array_equal(pg.planes, planes)
    assert bias.dtype == pg.bias.dtype
    np.testing.assert_array_equal(pg.bias.view(np.int32),
                                  bias.view(np.int32))


@pytest.mark.parametrize("variant", p5.VARIANTS)
def test_v3_anatomy_plain_matches_experiment(variant, v3, interpret,
                                             monkeypatch):
    mod, g, pg, hist, x = v3
    monkeypatch.setattr(mod, "B", LANES)
    conv = mod._make_variant(g, variant)
    want = np.asarray(conv(jnp.asarray(hist.numpy()), jnp.asarray(x.numpy()),
                           tuple(jnp.asarray(a) for a in g["int8p"][:2])))
    w, kw = p5.weights(pg), p5.launch_kw(pg)
    got = p5.anatomy(variant, hist, x, w, **kw).numpy()
    assert got.shape == want.shape == (80 * 128, LANES)
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, want)
    if variant in ("full", "hoist"):   # K1b's function
        np.testing.assert_array_equal(
            got, p5.served(hist, x, w, **kw).numpy())


def test_v3_raw_sums_wrap_as_twos_complement():
    """no_epilogue / dots_only store the int32 sum's low 16 bits:
    ((v + 2^15) mod 2^16) - 2^15, what JAX's astype(int16) does."""
    v = torch.tensor([0, 32767, 32768, -32768, -32769, 65535, 65536,
                      2 ** 24 + 5, -(2 ** 24) - 5], dtype=torch.int64)
    want = np.array([0, 32767, 32768, -32768, -32769, 65535, 65536,
                     2 ** 24 + 5, -(2 ** 24) - 5]).astype(np.int32)
    np.testing.assert_array_equal(p5.wrap16(v).numpy(),
                                  np.asarray(jnp.asarray(want)
                                             .astype(jnp.int16)))
    xh, xl = p5.split(torch.arange(-32768, 32768, dtype=torch.int32))
    assert torch.equal(256 * xh + xl + 128,
                       torch.arange(-32768, 32768, dtype=torch.int64))


# -- P7: exact integer dots by operand width --------------------------------

def _form_operands(form: str, seed: int):
    """The probe's draw for i8.i8 and bf16; full-range int16 W (and x for
    i16.i16), full-range int32 W and x for i32.i32."""
    w, x = p7.inputs(seed=seed)
    rng = np.random.default_rng(seed + 100)
    if form in ("i16i16", "i16i8"):
        w = torch.from_numpy(rng.integers(-32768, 32768, tuple(w.shape))
                             .astype(np.int16))
    if form == "i16i16":
        x = torch.from_numpy(rng.integers(-32768, 32768, tuple(x.shape))
                             .astype(np.int16))
    if form == "i32i32":
        lo, hi = -2 ** 31, 2 ** 31
        w = torch.from_numpy(rng.integers(lo, hi, tuple(w.shape))
                             .astype(np.int32))
        x = torch.from_numpy(rng.integers(lo, hi, tuple(x.shape))
                             .astype(np.int32))
    return w, x


@pytest.mark.parametrize("form", list(p7.FORMS))
def test_int_dot_plain_matches_experiment(form, interpret):
    mod = _experiment("mosaic_int_dot_bench")
    assert (mod.C, mod.K, mod.LB, mod.N_REPS) == (p7.C, p7.K, p7.LB,
                                                  p7.N_REPS)
    w, x = _form_operands(form, seed=7)
    if form == "bf16bf16":   # every partial sum below 2^24: exact f32 sums
        bound = np.einsum("ck,rkl->cl", np.abs(w.numpy()).astype(np.int64),
                          np.abs(x.numpy()).astype(np.int64))
        assert bound.max() < 2 ** 24
    wdt, xdt = {"i8i8": (jnp.int8, jnp.int8),
                "i16i16": (jnp.int16, jnp.int16),
                "i16i8": (jnp.int16, jnp.int8),
                "i32i32": (jnp.int32, jnp.int32),
                "bf16bf16": (jnp.bfloat16, jnp.bfloat16)}[form]
    want = np.asarray(mod.make_fn(wdt, xdt, GRID)(jnp.asarray(w.numpy()),
                                                  jnp.asarray(x.numpy())))
    got = p7.int_dot(w, x, form).numpy()
    assert got.shape == (16, p7.C, p7.LB) and got.dtype == np.int32
    # the grid of 2 writes slots 0 and 1; the plain version has every slot
    np.testing.assert_array_equal(got[:GRID], want[:GRID])
    assert (got == got[0]).all()
    if form in ("i16i16", "i32i32"):   # the sums wrap past int32
        wide = np.einsum("ck,rkl->cl", w.numpy().astype(np.float64),
                         x.numpy().astype(np.float64))
        assert np.abs(wide).max() > 2 ** 31


@pytest.mark.parametrize("form", ["i8i8", "i16i8", "i16i16", "i32i32"])
def test_int_dot_byte_planes_rebuild_the_operands(form):
    """pack's planes are the cast operands' bytes: sum_a 256^a plane_a with
    the top plane signed rebuilds each value; W's 32-tap groups are in
    K_PERM order, x's taps in order, K padded with zeros; the digit
    products are the pairs with a + b < 4."""
    w, x = _form_operands(form, seed=2)
    wp, xp = p7.pack(w, x, form)
    wdt, xdt = p7.FORMS[form]

    def rebuild(planes):
        v = torch.zeros(planes.shape[1:], dtype=torch.int64)
        for a in range(planes.shape[0]):
            d = planes[a].to(torch.int64)
            if a == planes.shape[0] - 1:
                d = torch.where(d >= 128, d - 256, d)
            v += d << (8 * a)
        return v

    K_pad = 288
    assert wp.shape == (p7.BYTES[wdt], p7.C, K_pad) and wp.dtype == torch.uint8
    assert xp.shape == (p7.BYTES[xdt], 8, K_pad, p7.LB)
    inv = torch.from_numpy(np.argsort(ttf.full_perm(K_pad)))
    wv = rebuild(wp)[:, inv]
    assert torch.equal(wv[:, :p7.K], p7.cast(w, wdt).to(torch.int64))
    assert not wv[:, p7.K:].any() and not xp[:, :, p7.K:].any()
    assert torch.equal(rebuild(xp)[:, :p7.K], p7.cast(x, xdt).to(torch.int64))
    assert p7.products(form) == {"i8i8": 1, "i16i8": 2, "i16i16": 4,
                                 "i32i32": 10}[form]


def test_int_dot_tilings_fit():
    """Every integer form plans a CTA of the rate kernel within the H100's
    227 KB at its N-tile, one the source instantiates (i8.i8 is P3's int8
    case, tiled as P3 tiles it), and the plan's shared memory is the
    source's formula."""
    assert p7.plan("i8i8", p7.C, p7.K, p7.LB) == p7.tr.plan(
        "int8", p7.C, p7.K, p7.LB)
    text = (REPO / "speex_resampler_tpu_torch/csrc/probes/tc_rate.cu"
            ).read_text()
    for form in ("i8i8", "i16i8", "i16i16", "i32i32"):
        p = p7.plan(form, p7.C, p7.K, p7.LB)
        assert p.smem <= p7.tr.MAX_SMEM and p.rs * p.groups == 8
        assert (p.n, p.na, p.nb) == (p7.N_TILE[form],
                                     *(p7.BYTES[t] for t in p7.FORMS[form]))
        assert (f"PROBE_RATE_CASE(0, {p.n}, {p.na}, {p.nb})" in text
                and p.kernel == f"tc_rate_kernel<false, {p.n}, {p.na}, "
                f"{p.nb}>")
    assert ("return kNa * kN * K * (kBf16 ? 2 : 1) + rs * kNb * K * "
            "pitch<kBf16, kN>()\n         + 128;") in text
    with pytest.raises(ValueError, match="no int8 form"):
        p7.tr.plan("int8", p7.C, p7.K, p7.LB, 64, na=2, nb=2)


# -- P6: the tiled f32 block in parts ---------------------------------------

def _w2i(v):
    y = jnp.floor(0.5 + v)
    y = jnp.where(v < -32767.5, -32768.0, y)
    y = jnp.where(v > 32766.5, 32767.0, y)
    return y.astype(jnp.int16)


def _pallas_p6(variant, x, wT, g, n_periods):
    """experiments/kernel_anatomy.py's make(variant), interpreted, at a
    grid of (1 lane tile, n_periods)."""
    P, K, R, S, OFFS = g.P, g.K, g.R, g.S, g.offsets
    T, Bn = x.shape

    def kern(w_ref, x_ref, o_ref):
        j = pl.program_id(1)
        base = j * S
        for m, off_m in enumerate(OFFS):
            if variant == "noslice":
                patch = x_ref[pl.ds(0, K), :].astype(jnp.float32)
            else:
                patch = x_ref[pl.ds(base + off_m, K), :].astype(jnp.float32)
            if variant == "nodot":
                acc = jnp.broadcast_to(
                    jnp.sum(patch, axis=0, keepdims=True),
                    (R, patch.shape[1]))
            else:
                acc = jnp.dot(w_ref[m], patch,
                              precision=lax.Precision.HIGHEST,
                              preferred_element_type=jnp.float32)
            o_ref[m] = _w2i(acc)

    return np.asarray(pl.pallas_call(
        kern, grid=(1, n_periods),
        in_specs=[pl.BlockSpec((P, R, K), lambda i, j: (0, 0, 0)),
                  pl.BlockSpec((T, Bn), lambda i, j: (0, i))],
        out_specs=pl.BlockSpec((P, R, Bn), lambda i, j: (j, 0, i)),
        out_shape=jax.ShapeDtypeStruct((n_periods * P, R, Bn), jnp.int16),
        interpret=True)(wT, x))


@pytest.mark.parametrize("variant", p6.VARIANTS)
def test_f32_anatomy_plain_matches_experiment(variant):
    g = p6.geometry()
    assert (g.P, g.K, g.R, g.S, g.T) == (20, 264, 128, 2352, 9552)
    T2 = -(-(g.S + g.offsets[-1] + g.K) // 16) * 16
    x16 = p6.inputs(g, B=LANES, seed=5, T=T2)
    x16[0, ::3], x16[1, 1::3] = -32768, 32767
    x = p6.variant_input(variant, x16)
    wT = jnp.asarray(g.w.transpose(0, 2, 1))
    want = _pallas_p6(variant, jnp.asarray(x.numpy()), wT, g, GRID)
    got = p6.anatomy(variant, x, p6.weights(g),
                     **p6.launch_kw(g, n_periods=GRID)).numpy()
    assert got.dtype == np.int16
    got = got.reshape(want.shape)
    if variant == "nodot":
        np.testing.assert_array_equal(got, want)
    else:
        assert_lsb_close(got, want)


# -- P8: the FIR dot by precision -------------------------------------------

def _tpu_dot(w, x, mode):
    """One [R, 147] . [147, LB] dot as the TPU lowers ``precision=``:
    HIGHEST float32 products; DEFAULT one pass of bf16 operands; HIGH
    bf16_3x (a = hi + lo, hi = bf16(a), lo = bf16(a - hi); hi.hi + hi.lo +
    lo.hi); float32 sums."""
    f = functools.partial(jnp.dot, preferred_element_type=jnp.float32)
    if mode == "HIGHEST":
        return f(w, x, precision=lax.Precision.HIGHEST)
    wh, xh = w.astype(jnp.bfloat16), x.astype(jnp.bfloat16)
    if mode == "DEFAULT":
        return f(wh, xh)
    wl = (w - wh.astype(jnp.float32)).astype(jnp.bfloat16)
    xl = (x - xh.astype(jnp.float32)).astype(jnp.bfloat16)
    return f(wh, xh) + f(wh, xl) + f(wl, xh)


def _pallas_p8(mode, x_np, w_np, n_blocks):
    """experiments/prec_bench.py's kern and conv, interpreted, at a grid of
    (1 lane tile, n_blocks), the dot lowered as the TPU does."""
    stride, A, R = p8.STRIDE, p8.A, p8.R
    T, Bn = x_np.shape

    def kern(w_ref, x_ref, o_ref):
        j = pl.program_id(1)
        acc = _tpu_dot(w_ref[0], x_ref[j].astype(jnp.float32), mode)
        acc += _tpu_dot(w_ref[1], x_ref[j + 1].astype(jnp.float32), mode)
        o_ref[0] = _w2i(acc)

    wA = jnp.asarray(w_np.reshape(A, stride, R).transpose(0, 2, 1))
    xr = jnp.asarray(x_np).reshape(T // stride, stride, Bn)
    return np.asarray(pl.pallas_call(
        kern, grid=(1, n_blocks),
        in_specs=[pl.BlockSpec((A, R, stride), lambda i, j: (0, 0, 0)),
                  pl.BlockSpec((T // stride, stride, Bn),
                               lambda i, j: (0, 0, i))],
        out_specs=pl.BlockSpec((1, R, Bn), lambda i, j: (j, 0, i)),
        out_shape=jax.ShapeDtypeStruct((n_blocks, R, Bn), jnp.int16),
        interpret=True)(wA, xr))


def _gold_np(w_np, x_np, n_blocks):
    """The experiment's gold (float64 einsum, rounded half up, clipped)."""
    L = p8.A * p8.STRIDE
    P = np.stack([x_np[b * p8.STRIDE:b * p8.STRIDE + L].astype(np.float64)
                  for b in range(n_blocks)])
    return np.clip(np.floor(0.5 + np.einsum(
        "lr,nlb->nrb", w_np.astype(np.float64), P)), -32768,
        32767).astype(np.int32)


@pytest.mark.parametrize("mode", ["HIGHEST", "HIGH", "DEFAULT"])
def test_prec_plain_matches_experiment(mode):
    g = p8.geometry(GRID)
    assert g.w.shape == (294, 160) and g.T == 4 * 147
    x = p8.inputs(g, B=LANES, seed=6)
    x[0, ::3], x[1, 1::3] = -32768, 32767
    want = _pallas_p8(mode, x.numpy(), g.w, GRID)
    w = torch.from_numpy(g.w)
    got = p8.prec(mode, w, x, GRID).numpy()
    assert got.dtype == np.int16
    got = got.reshape(want.shape)
    assert_lsb_close(got, want)
    # against the gold: the same statistics within a tie
    gold = _gold_np(g.w, x.numpy(), GRID)
    np.testing.assert_array_equal(
        p8.gold(w, x, GRID).numpy(), gold.reshape(-1, LANES))
    d_p = np.abs(got.astype(np.int32) - gold)
    d_r = np.abs(want.astype(np.int32) - gold)
    assert abs(int(d_p.max()) - int(d_r.max())) <= 1
    assert abs(int((d_p > 0).sum()) - int((d_r > 0).sum())) \
        <= lsb_tie_limit(gold.size)
    s = p8.stats(torch.from_numpy(got.reshape(-1, LANES)),
                 torch.from_numpy(gold.reshape(-1, LANES)))
    assert s["max_abs_d"] == int(d_p.max())
    assert s["rate"] == pytest.approx(float((d_p > 0).mean()))


def test_tf32_rna_rounds_to_nearest_ties_away():
    """tf32_rna keeps 10 mantissa bits, nearest, ties away from zero (the
    kernel's cvt.rna.tf32.f32), against an integer model of the rounding."""
    one = 1.0
    cases = {one + 2 ** -11: one + 2 ** -10,          # a tie: away
             -(one + 2 ** -11): -(one + 2 ** -10),
             one + 2 ** -11 - 2 ** -23: one,          # below the tie
             one + 3 * 2 ** -11: one + 2 ** -9,        # a tie: away
             16383.0: 16384.0, 2047.0: 2047.0, 2049.0: 2050.0}
    for v, r in cases.items():
        assert p8.tf32_rna(torch.tensor([v])).item() == r, v
    rng = np.random.default_rng(8)
    v = (rng.standard_normal(4096) * 1e3).astype(np.float32)
    bits = v.view(np.int32).astype(np.int64)
    mag = bits & 0x7FFFFFFF
    q, r = mag >> 13, mag & 0x1FFF
    mag = (q + (r >= 0x1000)) << 13
    want = ((bits & ~0x7FFFFFFF) | mag).astype(np.int32).view(np.float32)
    np.testing.assert_array_equal(p8.tf32_rna(torch.from_numpy(v)).numpy(),
                                  want)


@pytest.mark.parametrize("mode", p8.PRECISIONS)
def test_prec_device_weights_hold_the_rounded_weights(mode):
    """Each mode's device weights are W rounded as its plain version rounds
    them, R padded to 192 with zero columns: HIGHEST f32 [1, L, 192]; DEFAULT
    bf16(W); HIGH bf16 hi and lo (W - hi rounded); TF32 [192, 296], tf32(W)
    transposed, each 8 taps in the fragment's order (position p holds tap
    2p, or 2(p - 4) + 1 from p = 4); the tap tables span the nonzero taps."""
    g = p8.geometry()
    w = torch.from_numpy(g.w)
    planes, taps = p8.device_weights(mode, w)
    wp = torch.nn.functional.pad(w, (0, 32))
    terms = p8.operands(mode, wp, torch.zeros(1))
    if mode == "HIGHEST":
        assert torch.equal(planes[0], wp) and taps.shape == (1, 12, 2)
    elif mode in ("DEFAULT", "HIGH"):
        assert planes.dtype == torch.bfloat16 and taps.shape == (1, 3, 2)
        assert torch.equal(planes[0].float(), terms[0][0])
        if mode == "HIGH":
            assert torch.equal(planes[1].float(), terms[2][0])
    else:
        assert planes.shape == (192, 296) and taps.shape == (1, 3, 2)
        perm = [8 * (p // 8) + (2 * (p % 8) if p % 8 < 4
                                else 2 * (p % 8 - 4) + 1) for p in range(296)]
        wt = torch.nn.functional.pad(terms[0][0].t(), (0, 2))
        assert torch.equal(planes, wt[:, perm])
    nz = (wp != 0).any(1).nonzero()
    assert taps[..., 0].min() <= int(nz.min())
    assert taps[..., 1].max() == int(nz.max()) + 1


# -- the source text the tests restate ---------------------------------------

PINS = {
    "v3_overhead_anatomy.py": [
        "B = 2048",
        "TARGET_IN = 9408",
        "def _make_variant(g, variant):",
        "acc += jnp.dot(w_ref[d, m], xh,",
        "o_ref[gi * P + m] = acc.astype(jnp.int16)",
        "acc += (256 * ah + al).astype(jnp.float32) * scales[d]",
        "x_np[:n_real] = (rng.integers(-32768, 32768, (n_real, B)) // 2",
    ],
    "kernel_anatomy.py": [
        "B = 2048",
        "N_PERIODS = 4",
        "ptw = ph.build_phase_tiled_weights(spec.phase_table, 147, 160, 0)",
        "T = -(-((N_PERIODS - 1) * S + OFFS[-1] + K) // 16) * 16",
        "patch = x_ref[pl.ds(0, K), :].astype(jnp.float32)",
        "patch = x_ref[pl.ds(base + off_m, K), :].astype(jnp.float32)",
        "jnp.sum(patch, axis=0, keepdims=True), (R, patch.shape[1]))",
        "acc = jnp.dot(w_ref[m], patch,",
        "precision=lax.Precision.HIGHEST,",
        "o_ref[m] = _w2i(acc)",
        "out_specs=pl.BlockSpec((P, R, LB), lambda i, j: (j, 0, i),",
        "wT = jnp.asarray(ptw.w.transpose(0, 2, 1).astype(np.float32))",
        "x16 = jnp.asarray((rng.integers(-32768, 32768, size=(T, B)) // 2",
        "x32 = x16.astype(jnp.float32)",
    ],
    "mosaic_int_dot_bench.py": [
        "C, K, LB = 512, 264, 128",
        "N_REPS = 8",
        "def make_fn(wdt, xdt, G):",
        "w16 = rng.integers(-128, 128, size=(C, K)).astype(np.int16)",
        "x16 = rng.integers(-128, 128, size=(N_REPS, K, LB)).astype(np.int16)",
    ],
    "prec_bench.py": [
        "stride, A, R = 147, 2, 160",
        "w_np = ph.build_padded_weights(spec.phase_table, 147, 160, 0, 1)",
        "w_np = np.pad(w_np, ((0, L_pad - w_np.shape[0]), (0, 0)))",
        "n_blocks, B = 64, 2048",
        "T = (n_blocks + A) * stride",
        "x_np = (rng.integers(-32768, 32768, size=(T, B)) // 2).astype(np.int16)",
        "acc = jnp.dot(w_ref[0], x_ref[j].astype(jnp.float32), precision=PREC,",
        "acc += jnp.dot(w_ref[1], x_ref[j + 1].astype(jnp.float32), precision=PREC,",
        "o_ref[0] = _w2i(acc)",
        "xr = x.reshape(T // stride, stride, B)",
        "wA = jnp.asarray(w_np.reshape(A, stride, R).transpose(0, 2, 1))",
        "\"lr,nlb->nrb\", w_np.astype(np.float64), P)), -32768, 32767)",
    ],
}


@pytest.mark.parametrize("name", sorted(PINS))
def test_restated_source_still_in_experiments(name):
    text = (EXPERIMENTS / name).read_text()
    missing = [p for p in PINS[name] if p not in text]
    assert not missing, f"{name} no longer holds {missing}"


# -- the wrappers and the build ----------------------------------------------

def test_wrappers_take_the_plain_version_on_cpu_only():
    before = (p5.launches, p6.launches, p7.tr.launches, p8.launches)
    pg = p5.geometry()
    w5, kw5 = p5.weights(pg), p5.launch_kw(pg, n_periods=1)
    hist, x = p5.inputs(pg, B=16, seed=1)
    assert torch.equal(p5.anatomy("full", hist, x, w5, **kw5),
                       p5.anatomy_reference("full", hist, x, w5, **kw5))
    meta = lambda t: t.to("meta")  # noqa: E731
    with pytest.raises(ValueError, match="no kernel"):
        p5.anatomy("full", meta(hist), meta(x),
                   tuple(meta(t) if torch.is_tensor(t) else t for t in w5),
                   **{**kw5, "offsets": meta(kw5["offsets"])})
    g6 = p6.geometry()
    x6 = p6.inputs(g6, B=8, seed=2)
    w6, kw6 = p6.weights(g6), p6.launch_kw(g6, n_periods=1)
    assert torch.equal(p6.anatomy("nodot", x6, w6, **kw6),
                       p6.anatomy_reference("nodot", x6, w6, **kw6))
    with pytest.raises(TypeError, match="float32"):
        p6.anatomy("nocvt", x6, w6, **kw6)
    with pytest.raises(ValueError, match="no kernel"):
        p6.anatomy("full", meta(x6), tuple(meta(t) for t in w6),
                   **{**kw6, "offsets": meta(kw6["offsets"])})
    w7, x7 = p7.inputs(C=64, K=40, LB=64)
    assert torch.equal(p7.int_dot(w7, x7, "i16i16"),
                       p7.int_dot_reference(w7, x7, "i16i16"))
    with pytest.raises(ValueError, match="no kernel"):
        p7.int_dot(meta(w7), meta(x7), "i16i16")
    with pytest.raises(ValueError, match="form"):
        p7.int_dot(w7, x7, "i64i64")
    g8 = p8.geometry(2)
    w8, x8 = torch.from_numpy(g8.w), p8.inputs(g8, B=8)
    assert torch.equal(p8.prec("TF32", w8, x8, 2),
                       p8.prec_reference("TF32", w8, x8, 2))
    with pytest.raises(ValueError, match="no kernel"):
        p8.prec("HIGH", meta(w8), meta(x8), 2)
    with pytest.raises(ValueError, match="precision"):
        p8.prec("FP8", w8, x8, 2)
    assert (p5.launches, p6.launches, p7.tr.launches, p8.launches) == before


def test_probe_hash_covers_the_new_sources(tmp_path, monkeypatch):
    """libprobes is built from P5-P8's sources too (P7 in the rate
    kernel's): editing one, or a served header one of them includes,
    renames the library."""
    import shutil
    for name in ("v3_anatomy.cu", "tc_rate.cu", "f32_anatomy.cu",
                 "prec_fir.cu"):
        assert f"probes/{name}" in _build._PROBE_SOURCE_NAMES
    copy = tmp_path / "csrc"
    shutil.copytree(_build._PROBE_CSRC, copy)
    monkeypatch.setattr(_build, "_PROBE_CSRC", copy)
    name = _build.probe_lib_path()
    for rel in ("probes/v3_anatomy.cu", "probes/tc_rate.cu",
                "probes/f32_anatomy.cu", "probes/prec_fir.cu",
                "f32_fir.cuh", "split5_wgmma.cuh"):
        path = copy / rel
        text = path.read_text()
        path.write_text(text + "\n// edited\n")
        assert _build.probe_lib_path() != name, rel
        path.write_text(text)
    assert _build.probe_lib_path() == name
    for fn in ("probe_v3_anatomy", "probe_v3_split", "probe_f32_anatomy",
               "probe_prec_fir"):
        assert fn in _build._PROBE_SIGNATURES


def test_new_probe_modules_load_no_jax_or_triton():
    code = (
        "import sys, importlib\n"
        "for m in ('v3_overhead_anatomy', 'kernel_anatomy',\n"
        "          'mosaic_int_dot_bench', 'prec_bench'):\n"
        "    importlib.import_module('speex_resampler_tpu_torch.probes.' + m)\n"
        "import speex_resampler_tpu_torch.ops._build as b\n"
        "assert b._probe_lib is None and b._lib is None\n"
        "print(sorted(m for m in ('jax', 'triton', 'speex_resampler_tpu')"
        " if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
