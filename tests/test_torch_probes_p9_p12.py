"""Probes P9-P12's plain versions against the TPU probes' arithmetic, on the
CPU.

``speex_resampler_tpu_torch.probes`` ports the Pallas kernels of
``experiments/v5_int8_bench.py`` (P9: ``conv_int8``, ``conv_split5``),
``v4_k_layout.py`` (P10), ``batched_dot.py`` (P11: the m-loop and the
batched form) and ``v3_bench.py`` (P12: ``conv_v3`` and its ``step``).
P10 runs the experiment's own ``make_fn`` through ``pl.pallas_call(...,
interpret=True)``, the module's ``LB`` and ``N_REPS`` patched to 128 and
4.  P9, P11 and P12 do their work at import, so their kernels are
restated here as the experiments write them (P11 with the JAX package's
``_v3_parts`` copy plans, as the experiment imports them), each at 128
lanes and a grid of 2 periods; a source-pin test fails when a restated
expression no longer occurs in ``experiments/``.  Inputs: x drawn as the
experiments draw it, with rows of -32768 and 32767, and P11's and P12's
histories nonzero.

Tolerance: 0 mismatches for P9's int8 scheme (exact digit sums, the f32
combine in the same order) and P10 (exact int32 sums).  P9's split5, P11
and P12: max |err| <= 1 LSB with at most the Poisson tie count of
``conftest.lsb_tie_limit`` (float32 sums in another order).  P12's plain
conv is P6's ``full`` bit for bit, and the port's int8 planes and split5
planes are the JAX package's bit for bit.  Nothing here compiles or
launches a kernel.
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
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from speex_resampler_tpu.ops import filter_design as jfd
from speex_resampler_tpu.ops import int8_planes as jplanes
from speex_resampler_tpu.ops import phase as jph
from speex_resampler_tpu.ops.pallas_fir import (_v3_parts, _word2int,
                                                split5_weights)
from speex_resampler_tpu_torch.ops import _build
from speex_resampler_tpu_torch.ops import tiled_fir as ttf
from speex_resampler_tpu_torch.probes import (
    batched_dot as p11, kernel_anatomy as p6, tc_rate as ptr,
    v3_bench as p12, v4_k_layout as p10, v5_int8_bench as p9)

from conftest import assert_lsb_close

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


def _edges(x: np.ndarray, rows: int) -> np.ndarray:
    """Rows of -32768 and 32767 in every block's window of the first
    ``rows`` rows."""
    x[0:rows:97] = -32768
    x[1:rows:89] = 32767
    return x


def _call(kern, grid, in_specs, out_spec, out_shape, *args, scratch=()):
    return np.asarray(pl.pallas_call(
        kern, grid=grid, in_specs=in_specs, out_specs=out_spec,
        out_shape=out_shape, scratch_shapes=list(scratch),
        interpret=True)(*args))


# -- P9: the int8 and split5 launches without the halo ---------------------

@pytest.fixture(scope="module")
def v5():
    """The port's geometry, the JAX package's planes and the x of a grid of
    2 periods on 128 lanes."""
    g = p9.geometry()
    spec = jfd.design_filter(147, 160, 7)
    ptw = jph.build_phase_tiled_weights(spec.phase_table, 147, 160, 0)
    pl8 = jplanes.decompose(ptw.w, sw=23)
    T2 = -(-(g.S + g.offsets[-1] + g.K) // 16) * 16
    x = _edges(p9.inputs(g, B=LANES, seed=5, T=T2).numpy(), T2)
    return g, ptw, pl8, torch.from_numpy(x)


def test_v5_weights_equal_the_jax_package(v5):
    """decompose(sw=23)'s planes, bias and scales and split5_weights' planes
    are the JAX package's bit for bit; the certificate clears 0.35 LSB."""
    g, ptw, pl8, _ = v5
    assert (g.P, g.K, g.R, g.S, g.T) == (ptw.P, ptw.K, ptw.R, ptw.S, 9552)
    assert g.offsets == tuple(int(o) for o in ptw.offsets)
    assert g.planes.dtype == np.int8 and g.planes.shape == (3, 20, 264, 128)
    np.testing.assert_array_equal(g.planes, pl8.planes)
    np.testing.assert_array_equal(g.bias.view(np.int32),
                                  np.asarray(pl8.bias).view(np.int32))
    assert g.scales == tuple(float(s) for s in pl8.scales) \
        == (2.0 ** -23, 2.0 ** -15, 2.0 ** -7)
    assert g.err_bound == pytest.approx(float(pl8.err_bound), abs=0) \
        and g.err_bound <= 0.35
    ours = ttf.split5_weights(g.w).view(torch.int16).numpy()
    theirs = np.asarray(split5_weights(ptw.w)).view(np.int16)
    np.testing.assert_array_equal(ours, theirs)


def _pallas_p9(scheme, x, w, bias, g, n_periods):
    """experiments/v5_int8_bench.py's kern_int8 / kern_split5 and their
    pallas_call, interpreted, at a grid of (1 lane tile, n_periods)."""
    P, K, R, S, OFFS = g.P, g.K, g.R, g.S, g.offsets
    T, Bn = x.shape
    SCALES = g.scales

    def kern_int8(w_ref, b_ref, x_ref, o_ref):
        j = pl.program_id(1)
        base = j * S
        for m in range(P):
            u = x_ref[pl.ds(base + OFFS[m], K), :].astype(jnp.int32)
            xh = (u >> 8).astype(jnp.int8)
            xl = ((u & 255) - 128).astype(jnp.int8)
            acc = jnp.zeros((R, u.shape[1]), jnp.float32)
            for d in range(3):
                ah = jnp.dot(w_ref[d, m], xh,
                             preferred_element_type=jnp.int32)
                al = jnp.dot(w_ref[d, m], xl,
                             preferred_element_type=jnp.int32)
                acc += (256 * ah + al).astype(jnp.float32) * SCALES[d]
            o_ref[m] = _word2int(acc + b_ref[m][:, None])

    def kern_split5(w_ref, x_ref, o_ref):
        j = pl.program_id(1)
        base = j * S
        for m in range(P):
            xf = x_ref[pl.ds(base + OFFS[m], K), :].astype(jnp.float32)
            xh = xf.astype(jnp.bfloat16)
            xl = (xf - xh.astype(jnp.float32)).astype(jnp.bfloat16)
            d = functools.partial(jnp.dot, preferred_element_type=jnp.float32)
            w_hi, w_mid, w_lo = w_ref[0, m], w_ref[1, m], w_ref[2, m]
            o_ref[m] = _word2int(d(w_hi, xh) + d(w_hi, xl) + d(w_mid, xh)
                                 + d(w_mid, xl) + d(w_lo, xh))

    out_spec = pl.BlockSpec((P, R, Bn), lambda i, j: (j, 0, i))
    out_shape = jax.ShapeDtypeStruct((n_periods * P, R, Bn), jnp.int16)
    w_spec = pl.BlockSpec((3, P, R, K), lambda i, j: (0, 0, 0, 0))
    x_spec = pl.BlockSpec((T, Bn), lambda i, j: (0, i))
    if scheme == "int8":
        return _call(kern_int8, (1, n_periods),
                     [w_spec, pl.BlockSpec((P, R), lambda i, j: (0, 0)),
                      x_spec], out_spec, out_shape, w, bias, x)
    return _call(kern_split5, (1, n_periods), [w_spec, x_spec], out_spec,
                 out_shape, w, x)


@pytest.mark.parametrize("scheme", p9.SCHEMES)
def test_v5_bench_plain_matches_experiment(scheme, v5):
    g, ptw, pl8, x = v5
    if scheme == "int8":
        wj = jnp.asarray(pl8.planes.transpose(0, 1, 3, 2))
    else:
        wj = jnp.asarray(split5_weights(ptw.w.transpose(0, 2, 1)))
    want = _pallas_p9(scheme, jnp.asarray(x.numpy()), wj,
                      jnp.asarray(pl8.bias), g, GRID)
    kw = p9.launch_kw(g, scheme, n_periods=GRID)
    got = p9.bench(scheme, x, p9.weights(g, scheme), **kw).numpy()
    assert got.dtype == np.int16 and got.shape == (GRID * 20 * 128, LANES)
    got = got.reshape(want.shape)
    if scheme == "int8":
        np.testing.assert_array_equal(got, want)
    else:
        assert_lsb_close(got, want)


def test_v5_gold_matches_experiment(v5):
    """The float64 gold on lane 0 is the experiment's loop, output by
    output, and its statistics are the experiment's."""
    g, _, _, x = v5
    n = GRID * g.P * g.R
    table = jfd.design_filter(147, 160, 7).phase_table
    xi = x[:, 0].numpy().astype(np.float64)
    t = np.arange(n, dtype=np.int64) * 147
    want = np.array([xi[s:s + 128] @ table[ti % 160].astype(np.float64)
                     for s, ti in zip(t // 160, t)])
    want = np.clip(np.floor(0.5 + want), -32768, 32767).astype(np.int32)
    gold = p9.gold(x, GRID * g.P)
    np.testing.assert_array_equal(gold.numpy(), want)
    y = torch.from_numpy(np.zeros((n, LANES), np.int16))
    y[:, 0] = torch.from_numpy(want.astype(np.int16))
    y[5, 0] += 1
    assert p9.stats(y, gold) == {"max_abs_d": 1, "rate": 1 / n}


# -- P10: K and the weights' layout ------------------------------------------

@pytest.mark.parametrize("form", p10.FORMS)
@pytest.mark.parametrize("K", p10.KS)
def test_k_layout_plain_matches_experiment(K, form, monkeypatch):
    mod = _experiment("v4_k_layout")
    assert (mod.R, mod.LB, mod.N_REPS, (mod.G1, mod.G2)) == (
        p10.R, p10.LB, p10.N_REPS, p10.G)
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(mod, "LB", LANES)
    monkeypatch.setattr(mod, "N_REPS", 4)
    w, x = p10.operands(K, form, seed=K, LB=LANES, reps=4)
    want = np.asarray(mod.make_fn(K, form, GRID)(
        jnp.asarray(w.numpy().astype(np.int8)),
        jnp.asarray(x.numpy().astype(np.int8))))
    got = p10.k_layout(w, x, form).numpy()
    assert got.shape == (16, 128, LANES) and got.dtype == np.int32
    # the grid of 2 writes slots 0 and 1; the plain version has every slot
    np.testing.assert_array_equal(got[:GRID], want[:GRID])
    assert (got == got[0]).all()


def test_k_layout_kr_staging_is_the_rk_tile():
    """tc_rate.cu's stage_w_kr, modelled byte by byte: a [K, C] W staged
    with K_PERM's inverse lands every byte where stage_w puts the packed
    [C, K_pad] W (its 32-tap groups K_PERM), in the descriptor's layout;
    the source holds the modelled address arithmetic."""
    K, C, n = 440, 64, 32
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.integers(-128, 128, (C, K)).astype(np.int16))
    x = torch.zeros((1, K, 64), dtype=torch.int16)
    wp, _ = ptr.pack(w, x, "int8")                    # [C, K_pad]
    wkr, _ = ptr.pack(w.t().contiguous(), x, "int8", kr=True)   # [K_pad, C]
    wp, wkr = wp.numpy(), wkr.numpy()
    K_pad = wp.shape[1]
    assert wkr.shape == (K_pad, C) and K_pad == 448

    def core(row, c):
        return (row // 8) * 256 + c * 128 + (row % 8) * 16

    for nt in range(C // n):
        rk = np.zeros(n * K_pad, np.int8)
        for row in range(n):                          # stage_w
            for j in range(K_pad // 16):
                at = (j // 2) * n * 32 + core(row, j % 2)
                rk[at:at + 16] = wp[nt * n + row, 16 * j:16 * j + 16]
        kr = np.zeros(n * K_pad, np.int8)
        for t in range(K_pad):                        # stage_w_kr
            q = t % 32
            p = (t & ~31) + 16 * (q // 16) + 4 * ((q % 8) // 2) \
                + 2 * ((q % 16) // 8) + q % 2
            for j in range(n // 16):
                for b in range(16):
                    at = (p // 32) * n * 32 + p % 16 \
                        + core(16 * j + b, (p % 32) // 16)
                    kr[at] = wkr[t, nt * n + 16 * j + b]
        np.testing.assert_array_equal(kr, rk)
    text = (REPO / "speex_resampler_tpu_torch/csrc/probes/tc_rate.cu"
            ).read_text()
    for line in ("const int p = (t & ~31) + 16 * (q / 16) + 4 * ((q % 8) / 2) +",
                 "2 * ((q % 16) / 8) + q % 2;",
                 "const uint32_t at = dst + (p / 32) * n * kK + p % 16;",
                 "at + fir::int8tc::core_offset(16 * j + b, (p % 32) / 16)),",
                 "stage_w_kr(wsm, g.w + nt * kN, g.C, kN, kb, tid, kWgThreads);"):
        assert line in text, line


@pytest.mark.parametrize("K", p10.KS)
def test_k_layout_tilings_fit(K):
    """Each K plans a CTA of the rate kernel within the H100's 227 KB at
    N-tile 128 with 16 x blocks split over reps / rs groups; 440 runs as
    448, with zero weights past K."""
    p = ptr.plan("int8", p10.R, K, p10.LB, reps=p10.N_REPS)
    assert p.smem <= ptr.MAX_SMEM and p.n == 128 and p.reps == 16
    assert p.rs * p.groups == 16 and p.K_pad == {512: 512, 448: 448,
                                                 440: 448}[K]
    assert p.needed_macs == 16 * 128 * K * 1024
    w, x = p10.operands(K, "kr", R=32, LB=64, reps=2)
    wp, xp = ptr.pack(w, x, "int8", kr=True)
    assert not wp[K:].any() and not xp[:, K:].any()


# -- P11: the m-loop against one batched product ----------------------------

@pytest.fixture(scope="module")
def bd():
    """The geometry, hist (nonzero) and a chunk for a grid of 2 periods on
    128 lanes: T_c = (2 - back + V) * S rows, 2 S of them drawn."""
    g = p11.geometry()
    T_c = (GRID - g.back + g.V) * g.S
    rng = np.random.default_rng(6)
    x = np.zeros((T_c, LANES), np.int16)
    x[:GRID * g.S] = (rng.integers(-32768, 32768, (GRID * g.S, LANES)) // 2
                      ).astype(np.int16)
    x = _edges(x, GRID * g.S)
    hist = rng.integers(-32768, 32768, (p11.H, LANES)).astype(np.int16)
    return g, torch.from_numpy(hist), torch.from_numpy(x)


def _pallas_p11(batched, hist, x, wT, g, n_periods):
    """experiments/batched_dot.py's make(batched), interpreted, at a grid of
    (1 lane tile, n_periods): the views of x clipped as there."""
    P, K, R, S, OFFS, H = g.P, g.K, g.R, g.S, g.offsets, p11.H
    back, V = g.back, g.V
    LB = x.shape[1]
    n_chunk_blocks = x.shape[0] // S

    def kern(w_ref, h_ref, *rest):
        view_refs = rest[:V]
        o_ref = rest[V]
        scratch = rest[V + 1]
        j = pl.program_id(1)

        def assemble(m, plan):
            for src, s0, dst, ln in plan:
                ref = h_ref if src == "h" else view_refs[src]
                if batched:
                    scratch[m, pl.ds(dst, ln), :] = \
                        ref[pl.ds(s0, ln), :].astype(jnp.float32)
                else:
                    scratch[pl.ds(dst, ln), :] = \
                        ref[pl.ds(s0, ln), :].astype(jnp.float32)

        for m, off_m in enumerate(OFFS):
            gen = _v3_parts(off_m, S, K, H, "general")
            cases = [(jc, _v3_parts(off_m, S, K, H, jc))
                     for jc in range(back)]
            cases = [(jc, pl_) for jc, pl_ in cases if pl_ != gen]
            if not cases:
                assemble(m, gen)
            else:
                @pl.when(j >= back)
                def _():
                    assemble(m, gen)
                for jc, plan in cases:
                    @pl.when(j == jc)
                    def _(plan=plan, m=m):
                        assemble(m, plan)
            if not batched:
                o_ref[m] = _word2int(jnp.dot(
                    w_ref[m], scratch[...],
                    precision=jax.lax.Precision.HIGHEST,
                    preferred_element_type=jnp.float32))
        if batched:
            acc = jax.lax.dot_general(
                w_ref[...], scratch[...],
                dimension_numbers=(((2,), (1,)), ((0,), (0,))),
                precision=jax.lax.Precision.HIGHEST,
                preferred_element_type=jnp.float32)
            o_ref[...] = _word2int(acc)

    scratch_shape = (pltpu.VMEM((P, K, LB), jnp.float32) if batched
                     else pltpu.VMEM((K, LB), jnp.float32))

    def view_spec(v):
        return pl.BlockSpec(
            (S, LB),
            lambda i, j, v=v: (jnp.clip(j - back + v, 0,
                                        n_chunk_blocks - 1), i))

    return _call(kern, (1, n_periods),
                 [pl.BlockSpec((P, R, K), lambda i, j: (0, 0, 0)),
                  pl.BlockSpec((H, LB), lambda i, j: (0, i))]
                 + [view_spec(v) for v in range(V)],
                 pl.BlockSpec((P, R, LB), lambda i, j: (j, 0, i)),
                 jax.ShapeDtypeStruct((n_periods * P, R, LB), jnp.int16),
                 wT, hist, *([x] * V), scratch=[scratch_shape])


def test_batched_dot_geometry_equals_the_experiment():
    mod_text = (EXPERIMENTS / "batched_dot.py").read_text()
    assert "H = 128" in mod_text and "N_PERIODS = 4" in mod_text
    g = p11.geometry()
    spec = jfd.design_filter(147, 160, 7)
    ptw = jph.build_phase_tiled_weights(spec.phase_table, 147, 160, 0,
                                        origin_shift=128 - 127)
    assert (g.P, g.K, g.R, g.S, g.back, g.V, g.n_in, g.T_c) == (
        ptw.P, ptw.K, ptw.R, ptw.S, 1, 3, 9408, 14112)
    assert g.offsets == tuple(int(o) for o in ptw.offsets)
    np.testing.assert_array_equal(g.w, ptw.w.astype(np.float32))


@pytest.mark.parametrize("form", p11.FORMS)
def test_batched_dot_plain_matches_experiment(form, bd):
    g, hist, x = bd
    wT = jnp.asarray(g.w.transpose(0, 2, 1))
    want = _pallas_p11(form == "batched", jnp.asarray(hist.numpy()),
                       jnp.asarray(x.numpy()), wT, g, GRID)
    kw = p11.launch_kw(g, n_periods=GRID)
    w = p11.weights(g)
    got = p11.batched_dot(form, hist, x, w, **kw).numpy()
    assert got.dtype == np.int16 and got.shape == (GRID * 20 * 128, LANES)
    assert_lsb_close(got.reshape(want.shape), want)
    # both forms, and the m-loop at 64 lanes, are one function
    np.testing.assert_array_equal(
        got, p11.batched_dot("m-loop", hist, x, w, lanes=64, **kw).numpy())


def test_batched_dot_patches_are_the_virtual_rows(bd):
    """The batched form's patches (the pre-pass's output): block k's K rows
    of hist ++ x from its origin, as float32, zero past the chunk."""
    g, hist, x = bd
    kw = p11.launch_kw(g, n_periods=GRID)
    pt = p11.patches_reference(hist, x, g.K, **kw)
    virt = np.concatenate([hist.numpy(), x.numpy(),
                           np.zeros((g.K, LANES), np.int16)])
    for k in (0, 1, 19, 20, 39):
        v0 = (k // g.P) * g.S + g.offsets[k % g.P]
        np.testing.assert_array_equal(pt[k].numpy(),
                                      virt[v0:v0 + g.K].astype(np.float32))


# -- P12: conv_v3 and its step -------------------------------------------------

def _pallas_conv_v3(x, wT, g, n_periods):
    """experiments/v3_bench.py's kern and conv_v3, interpreted, at a grid of
    (1 lane tile, n_periods)."""
    P, K, R, S, OFFS = g.P, g.K, g.R, g.S, g.offsets
    T, Bn = x.shape

    def _w2i(v):
        y = jnp.floor(0.5 + v)
        y = jnp.where(v < -32767.5, -32768.0, y)
        y = jnp.where(v > 32766.5, 32767.0, y)
        return y.astype(jnp.int16)

    def kern(w_ref, x_ref, o_ref):
        j = pl.program_id(1)
        base = j * S
        for m in range(P):
            off = base + OFFS[m]
            patch = x_ref[pl.ds(off, K), :].astype(jnp.float32)
            o_ref[m] = _w2i(jnp.dot(w_ref[m], patch,
                                    precision=jax.lax.Precision.HIGHEST,
                                    preferred_element_type=jnp.float32))

    return _call(kern, (1, n_periods),
                 [pl.BlockSpec((P, R, K), lambda i, j: (0, 0, 0)),
                  pl.BlockSpec((T, Bn), lambda i, j: (0, i))],
                 pl.BlockSpec((P, R, Bn), lambda i, j: (j, 0, i)),
                 jax.ShapeDtypeStruct((n_periods * P, R, Bn), jnp.int16),
                 wT, x)


def test_v3_bench_conv_is_p6_full():
    """conv_v3's T (max(N - 1 + n_in, T_req) rounded up to 16) is P6's,
    9552, and the port's conv is P6's full, bit for bit."""
    g = p6.geometry()
    N, n_in = p12.filt_len(), 4 * g.S
    T_req = 3 * g.S + g.offsets[-1] + g.K
    assert -(-max(N - 1 + n_in, T_req) // 16) * 16 == g.T == 9552
    x = p12.inputs(g, B=16, seed=2)[0]
    w, kw = p6.weights(g), p6.launch_kw(g, n_periods=GRID)
    assert torch.equal(p12.conv(x, w, **kw),
                       p6.anatomy_reference("full", x, w, **kw))


def test_v3_bench_plain_matches_experiment():
    """The port's conv and step against conv_v3 and the experiment's step
    (concat of hist, chunk and zeros; the conv; rows n_in .. n_in + N - 1
    of the concat), interpreted, 2 periods on 128 lanes, a nonzero
    history."""
    g = p6.geometry()
    x, chunk, hist = p12.inputs(g, B=LANES, seed=7)
    x = torch.from_numpy(_edges(x.numpy().copy(), g.T))
    chunk = x[:4 * g.S]
    rng = np.random.default_rng(8)
    hist = torch.from_numpy(rng.integers(-32768, 32768, tuple(hist.shape))
                            .astype(np.int16))
    wT = jnp.asarray(g.w.transpose(0, 2, 1))
    w, kw = p6.weights(g), p6.launch_kw(g, n_periods=GRID)
    want = _pallas_conv_v3(jnp.asarray(x.numpy()), wT, g, GRID)
    got = p12.conv(x, w, **kw).numpy()
    assert_lsb_close(got.reshape(want.shape), want)
    N, n_in = p12.filt_len(), chunk.shape[0]
    pad_rows = g.T - (N - 1 + n_in)
    assert pad_rows == 17
    X = jnp.concatenate([jnp.asarray(hist.numpy()), jnp.asarray(chunk.numpy()),
                         jnp.zeros((pad_rows, LANES), jnp.int16)], axis=0)
    want_y = _pallas_conv_v3(X, wT, g, GRID)
    want_h = np.asarray(jax.lax.dynamic_slice_in_dim(X, n_in, N - 1, axis=0))
    h2, y2 = p12.step(hist, chunk, w, **kw)
    np.testing.assert_array_equal(h2.numpy(), want_h)
    assert_lsb_close(y2.numpy().reshape(want_y.shape), want_y)
    h3, y3 = p12.step_reference(hist, chunk, w, **kw)
    assert torch.equal(h2, h3) and torch.equal(y2, y3)


# -- the source text the tests restate ---------------------------------------

PINS = {
    "v5_int8_bench.py": [
        "B = 2048",
        "N_PERIODS = 4",
        "ptw = ph.build_phase_tiled_weights(spec.phase_table, 147, 160, 0)",
        "T = -(-((N_PERIODS - 1) * S + OFFS[-1] + K) // 16) * 16",
        "pl8 = int8_planes.decompose(ptw.w, sw=23)",
        "assert pl8.err_bound <= 0.35, \"certificate gate failed\"",
        "wT8 = jnp.asarray(pl8.planes.transpose(0, 1, 3, 2))",
        "w_s5 = jnp.asarray(split5_weights(\n    ptw.w.transpose(0, 2, 1)))",
        "u = x_ref[pl.ds(base + OFFS[m], K), :].astype(jnp.int32)",
        "xh = (u >> 8).astype(jnp.int8)",
        "xl = ((u & 255) - 128).astype(jnp.int8)",
        "acc += (256 * ah + al).astype(jnp.float32) * SCALES[d]",
        "o_ref[m] = _word2int(acc + b_ref[m][:, None])",
        "xf = x_ref[pl.ds(base + OFFS[m], K), :].astype(jnp.float32)",
        "xl = (xf - xh.astype(jnp.float32)).astype(jnp.bfloat16)",
        "o_ref[m] = _word2int(d(w_hi, xh) + d(w_hi, xl) + d(w_mid, xh)\n"
        "                             + d(w_mid, xl) + d(w_lo, xh))",
        "x_np = (rng.integers(-32768, 32768, size=(T, B)) // 2)"
        ".astype(np.int16)",
        "t = np.arange(n_blocks * R, dtype=np.int64) * 147",
        "gold = np.array([xi[starts[i]:starts[i] + N] @ taps[i]"
        ".astype(np.float64)",
        "gi = np.clip(np.floor(0.5 + gold), -32768, 32767).astype(np.int32)",
    ],
    "batched_dot.py": [
        "B = 2048",
        "N_PERIODS = 4",
        "H = 128",
        "ptw = ph.build_phase_tiled_weights(spec.phase_table, 147, 160, 0,\n"
        "                                   origin_shift=H - (spec.filt_len"
        " - 1))",
        "T_c = (N_PERIODS - back + V) * S",
        "scratch[m, pl.ds(dst, ln), :] = \\\n"
        "                        ref[pl.ds(s0, ln), :].astype(jnp.float32)",
        "gen = _v3_parts(off_m, S, K, H, \"general\")",
        "dimension_numbers=(((2,), (1,)), ((0,), (0,))),",
        "lambda i, j, v=v: (jnp.clip(j - back + v, 0,\n"
        "                                        n_chunk_blocks - 1), i),",
        "wT = jnp.asarray(ptw.w.transpose(0, 2, 1).astype(np.float32))",
        "x_np[:n_in] = (rng.integers(-32768, 32768, size=(n_in, B)) // 2",
        "hist0 = jnp.zeros((H, B), dtype=jnp.int16)",
    ],
    "v3_bench.py": [
        "B = 2048",
        "N_PERIODS = 4",
        "ptw = ph.build_phase_tiled_weights(spec.phase_table, 147, 160, 0)",
        "T = max(N - 1 + n_in, T_req)",
        "patch = x_ref[pl.ds(off, K), :].astype(jnp.float32)",
        "o_ref[m] = _w2i(jnp.dot(w_ref[m], patch,",
        "pad_rows = T - (N - 1 + n_in)",
        "[hist, chunk, jnp.zeros((pad_rows, chunk.shape[1]), jnp.int16)],",
        "return lax.dynamic_slice_in_dim(X, n_in, N - 1, axis=0), y",
        "hist0 = jnp.zeros((N - 1, B), dtype=jnp.int16)",
        "x_np = (rng.integers(-32768, 32768, size=(T, B)) // 2)"
        ".astype(np.int16)",
    ],
    "v4_k_layout.py": [
        "R, LB = 128, 1024",
        "G1, G2 = 512, 8192",
        "N_REPS = 16",
        "for K in (512, 448, 440):",
        "for form in (\"rk\", \"kr\"):",
        "-128, 128, size=(R, K) if form == \"rk\" else (K, R)",
        "-128, 128, size=(N_REPS, K, LB)).astype(np.int8))",
        "macs_per_step = N_REPS * R * K * LB",
    ],
}


@pytest.mark.parametrize("name", sorted(PINS))
def test_restated_source_still_in_experiments(name):
    text = (EXPERIMENTS / name).read_text()
    missing = [p for p in PINS[name] if p not in text]
    assert not missing, f"{name} no longer holds {missing}"


# -- the wrappers and the build ----------------------------------------------

def _meta(t):
    return t.to("meta") if torch.is_tensor(t) else t


def test_wrappers_take_the_plain_version_on_cpu_only():
    before = (p9.launches, ptr.launches, p11.launches, p6.launches)
    g9 = p9.geometry()
    x9 = p9.inputs(g9, B=8, seed=1)
    for scheme in p9.SCHEMES:
        w9, kw9 = p9.weights(g9, scheme), p9.launch_kw(g9, scheme,
                                                       n_periods=1)
        assert torch.equal(p9.bench(scheme, x9, w9, **kw9),
                           p9.bench_reference(scheme, x9, w9, **kw9))
        with pytest.raises(ValueError, match="no kernel"):
            p9.bench(scheme, _meta(x9), tuple(_meta(t) for t in w9),
                     **{**kw9, "offsets": _meta(kw9["offsets"])})
    with pytest.raises(ValueError, match="scheme"):
        p9.bench("fixed", x9, w9, **kw9)
    w10, x10 = p10.operands(448, "kr", R=32, LB=64, reps=2)
    assert torch.equal(p10.k_layout(w10, x10, "kr"),
                       p10.k_layout_reference(w10, x10, "kr"))
    with pytest.raises(ValueError, match="no kernel"):
        p10.k_layout(_meta(w10), _meta(x10), "kr")
    with pytest.raises(ValueError, match="form"):
        p10.k_layout(w10, x10, "rr")
    with pytest.raises(ValueError, match=r"\[K, C\]"):
        p10.k_layout(w10.t(), x10, "kr")
    g11 = p11.geometry()
    h11, x11 = p11.inputs(g11, B=8, seed=2)
    w11, kw11 = p11.weights(g11), p11.launch_kw(g11, n_periods=1)
    for form in p11.FORMS:
        assert torch.equal(
            p11.batched_dot(form, h11, x11, w11, **kw11),
            p11.batched_dot_reference(form, h11, x11, w11, **kw11))
    with pytest.raises(ValueError, match="no kernel"):
        p11.batched_dot("batched", _meta(h11), _meta(x11),
                        tuple(_meta(t) for t in w11),
                        **{**kw11, "offsets": _meta(kw11["offsets"])})
    with pytest.raises(ValueError, match="lanes"):
        p11.batched_dot("m-loop", h11, x11, w11, lanes=32, **kw11)
    g12 = p6.geometry()
    x12, c12, h12 = p12.inputs(g12, B=8, seed=3)
    w12, kw12 = p6.weights(g12), p6.launch_kw(g12, n_periods=1)
    assert torch.equal(p12.conv(x12, w12, **kw12),
                       p12.conv_reference(x12, w12, **kw12))
    with pytest.raises(ValueError, match="no kernel"):
        p12.step(_meta(h12), _meta(c12), tuple(_meta(t) for t in w12),
                 **{**kw12, "offsets": _meta(kw12["offsets"])})
    assert (p9.launches, ptr.launches, p11.launches, p6.launches) == before


def test_probe_hash_covers_the_new_sources(tmp_path, monkeypatch):
    """libprobes is built from P9's and P11's sources and the header P6
    shares with P11 too (P10 runs in the rate kernel's source, P12 in
    P6's): editing one renames the library; their entry points are
    declared."""
    import shutil
    for name in ("v5_bench.cu", "batched_dot.cu"):
        assert f"probes/{name}" in _build._PROBE_SOURCE_NAMES
    assert "probes/f32_anatomy.cuh" in _build._PROBE_HEADER_NAMES
    copy = tmp_path / "csrc"
    shutil.copytree(_build._PROBE_CSRC, copy)
    monkeypatch.setattr(_build, "_PROBE_CSRC", copy)
    name = _build.probe_lib_path()
    for rel in ("probes/v5_bench.cu", "probes/batched_dot.cu",
                "probes/f32_anatomy.cuh", "probes/tc_rate.cu",
                "probes/f32_anatomy.cu"):
        path = copy / rel
        text = path.read_text()
        path.write_text(text + "\n// edited\n")
        assert _build.probe_lib_path() != name, rel
        path.write_text(text)
    assert _build.probe_lib_path() == name
    sig = _build._PROBE_SIGNATURES
    for fn in ("probe_v5_bench", "probe_batched_dot", "probe_batched_patches"):
        assert fn in sig
    # the rate kernel's entry points take reps and kr
    assert len(sig["probe_tc_rate"][1]) == 19
    assert len(sig["probe_tc_rate_fill"][1]) == 9
