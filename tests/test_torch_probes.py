"""The tensor-core probes' plain versions against the TPU probes' arithmetic,
on the CPU.

``speex_resampler_tpu_torch.probes`` ports the Pallas kernels of
``experiments/mxu_peak.py``, ``mxu_shape_probe.py`` (P3/P4, one rate
kernel), ``v4_overhead_anatomy.py`` (P1) and ``fixed_interp_anatomy.py``
(P2).  The experiments' kernel bodies are closures in their ``main()``, so
P1, P3 and P4 are restated here as the experiment writes them and run
through ``pl.pallas_call(..., interpret=True)`` at a grid of 2 and small
shapes; P2 calls the JAX package's ``_dot_fixed`` and ``_fixed_mix_rows``
at the probe's real shape, with the wrap input of ``tests/fixed_inputs.py``
on some lanes and rows of -32768 and 32767 on others.  A source-pin test
fails when a restated expression no longer occurs in ``experiments/``, a
layout test models the int8 fragment the kernels load (the K padding and
``K_PERM`` packing of the weights), and the CPU wrappers take the plain
version.  Tolerance: 0 mismatches everywhere (bf16: the drawn data keep
every partial sum below 2^24, so the float32 sums are exact).  Nothing
here compiles or launches a kernel.
"""

import ast
import functools
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from speex_resampler_tpu.ops.pallas_fir import _dot_fixed, _fixed_mix_rows

from speex_resampler_tpu_torch.ops import _build
from speex_resampler_tpu_torch.ops import tiled_fir as ttf
from speex_resampler_tpu_torch.probes import (
    fixed_interp_anatomy as pfa, mxu_peak, mxu_shape_probe, tc_rate as ptr,
    v4_overhead_anatomy as pv4)

import fixed_inputs

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
EXPERIMENTS = REPO / "experiments"
GRID = 2


# -- P3 / P4: the rate kernel's body ---------------------------------------

def _pallas_rate(w, x, wdt, C, K, LB):
    """experiments/mxu_peak.py make_fn (mxu_shape_probe.py's with LB a
    parameter), interpreted, at a grid of 2."""
    N_REPS = ptr.N_REPS
    acc_dt = jnp.float32 if wdt == jnp.bfloat16 else jnp.int32

    def kernel(w_ref, x_ref, o_ref):
        acc = jnp.zeros((C, LB), acc_dt)
        for r in range(N_REPS):
            acc += jnp.dot(w_ref[...], x_ref[r],
                           preferred_element_type=acc_dt)
        o_ref[0] = acc.astype(jnp.int32)

    return np.asarray(pl.pallas_call(
        kernel, grid=(GRID,),
        in_specs=[pl.BlockSpec((C, K), lambda i: (0, 0)),
                  pl.BlockSpec((N_REPS, K, LB), lambda i: (0, 0, 0))],
        out_specs=pl.BlockSpec((1, C, LB), lambda i: (i % 16, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((16, C, LB), jnp.int32),
        interpret=True)(w.astype(wdt), x.astype(wdt)))


@pytest.mark.parametrize("dtype", ptr.DTYPES)
@pytest.mark.parametrize("seed", [0, 1])
def test_rate_plain_matches_pallas(dtype, seed):
    C, K, LB = 64, 64, 32
    w, x = ptr.operands(C, K, LB, seed)
    if dtype == "bf16":   # every partial sum below 2^24: exact f32 sums
        bound = np.einsum("ck,rkl->cl", np.abs(w.numpy()).astype(np.int64),
                          np.abs(x.numpy()).astype(np.int64))
        assert bound.max() < 2 ** 24
    wdt = jnp.int8 if dtype == "int8" else jnp.bfloat16
    want = _pallas_rate(jnp.asarray(w.numpy()), jnp.asarray(x.numpy()), wdt,
                        C, K, LB)
    got = ptr.tc_rate(w, x, dtype).numpy()
    assert got.shape == (16, C, LB) and got.dtype == np.int32
    # the grid of 2 writes slots 0 and 1; the plain version has every slot
    np.testing.assert_array_equal(got[:GRID], want[:GRID])
    assert (got == got[0]).all()


# -- P1: the streamed int8 block -------------------------------------------

def _pallas_v4(variant, w8, x, R, LB):
    """experiments/v4_overhead_anatomy.py's k_mxu / k_ex32 / k_full,
    interpreted, at a grid of 2."""
    D = pv4.D

    def k_mxu(w_ref, x_ref, o_ref):
        acc = jnp.zeros((R, LB), jnp.int32)
        for d in range(D):
            acc += jnp.dot(w_ref[2 * d], x_ref[0],
                           preferred_element_type=jnp.int32)
            acc += jnp.dot(w_ref[2 * d + 1], x_ref[1],
                           preferred_element_type=jnp.int32)
        o_ref[0] = acc

    def k_ex32(w_ref, x_ref, o_ref):
        u32 = x_ref[...].astype(jnp.int32)
        xh = (u32 >> 8).astype(jnp.int8)
        xl = ((u32 & 255) - 128).astype(jnp.int8)
        o_ref[0] = (jnp.dot(w_ref[0], xh, preferred_element_type=jnp.int32)
                    + jnp.dot(w_ref[1], xl,
                              preferred_element_type=jnp.int32))

    def k_full(w_ref, x_ref, o_ref):
        u32 = x_ref[...].astype(jnp.int32)
        xh = (u32 >> 8).astype(jnp.int8)
        xl = ((u32 & 255) - 128).astype(jnp.int8)
        acc = jnp.zeros((R, LB), jnp.int32)
        for d in range(D):
            acc += jnp.dot(w_ref[2 * d], xh,
                           preferred_element_type=jnp.int32)
            acc += jnp.dot(w_ref[2 * d + 1], xl,
                           preferred_element_type=jnp.int32)
        o_ref[0] = acc

    kernel = {"mxu_only": k_mxu, "extract_i32+2": k_ex32,
              "full": k_full}[variant]
    return np.asarray(pl.pallas_call(
        kernel, grid=(GRID,),
        in_specs=[pl.BlockSpec(w8.shape, lambda i: (0,) * w8.ndim),
                  pl.BlockSpec(x.shape, lambda i: (0,) * x.ndim)],
        out_specs=pl.BlockSpec((1, R, LB), lambda i: (i % 16, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((16, R, LB), jnp.int32),
        interpret=True)(w8, x))


@pytest.mark.parametrize("variant", pv4.VARIANTS)
def test_v4_anatomy_plain_matches_pallas(variant):
    R, K, LB = 64, 64, 128
    w8, x16, x8 = pv4.inputs(R, K, LB, seed=2)
    x16[0, ::3], x16[1, 1::3] = -32768, 32767
    x = x8 if variant == "mxu_only" else x16
    want = _pallas_v4(variant, jnp.asarray(w8.numpy()),
                      jnp.asarray(x.numpy()), R, LB)
    got = pv4.anatomy(variant, w8, x, n=32).numpy()
    assert got.shape == (16, R, LB) and got.dtype == np.int32
    np.testing.assert_array_equal(got[:GRID], want[:GRID])
    assert (got == got[0]).all()


def test_v4_split_is_load_splits():
    """xh, xl = x >> 8, (x & 255) - 128: x = 256 xh + xl + 128, and xl is
    the low byte with its top bit flipped (int8tc::load_split's ^ 0x80)."""
    x = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
    xh, xl = pv4.split(x)
    assert torch.equal(256 * xh.int() + xl.int() + 128, x.int())
    low = (x.int() & 255) ^ 0x80
    assert torch.equal(xl.int() & 255, low)


# -- P2: the fixed interpolated ladder -------------------------------------

def _jax_rung(rung, planes, bias, coef, x):
    """experiments/fixed_interp_anatomy.py's rep_loop and bodies, on the
    JAX package's _dot_fixed and _fixed_mix_rows."""
    R = coef.shape[1]
    plane = lambda p: planes[p]  # noqa: E731
    acc16 = None
    for r in range(pfa.N_REPS):
        if rung == "mxu_only":
            xs = x.astype(jnp.int8)
            xs = xs.at[0, 0].add(jnp.int8(r))
            xs2 = xs + jnp.int8(1)
            d = functools.partial(jnp.dot, preferred_element_type=jnp.int32)
            wh, wl = plane(0), plane(1)
            acc = d(wh, xs) + d(wh, xs2) + d(wl, xs) + d(wl, xs2)
            out = acc[:R].astype(jnp.int16)
        elif rung == "full":
            xs = x.at[0, 0].add(jnp.int16(r))
            out = _fixed_mix_rows(_dot_fixed(plane, bias, xs), coef)
        else:
            xs = x.astype(jnp.int16)
            xs = xs.at[0, 0].add(jnp.int16(r))
            out = _dot_fixed(plane, bias, xs)[:R].astype(jnp.int16)
        acc16 = out if acc16 is None else (acc16 + out).astype(jnp.int16)
    return np.asarray(acc16)


@pytest.fixture(scope="module")
def ladder_inputs():
    """The probe's operands at its real shape; x16 with the wrap input on
    every fifth lane (the set-0 row of the largest sum |w|, whose int32 sum
    passes 2^31) and rows of -32768 and 32767 on every seventh."""
    planes, bias, coef, xh, x16 = pfa.inputs(seed=3)
    w = planes[0].to(torch.int64) * 256 + planes[1].to(torch.int64)
    c = int(w[:pfa.R].abs().sum(1).argmax())
    x = x16.numpy().copy()
    assert fixed_inputs.wrap_column(w[c].numpy(), x,
                                    np.arange(0, pfa.LB, 5)) > 2 ** 31
    x[0, 1::7], x[1, 1::7] = -32768, 32767
    return planes, bias, coef, xh, torch.from_numpy(x)


@pytest.mark.parametrize("rung", pfa.RUNGS)
def test_fixed_ladder_plain_matches_jax(rung, ladder_inputs):
    planes, bias, coef, xh, x16 = ladder_inputs
    x = pfa.rung_input(rung, xh, x16)
    want = _jax_rung(rung, jnp.asarray(planes.numpy()),
                     jnp.asarray(bias.numpy()), jnp.asarray(coef.numpy()),
                     jnp.asarray(x.numpy()))
    got = pfa.ladder(rung, planes, bias, coef, x).numpy()
    assert got.shape == (16, pfa.R, pfa.LB) and got.dtype == np.int16
    np.testing.assert_array_equal(got[0], want)
    assert (got == got[0]).all()


def test_fixed_dot_wraps_as_jax(ladder_inputs):
    """dot_fixed equals the JAX package's _dot_fixed mod 2^32 where the sums
    pass 2^31."""
    planes, bias, _, _, x16 = ladder_inputs
    want = np.asarray(_dot_fixed(lambda p: jnp.asarray(planes.numpy())[p],
                                 jnp.asarray(bias.numpy()),
                                 jnp.asarray(x16.numpy())))
    got = pfa.dot_fixed(planes, bias, x16).numpy()
    np.testing.assert_array_equal(got, want)
    w = planes[0].numpy().astype(np.int64) * 256 + planes[1].numpy()
    true = w @ x16.numpy().astype(np.int64) + bias.numpy()[:, None]
    assert np.abs(true).max() > 2 ** 31 and (true != got).any()


# -- the source text the tests restate -------------------------------------

PINS = {
    "mxu_peak.py": [
        "N_REPS = 8",
        "acc = jnp.zeros((C, LB), acc_dt)",
        "acc += jnp.dot(w_ref[...], x_ref[r],",
        "o_ref[0] = acc.astype(jnp.int32)",
        "out_specs=pl.BlockSpec((1, C, LB), lambda i: (i % 16, 0, 0),",
        "w = jnp.asarray(rng.integers(-128, 128, size=(C, K)).astype(np.int16))",
    ],
    "mxu_shape_probe.py": [
        "N_REPS = 8",
        "acc += jnp.dot(w_ref[...], x_ref[r],",
        "o_ref[0] = acc.astype(jnp.int32)",
        ")(w.astype(wdt), x.astype(wdt))",
    ],
    "v4_overhead_anatomy.py": [
        "R, K, LB = 128, 512, 1024",
        "D = 4",
        "xh = (u32 >> 8).astype(jnp.int8)",
        "xl = ((u32 & 255) - 128).astype(jnp.int8)",
        "acc += jnp.dot(w_ref[2 * d], x_ref[0],",
        "acc += jnp.dot(w_ref[2 * d + 1], x_ref[1],",
        "o_ref[0] = (jnp.dot(w_ref[0], xh, preferred_element_type=jnp.int32)",
        "acc += jnp.dot(w_ref[2 * d + 1], xl,",
        "w8 = jnp.asarray(rng.integers(-128, 128, (2 * D, R, K)).astype(np.int8))",
        "x16 = jnp.asarray(rng.integers(-32768, 32768, (K, LB)).astype(np.int16))",
        "x8 = jnp.asarray(rng.integers(-128, 128, (2, K, LB)).astype(np.int8))",
    ],
    "fixed_interp_anatomy.py": [
        "R, K, LB = 128, 264, 128",
        "N_REPS = 4",
        "acc16 = out if acc16 is None else (acc16 + out).astype(jnp.int16)",
        "xs = xs.at[0, 0].add(jnp.int8(r))",
        "xs2 = xs + jnp.int8(1)",
        "acc = d(wh, xs) + d(wh, xs2) + d(wl, xs) + d(wl, xs2)",
        "return acc[:R].astype(jnp.int16)",
        "xs = x_ref[...].astype(jnp.int16)",
        "xs = xs.at[0, 0].add(jnp.int16(r))",
        "acc = _dot_fixed(lambda p: w_ref[p], b_ref[...], xs)",
        "return _fixed_mix_rows(acc, c_ref[...])",
        "t_comb = run(\"+combine\", k_comb, (planes, bias, xh.astype(jnp.int16)),",
        "t_ext = run(\"+extract\", k_comb, (planes, bias, x16), [w_s, b_s, x_s])",
        "planes = jnp.asarray(rng.integers(-128, 128, (2, C, K)).astype(np.int8))",
        "bias = jnp.asarray(rng.integers(-2**20, 2**20, (C,)).astype(np.int32))",
        "coef = jnp.asarray(rng.integers(0, 32768, (4, R)).astype(np.int32))",
    ],
}


@pytest.mark.parametrize("name", sorted(PINS))
def test_restated_source_still_in_experiments(name):
    text = (EXPERIMENTS / name).read_text()
    missing = [p for p in PINS[name] if p not in text]
    assert not missing, f"{name} no longer holds {missing}"


def _literal(name: str, var: str):
    tree = ast.parse((EXPERIMENTS / name).read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == var for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError(f"{var} not in {name}")


def test_cases_equal_the_experiments():
    assert [tuple(s) for s in _literal("mxu_peak.py", "SHAPES")] == \
        mxu_peak.SHAPES
    assert [tuple(c) for c in _literal("mxu_shape_probe.py", "CASES")] == \
        mxu_shape_probe.CASES
    assert _literal("mxu_peak.py", "N_REPS") == ptr.N_REPS
    assert _literal("mxu_peak.py", "LB") == mxu_peak.LB


# -- the layout the kernels read --------------------------------------------

def _load_pairs_model(x):
    """csrc/probes/probe_common.cuh load_pairs on one warp's K-slice: x
    int8 [32 taps, 16 lanes] ([tap][lane] rows).  Returns the wgmma A
    fragment as a [16 M rows, 32 K positions] matrix: register 0 (2) of
    thread l holds row l/4, K 4t..4t+3 (16 + that), register 1 (3) row
    l/4 + 8 (mma.m16n8k32 s8 A layout, t = l % 4)."""
    xb = x.view(np.uint8)
    A = np.zeros((16, 32), np.int64)
    for l in range(32):
        g, t = l // 4, l % 4
        # ldmatrix.x4.trans: matrix q = taps 8q..8q+7; a thread gets rows
        # 2t, 2t+1 of b16 column g = lanes 2g, 2g+1
        m = [[xb[8 * q + 2 * t, 2 * g], xb[8 * q + 2 * t, 2 * g + 1],
              xb[8 * q + 2 * t + 1, 2 * g], xb[8 * q + 2 * t + 1, 2 * g + 1]]
             for q in range(4)]
        even = lambda a, b: [a[0], a[2], b[0], b[2]]  # noqa: E731  0x6420
        odd = lambda a, b: [a[1], a[3], b[1], b[3]]   # noqa: E731  0x7531
        regs = [even(m[0], m[1]), odd(m[0], m[1]), even(m[2], m[3]),
                odd(m[2], m[3])]
        for r, reg in enumerate(regs):
            row = g + 8 * (r % 2)
            for j in range(4):
                A[row, 16 * (r // 2) + 4 * t + j] = np.int8(np.uint8(reg[j]))
    return A


def test_fragment_model_reads_k_perm_and_lane_pairs():
    """The fragment's K position p holds tap K_PERM[p]; its M rows g and
    g + 8 are lanes 2g and 2g + 1 (tile_lane<true>), so with W packed by
    K_PERM (tc_rate.pack) a wgmma's sum is the tap-order dot."""
    rng = np.random.default_rng(7)
    x = rng.integers(-128, 128, (32, 16)).astype(np.int8)
    A = _load_pairs_model(x)
    lane = np.array([2 * g for g in range(8)] + [2 * g + 1 for g in range(8)])
    np.testing.assert_array_equal(A, x[ttf.K_PERM][:, lane].T)
    # tile_lane<true>(w = 0, l, i): accumulator register i of thread l
    for l in range(32):
        for i in range(8):
            m_row = l // 4 + 8 * ((i // 2) % 2)
            assert lane[m_row] == 2 * (l // 4) + (i // 2) % 2
    w = rng.integers(-128, 128, (4, 32)).astype(np.int16)
    wp, _ = ptr.pack(torch.from_numpy(w),
                     torch.zeros((8, 32, 64), dtype=torch.int16), "int8")
    np.testing.assert_array_equal(A @ wp.numpy().T.astype(np.int64),
                                  x[:, lane].T.astype(np.int64) @ w.T)


@pytest.mark.parametrize("K", [264, 136, 520, 208, 400, 384, 512])
def test_k_padding_and_k_perm_packing(K):
    """K pads with zeros to a multiple of 32 (264 -> 288, 136 -> 160, 520
    -> 544, 208 -> 224, 400 -> 416); each 32-tap group of the int8 weights
    (tc_rate, v4 planes, fixed planes) is in K_PERM order, bf16 and x in
    tap order."""
    assert ptr.pad_k(K) == {264: 288, 136: 160, 520: 544, 208: 224,
                            400: 416, 384: 384, 512: 512}[K]
    w, x = ptr.operands(64, K, 64, seed=K)
    K_pad = ptr.pad_k(K)
    wpad = np.zeros((64, K_pad), np.int64)
    wpad[:, :K] = w.numpy()
    wp, xp = ptr.pack(w, x, "int8")
    assert wp.dtype == torch.int8 and wp.shape == (64, K_pad)
    np.testing.assert_array_equal(wp.numpy(), wpad[:, ttf.full_perm(K_pad)])
    assert xp.shape == (8, K_pad, 64) and not xp[:, K:].any()
    np.testing.assert_array_equal(xp[:, :K].numpy(), x.numpy())
    wb, xb = ptr.pack(w, x, "bf16")
    np.testing.assert_array_equal(wb.float().numpy(), wpad)
    assert xb.dtype == torch.bfloat16
    planes = torch.from_numpy(
        np.random.default_rng(K).integers(-128, 128, (2, 64, K)).astype(
            np.int8))
    pp, px = pfa.pack(planes, torch.ones((K, 64), dtype=torch.int16))
    ppad = np.zeros((2, 64, K_pad), np.int8)
    ppad[..., :K] = planes.numpy()
    np.testing.assert_array_equal(pp.numpy(), ppad[..., ttf.full_perm(K_pad)])
    assert px.shape == (K_pad, 64) and not px[K:].any()
    if K % 32 == 0:
        np.testing.assert_array_equal(
            pv4.pack_planes(planes).numpy(),
            ttf.int8_k_major(planes.numpy()[:, None]).numpy()[:, 0])


def test_every_case_has_a_tiling():
    """Every probe case plans a CTA within the H100's 227 KB, and the
    Python shared-memory sums are the sources' formulas."""
    cases = ([(d, C, K, mxu_peak.LB, None, 1) for d in ptr.DTYPES
              for C, K in mxu_peak.SHAPES]
             + [(d, C, K, mxu_peak.LB, n, s) for d in ptr.DTYPES
                for C, K, n, s in mxu_peak.SERVED]
             + [(d, C, K, LB, None, 1)
                for d, C, K, LB in mxu_shape_probe.CASES])
    for dtype, C, K, LB, n, per_sm in cases:
        p = ptr.plan(dtype, C, K, LB, n, per_sm)
        assert p.smem <= ptr.MAX_SMEM and C % p.n == 0 and p.rs * p.groups == 8
        assert per_sm == 1 or p.smem <= ptr.SM_SMEM // per_sm - 1024
        assert n is None or p.n == n
    for v in pv4.VARIANTS:
        for n in pv4.N_TILES:
            g = pv4.groups_for(v, n)
            assert pv4.smem_bytes(v, n, pv4.K // g) <= pv4.MAX_SMEM
    text = {f: (REPO / "speex_resampler_tpu_torch/csrc/probes" / f)
            .read_text() for f in ("tc_rate.cu", "int8_anatomy.cu",
                                   "fixed_anatomy.cu")}
    assert ("return kNa * kN * K * (kBf16 ? 2 : 1) + rs * kNb * K * "
            "pitch<kBf16, kN>()\n         + 128;") in text["tc_rate.cu"]
    assert "return kLanes * (kBf16 ? 2 : 1) + 16;" in text["tc_rate.cu"]
    assert ("(kVar == kMxu ? 2 * kb * kPitch8 : kb * kPitch16) + 128;"
            in text["int8_anatomy.cu"])
    assert "constexpr int kLanes = 64;" in (
        REPO / "speex_resampler_tpu_torch/csrc/probes/probe_common.cuh"
    ).read_text()


# -- the wrappers and the build ---------------------------------------------

def test_wrappers_take_the_plain_version_on_cpu_only():
    w, x = ptr.operands(64, 40, 64, seed=9)
    assert torch.equal(ptr.tc_rate(w, x, "int8"),
                       ptr.rate_reference(w, x, "int8"))
    meta = torch.empty((64, 40), dtype=torch.int16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ptr.tc_rate(meta, torch.empty((8, 40, 64), dtype=torch.int16,
                                      device="meta"), "int8")
    with pytest.raises(ValueError, match=r"\[-128, 128\)"):
        ptr.tc_rate(w * 2, x, "int8")
    w8, x16, x8 = pv4.inputs(64, 64, 64, seed=1)
    with pytest.raises(ValueError, match="int16"):
        pv4.anatomy("full", w8, x8)
    with pytest.raises(ValueError, match="no kernel"):
        pv4.anatomy("full", w8.to("meta"), x16.to("meta"))
    planes, bias, coef, xh, x16 = pfa.inputs(R=32, K=40, LB=64)
    with pytest.raises(ValueError, match="no kernel"):
        pfa.ladder("full", *(t.to("meta") for t in (planes, bias, coef,
                                                    x16)))
    assert pv4.launches == 0 and ptr.launches == 0 and pfa.launches == 0


def test_libfir_hash_unchanged_and_probe_hash_covers_headers(tmp_path,
                                                             monkeypatch):
    """libfir's name is still the hash of its flags, headers and sources;
    libprobes' covers its own sources and the production headers they
    include, so an edited header renames it."""
    import hashlib
    h = hashlib.sha1(" ".join(_build._FLAGS).encode())
    for src in (*_build._HEADERS, *_build._SOURCES):
        h.update(src.read_bytes())
    assert _build.lib_path().name == f"libfir.{h.hexdigest()[:12]}.so"
    name = _build.probe_lib_path()
    assert name.name.startswith("libprobes.") and name != _build.lib_path()
    copy = tmp_path / "csrc"
    shutil.copytree(_build._PROBE_CSRC, copy)
    monkeypatch.setattr(_build, "_PROBE_CSRC", copy)
    assert _build.probe_lib_path() == name
    for header in ("int8_wgmma.cuh", "fixed_wgmma.cuh", "fir_common.cuh",
                   "probes/probe_common.cuh"):
        path = copy / header
        text = path.read_text()
        path.write_text(text + "\n// edited\n")
        assert _build.probe_lib_path() != name, header
        path.write_text(text)
    assert _build.probe_lib_path() == name


def test_probe_modules_and_tool_load_no_jax_or_triton():
    code = (
        "import sys, importlib\n"
        "for m in ('tc_rate', 'mxu_peak', 'mxu_shape_probe',\n"
        "          'v4_overhead_anatomy', 'fixed_interp_anatomy'):\n"
        "    importlib.import_module('speex_resampler_tpu_torch.probes.' + m)\n"
        "sys.argv = ['tc_probes.py']\n"
        "import tools.tc_probes as t\n"
        "assert t.PARTS == ('rate', 'shape', 'v4', 'fixed', 'v3', 'intdot',"
        " 'anatomy', 'prec')\n"
        "import speex_resampler_tpu_torch.ops._build as b\n"
        "assert b._probe_lib is None and b._lib is None\n"
        "print(sorted(m for m in ('jax', 'triton', 'speex_resampler_tpu')"
        " if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
    for p in (REPO / "speex_resampler_tpu_torch" / "probes").glob("*.py"):
        text = p.read_text()
        assert "import jax" not in text and "experiments" not in "".join(
            line for line in text.splitlines()
            if line.startswith(("import", "from"))), p.name
