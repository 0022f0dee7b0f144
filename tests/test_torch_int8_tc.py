"""The streamed int8 kernel's tensor-core layout, on the CPU.

``csrc/int8_wgmma.cuh`` runs the int8 scheme of the streamed kernel on the
int8 tensor cores: x split into bytes (xh = x >> 8, xl = (x & 255) - 128,
the low byte with its top bit flipped), the digit planes K-major,
int8[D, P, R, K_pad], each 32-tap group permuted to the order in which the
kernel's ldmatrix / byte-permute staging lays taps into the wgmma A
fragment (``streamed_fir.K_PERM``).  Nothing here launches a kernel; the
tests pin what the kernel assumes:

- the byte split equals ``_dot_int8``'s xh / xl for all 65,536 int16;
- a NumPy model of the fragment staging puts tap ``K_PERM[k]`` at K
  position k, so the permuted planes give the tap-order dot;
- the K-major, permuted planes map back to ``[D, P, K_pad, R]`` exactly,
  and ``weights_from_jax`` gives the same device weights;
- the plain version on the new layout equals the JAX package's v4 int8
  kernel (interpret mode) bit for bit, D = 3 and 4, at a small size.

The kernel itself is held against the plain version by
tests/test_torch_gpu.py and chip_smoke.py on the card.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speex_resampler_tpu.ops import pallas_fir as jpf
from speex_resampler_tpu_torch.ops import streamed_fir as tsf
from speex_resampler_tpu_torch.ops import tiled_fir as ttf
from speex_resampler_tpu_torch.parallel import batch as tb

torch.set_num_threads(1)


def test_byte_split_equals_dot_int8():
    """xh = the high byte, xl = the low byte ^ 0x80 (as int8), for every
    int16 x, equal to _dot_int8's expressions, and x - 128 = 256 xh + xl."""
    src = inspect.getsource(jpf._dot_int8)
    assert "xh = (u32 >> 8).astype(jnp.int8)" in src
    assert "xl = ((u32 & 255) - 128).astype(jnp.int8)" in src
    x = np.arange(-32768, 32768, dtype=np.int32).astype(np.int16)
    bits = x.view(np.uint16)
    xh = (bits >> 8).astype(np.uint8).view(np.int8)
    xl = ((bits & 0xFF) ^ 0x80).astype(np.uint8).view(np.int8)
    u32 = jnp.asarray(x).astype(jnp.int32)
    assert np.array_equal(xh, np.asarray((u32 >> 8).astype(jnp.int8)))
    assert np.array_equal(xl, np.asarray(((u32 & 255) - 128)
                                         .astype(jnp.int8)))
    assert np.array_equal(256 * xh.astype(np.int32) + xl,
                          x.astype(np.int32) - 128)


def test_k_perm_permutes_each_half():
    assert sorted(tsf.K_PERM[:16]) == list(range(16))
    assert sorted(tsf.K_PERM[16:]) == list(range(16, 32))


def _byte_perm(a: int, b: int, sel: int) -> int:
    """CUDA's __byte_perm: result byte i is byte (sel >> 4i) & 7 of b:a."""
    src = [(a >> (8 * i)) & 0xFF for i in range(4)] + \
          [(b >> (8 * i)) & 0xFF for i in range(4)]
    return sum(src[(sel >> (4 * i)) & 7] << (8 * i) for i in range(4))


def _ldmatrix_trans(x: np.ndarray, tap0: int, l: int) -> list:
    """ldmatrix.x4.trans of int16 x[tap][lane] (one warp's 16 lanes):
    thread l's four registers, matrix p at taps tap0 + 8*(p // 2) .., lanes
    8*(p % 2) ..; transposed, thread l holds lane l // 4, taps 2*(l % 4)
    and 2*(l % 4) + 1 (low half first)."""
    g, t = l // 4, l % 4
    out = []
    for p in range(4):
        tap = tap0 + 8 * (p // 2) + 2 * t
        lane = 8 * (p % 2) + g
        lo, hi = (int(v) & 0xFFFF for v in x[tap:tap + 2, lane])
        out.append(lo | hi << 16)
    return out


def test_fragment_model_matches_k_perm():
    """The kernel's load_split, modelled in NumPy: fragment register r of
    thread l holds lane g + 8*(r % 2) (g = l // 4) at K positions
    16*(r // 2) + 4*(l % 4) + j, byte j; that K position must hold tap
    K_PERM[k] of the slice, split into xh / xl, so the K-major permuted
    weights give each lane's tap-order dot."""
    rng = np.random.default_rng(0)
    x = rng.integers(-32768, 32768, (32, 16), dtype=np.int16)
    x[0, 0], x[1, 1] = -32768, 32767
    A = {"h": np.zeros((16, 32), np.int64), "l": np.zeros((16, 32), np.int64)}
    for l in range(32):
        lo, hi = _ldmatrix_trans(x, 0, l), _ldmatrix_trans(x, 16, l)
        for r in range(4):
            a = lo[r % 2] if r < 2 else hi[r % 2]
            b = lo[2 + r % 2] if r < 2 else hi[2 + r % 2]
            regs = {"h": _byte_perm(a, b, 0x7531),
                    "l": _byte_perm(a, b, 0x6420) ^ 0x80808080}
            for part, reg in regs.items():
                for j in range(4):
                    k = 16 * (r // 2) + 4 * (l % 4) + j
                    byte = (reg >> (8 * j)) & 0xFF
                    A[part][l // 4 + 8 * (r % 2), k] = \
                        byte - 256 * (byte > 127)
    xs = x[tsf.K_PERM].astype(np.int64).T               # [lane, K position]
    assert np.array_equal(A["h"], xs >> 8)
    assert np.array_equal(A["l"], (xs & 255) - 128)
    w = rng.integers(-128, 128, (1, 1, 32, 8), dtype=np.int8)   # [.., K, R]
    b = tsf.int8_k_major(w.transpose(0, 1, 3, 2))[0, 0].numpy() \
        .astype(np.int64)                                        # [R, K]
    want = (x.astype(np.int64) - 128).T @ w[0, 0].astype(np.int64)
    assert np.array_equal(256 * A["h"] @ b.T + A["l"] @ b.T, want)


def _planes(D: int, P: int, K: int, R: int, seed: int):
    """Random int8 digit planes [D, P, K, R] zero outside a tap band per
    phase, a bias and D scales 2^(8d - 31)."""
    rng = np.random.default_rng(seed)
    planes = rng.integers(-128, 128, (D, P, K, R), dtype=np.int8)
    for m in range(P):
        lo = 16 + 40 * m
        planes[:, m, :lo] = 0
        planes[:, m, lo + 150:] = 0
    bias = (rng.standard_normal((P, R)) * 100).astype(np.float32)
    scales = tuple(float(2.0 ** (8 * d - 31)) for d in range(D))
    return planes, bias, scales


@pytest.mark.parametrize("D", [3, 4])
def test_k_major_planes_map_back(D):
    planes, bias, _ = _planes(D, 3, 256, 128, seed=D)
    w = tsf.device_weights_streamed((planes, bias), "int8", "cpu")
    assert w[0].shape == (D, 3, 128, 256) and w[0].is_contiguous()
    assert np.array_equal(tsf.int8_n_major(w[0]).numpy(), planes)
    kt = w[0].numpy().reshape(D, 3, 128, 8, 32)
    assert np.array_equal(kt[..., 5], planes.transpose(0, 1, 3, 2)
                          .reshape(D, 3, 128, 8, 32)[..., tsf.K_PERM[5]])
    assert np.array_equal(w[1].numpy(), bias)
    assert np.array_equal(w[2].numpy(),
                          ttf.tap_ranges((planes != 0).any(axis=0)))
    jax_planes = np.ascontiguousarray(planes.transpose(1, 0, 3, 2))
    got = tb.weights_from_jax((jax_planes, bias), "int8", device="cpu",
                              kernel="streamed")
    assert all(torch.equal(a, b) for a, b in zip(got, w))


def test_streamed_int8_guards():
    """N-major planes, or K-major planes whose K is not a multiple of 32,
    are refused."""
    planes, bias, scales = _planes(3, 2, 256, 64, seed=9)
    w = tsf.device_weights_streamed((planes, bias), "int8", "cpu")
    hist = torch.zeros((32, 4), dtype=torch.int16)
    x = torch.zeros((1024, 4), dtype=torch.int16)
    kw = dict(n_blocks=2, shift=8, num=3, den=2, f0=0, scheme="int8",
              scales=scales)
    tsf.resample_streamed(hist, x, w, **kw)
    with pytest.raises(TypeError):
        tsf.resample_streamed(hist, x, (torch.from_numpy(planes), *w[1:]),
                              **kw)
    odd = w[0][..., :240].contiguous()
    with pytest.raises(ValueError, match="multiple of 32"):
        tsf.resample_streamed(hist, x, (odd, *w[1:]), **kw)


@pytest.mark.parametrize("B", [4, 130])
@pytest.mark.parametrize("D", [3, 4])
def test_plain_on_k_major_equals_jax_v4(D, B):
    """P = 2 phases, R 128, K_pad 256, 4 blocks 192 input rows apart (num 3,
    den 2), windows starting in the history; int16 extremes in x."""
    P, K, R, n_blocks, H = 2, 256, 128, 4, 32
    planes, bias, scales = _planes(D, P, K, R, seed=10 + D)
    rng = np.random.default_rng(B + D)
    hist = rng.integers(-32768, 32768, (H, B), dtype=np.int16)
    x = rng.integers(-32768, 32768, (832, B), dtype=np.int16)
    x[::7] = -32768
    x[3::11] = 32767
    kw = dict(n_blocks=n_blocks, shift=8, num=3, den=2, f0=1)
    jax_planes = np.ascontiguousarray(planes.transpose(1, 0, 3, 2))
    jy = jpf.resample_conv_tm_pallas_v4(
        jnp.asarray(hist), jnp.asarray(x),
        (jnp.asarray(jax_planes), jnp.asarray(bias)), interpret=True,
        scheme="int8", scales=scales, **kw)
    w = tb.weights_from_jax((jax_planes, bias), "int8", device="cpu",
                            kernel="streamed")
    ty = tsf.resample_streamed_reference(torch.from_numpy(hist),
                                         torch.from_numpy(x), w,
                                         scheme="int8", scales=scales, **kw)
    assert ty.shape == (n_blocks * R, B)
    assert np.array_equal(ty.numpy(), np.asarray(jy))
