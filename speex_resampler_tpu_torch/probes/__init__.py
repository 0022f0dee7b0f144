"""Tensor-core probes: the Hopper counterparts of the TPU measurement probes
under ``experiments/`` that bound the served kernels.

- :mod:`.tc_rate`: the resident-operand rate kernel
  (``csrc/probes/tc_rate.cu``), its wrapper and plain version, shared by
- :mod:`.mxu_peak` (``experiments/mxu_peak.py``: the int8 and bf16 rate at
  the serving block shapes, and plain torch GEMM rates) and
- :mod:`.mxu_shape_probe` (``experiments/mxu_shape_probe.py``: the rate
  over block height, depth and lane width);
- :mod:`.v4_overhead_anatomy` (``experiments/v4_overhead_anatomy.py``: the
  streamed int8 block at D = 4 in three variants,
  ``csrc/probes/int8_anatomy.cu``);
- :mod:`.fixed_interp_anatomy` (``experiments/fixed_interp_anatomy.py``: the
  fixed interpolated block as a ladder of four rungs,
  ``csrc/probes/fixed_anatomy.cu``);
- :mod:`.v3_overhead_anatomy` (``experiments/v3_overhead_anatomy.py``: the
  flagship's int8 launch, K1b, in five variants,
  ``csrc/probes/v3_anatomy.cu``);
- :mod:`.mosaic_int_dot_bench` (``experiments/mosaic_int_dot_bench.py``:
  exact integer dots by operand width, on the rate kernel of
  :mod:`.tc_rate`: the wider forms as int8 digit products);
- :mod:`.kernel_anatomy` (``experiments/kernel_anatomy.py``: the tiled f32
  block on the CUDA cores in four variants, ``csrc/probes/f32_anatomy.cu``);
- :mod:`.prec_bench` (``experiments/prec_bench.py``: the FIR dot at each
  matrix-unit precision against a float64 gold,
  ``csrc/probes/prec_fir.cu``);
- :mod:`.v5_int8_bench` (``experiments/v5_int8_bench.py``: the int8 and
  split5 schemes at the flagship without the halo, the served bodies,
  ``csrc/probes/v5_bench.cu``);
- :mod:`.v4_k_layout` (``experiments/v4_k_layout.py``: the int8 body at
  K 512, 448 and 440 with W as [R, K] or [K, R], on the rate kernel of
  :mod:`.tc_rate`);
- :mod:`.batched_dot` (``experiments/batched_dot.py``: the f32 launch with
  its history phase by phase against one batched product,
  ``csrc/probes/batched_dot.cu``);
- :mod:`.v3_bench` (``experiments/v3_bench.py``: the f32 conv without
  history, P6's ``full`` kernel, inside the concat step);
- :mod:`.fixed_walk` (no TPU counterpart: the served persistent fixed
  walk with a witness that records each CTA's run of tiles and its band
  loads, ``csrc/probes/fixed_walk.cu``; the GPU tests run it, the tools
  below do not).

Each wrapper runs its plain version for CPU tensors and launches its
kernel (built at first use into ``build/torch_kernels/libprobes.<hash>.so``)
for CUDA tensors, or raises.  ``tools/tc_probes.py`` runs them all on the
card; ``chip_smoke.py`` phase 10 checks and times one case of each.  No
module here imports jax, triton, ``experiments/`` or the JAX package.
"""

import torch

from ..ops import streamed_fir as sf
from ..ops import tiled_fir as tf

__all__ = ["tc_rate", "mxu_peak", "mxu_shape_probe", "v4_overhead_anatomy",
           "fixed_interp_anatomy", "v3_overhead_anatomy",
           "mosaic_int_dot_bench", "kernel_anatomy", "prec_bench",
           "v5_int8_bench", "v4_k_layout", "batched_dot", "v3_bench",
           "fixed_walk", "check_offsets_launch", "served_tiled"]


def check_offsets_launch(hist, x, w, offsets, S: int, n_blocks: int,
                         scheme: str, scales: tuple) -> tuple:
    """Validate a probe launch of the tiled geometry that reads the TPU
    program's origin table, block k's patch at ``(k // P) * S +
    offsets[k % P]`` (the served kernels take the closed form instead),
    with the served launch's buffer and weight checks
    (``tiled_fir.check_launch``; "int8" weights with their slice count);
    returns (P, K, R)."""
    P, K, R = tf.check_launch(hist, x, w, scheme, scales, extra=(offsets,))
    if scheme == "int8" and (len(w) != 4 or type(w[2]) is not int
                             or not 0 <= w[2] <= K // 32):
        raise ValueError("tiled int8 weights must be (planes, bias, "
                         "slices, taps), slices an int in [0, K / 32]")
    if offsets.dtype != torch.int32:
        raise TypeError("offsets must be int32")
    if tuple(offsets.shape) != (P,) or n_blocks % P or S <= 0:
        raise ValueError(f"n_blocks {n_blocks}, offsets "
                         f"{tuple(offsets.shape)} for P = {P}")
    return P, K, R


def served_tiled(hist, x, w, *, offsets, S: int, n_blocks: int,
                 scheme: str, scales: tuple = ()):
    """The served launch (``streamed_fir.resample_streamed``; "int8" with
    the slice count: the resident kernel) of a probe's flagship launch
    (44.1 kHz -> 48 kHz q7, f0 0) at the closed-form origins whose shift
    (the probe's history rows less filt_len - 1, or 0 without a history)
    gives the probe's origin table ``offsets`` and period ``S``."""
    R = w[0].shape[-2] if scheme == "int8" else w[0].shape[-1]
    P, table = offsets.shape[0], offsets.tolist()
    for shift in range(table[0], table[0] + 16):
        kw = dict(shift=shift, num=147, den=160, f0=0)
        v0 = sf.origins(P + 1, R, **kw).tolist()
        if v0[:P] == table and v0[P] - v0[0] == S:
            return sf.resample_streamed(hist, x, w, n_blocks=n_blocks,
                                        scheme=scheme, scales=scales, **kw)
    raise ValueError("a probe launch off the flagship's origins")
