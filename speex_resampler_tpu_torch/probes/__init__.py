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
  ``csrc/probes/prec_fir.cu``).

Each wrapper runs its plain version for CPU tensors and launches its
kernel (built at first use into ``build/torch_kernels/libprobes.<hash>.so``)
for CUDA tensors, or raises.  ``tools/tc_probes.py`` runs them all on the
card; ``chip_smoke.py`` phase 10 checks and times one case of each.  No
module here imports jax, triton, ``experiments/`` or the JAX package.
"""

__all__ = ["tc_rate", "mxu_peak", "mxu_shape_probe", "v4_overhead_anatomy",
           "fixed_interp_anatomy", "v3_overhead_anatomy",
           "mosaic_int_dot_bench", "kernel_anatomy", "prec_bench"]
