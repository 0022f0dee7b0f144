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
  ``csrc/probes/fixed_anatomy.cu``).

Each wrapper runs its plain version for CPU tensors and launches its
kernel (built at first use into ``build/torch_kernels/libprobes.<hash>.so``)
for CUDA tensors, or raises.  ``tools/tc_probes.py`` runs them all on the
card; ``chip_smoke.py`` phase 10 checks and times one case of each.  No
module here imports jax, triton, ``experiments/`` or the JAX package.
"""

__all__ = ["tc_rate", "mxu_peak", "mxu_shape_probe", "v4_overhead_anatomy",
           "fixed_interp_anatomy"]
