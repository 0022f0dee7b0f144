"""speex_resampler_tpu_torch — the resampler's batched serving path on
PyTorch and CUDA (NVIDIA Hopper).

A port of ``speex_resampler_tpu``, which stays the reference: the same
filter design, launch geometry and buffer contract, with the phase-tiled
polyphase FIR launch as a hand-written CUDA kernel
(``csrc/tiled_fir.cu``, built with nvcc at first use).  This package
imports torch and numpy, never jax.
"""

from .utils.errors import ResamplerError, ResamplerErrorCode
from .parallel.batch import BatchedResampler

__version__ = "0.1.0"

__all__ = ["BatchedResampler", "ResamplerError", "ResamplerErrorCode",
           "__version__"]
