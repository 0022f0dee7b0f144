"""speex_resampler_tpu_torch — the resampler's batched serving path on
PyTorch and CUDA (NVIDIA Hopper).

A port of ``speex_resampler_tpu``, which stays the reference: the same
filter design, launch geometry and buffer contract, with the polyphase FIR
launches of the tiled, streamed and dense geometries as hand-written CUDA
kernels (``csrc/``, built with nvcc at first use).  ``BatchedResampler``
serves lockstep streams; ``FleetResampler`` serves streams at their own
cadence through the native C++ stager (``native/``, built with g++ at
first use).  This package imports torch and numpy, never jax.
"""

from .utils.errors import ResamplerError, ResamplerErrorCode
from .parallel.batch import BatchedResampler
from .runtime.fleet import FleetResampler

__version__ = "0.1.0"

__all__ = ["BatchedResampler", "FleetResampler", "ResamplerError",
           "ResamplerErrorCode", "__version__"]
