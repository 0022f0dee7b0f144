"""speex_resampler_tpu_torch — the resampler on PyTorch and CUDA (NVIDIA
Hopper).

A port of ``speex_resampler_tpu``, which stays the reference: the same
filter design, launch geometry, buffer contract and checkpoint formats,
with the polyphase FIR launches of the tiled, streamed and dense
geometries as hand-written CUDA kernels (``csrc/``, built with nvcc at
first use).  ``SpeexResampler`` / ``SpeexResamplerTransform`` are the
reference's single-stream API over ``ResamplerCore``;
``BatchedResampler`` serves lockstep streams; ``FleetResampler`` serves
streams at their own cadence through the native C++ runtime (``native/``,
built with g++ at first use), and ``runtime.MultiFleet`` serves streams of
many configs, one fleet a config.  ``functional.make_stream_fn`` gives the
pure step under the engines, for the caller's own torch graph (capturable
in one CUDA graph), and ``resample_array`` resamples a whole array in one
call; ``mesh=`` splits an engine's or a step's lanes over several devices.
This package imports torch and numpy, never jax.
"""

from .api import SpeexResampler, SpeexResamplerTransform
from .utils.errors import (ResamplerError, ResamplerErrorCode, strerror,
                           QUALITY_MAX, QUALITY_MIN, QUALITY_DEFAULT,
                           QUALITY_VOIP, QUALITY_DESKTOP)
from .core.resampler import ResamplerCore
from .parallel.batch import BatchedResampler
from .runtime.fleet import FleetResampler
from .functional import make_stream_fn, resample_array

__version__ = "0.1.0"

__all__ = [
    "SpeexResampler", "SpeexResamplerTransform", "ResamplerCore",
    "BatchedResampler", "FleetResampler", "make_stream_fn", "resample_array",
    "ResamplerError", "ResamplerErrorCode", "strerror",
    "QUALITY_MAX", "QUALITY_MIN", "QUALITY_DEFAULT", "QUALITY_VOIP",
    "QUALITY_DESKTOP", "__version__",
]
