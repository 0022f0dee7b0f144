"""The benchmark of ``speex_resampler_tpu_torch``, the PyTorch and CUDA
port: one command runs one cell once (``run.py``).  Cells, configurations,
traffic mixes, the entries that mixes drive, the plain references that
configurations name and the per-layer metrics' readers are found by name
from ``BENCHMARK.json`` at the root of the checkout (``manifest.py``)."""
