"""The PyTorch port imports neither jax nor triton (it copies the JAX
package's NumPy host layers instead of importing them, and builds its CUDA
kernels with nvcc at first launch, never at import)."""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def test_import_loads_no_jax_or_triton():
    code = ("import sys, speex_resampler_tpu_torch as p; "
            "assert p.BatchedResampler and p.ResamplerError; "
            "print(sorted(m for m in ('jax', 'triton', 'speex_resampler_tpu')"
            " if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
