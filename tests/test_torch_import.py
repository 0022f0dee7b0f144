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


def test_every_port_module_and_chip_smoke_load_no_jax_or_triton():
    """Every module of the port (the serving runtime, its native stager
    and profiling included) and chip_smoke.py's imports load neither jax,
    triton nor the JAX package; nothing is built at import."""
    code = (
        "import sys, pkgutil, importlib, speex_resampler_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "from speex_resampler_tpu_torch.runtime import FleetResampler\n"
        "from speex_resampler_tpu_torch import FleetResampler as F\n"
        "assert F is FleetResampler\n"
        "import speex_resampler_tpu_torch.runtime.native as n\n"
        "import speex_resampler_tpu_torch.ops._build as b\n"
        "assert n._lib is None and b._lib is None\n"
        "sys.argv = ['chip_smoke.py']\n"
        "import chip_smoke\n"
        "print(sorted(m for m in ('jax', 'triton', 'speex_resampler_tpu')"
        " if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
    text = (REPO / "chip_smoke.py").read_text()
    assert "import jax" not in text and "speex_resampler_tpu." not in text
