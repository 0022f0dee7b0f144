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
            "assert p.SpeexResampler and p.SpeexResamplerTransform; "
            "assert p.ResamplerCore and p.strerror(3); "
            "print(sorted(m for m in ('jax', 'triton', 'speex_resampler_tpu')"
            " if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_every_port_module_and_chip_smoke_load_no_jax_or_triton():
    """Every module of the port (the single-stream layer, the CLI, the
    serving runtime with MultiFleet, the native runtime and profiling
    included) and chip_smoke.py's imports load neither jax, triton nor the
    JAX package; nothing is built at import."""
    code = (
        "import sys, pkgutil, importlib, speex_resampler_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "from speex_resampler_tpu_torch.runtime import FleetResampler\n"
        "from speex_resampler_tpu_torch import FleetResampler as F\n"
        "assert F is FleetResampler\n"
        "from speex_resampler_tpu_torch.runtime import MultiFleet\n"
        "from speex_resampler_tpu_torch.core.resampler import "
        "ResamplerCore\n"
        "from speex_resampler_tpu_torch.ops import fir_exact, fir_fixed\n"
        "from speex_resampler_tpu_torch.models import PRESETS\n"
        "from speex_resampler_tpu_torch import api, cli\n"
        "assert api.ResamplerCore is ResamplerCore and PRESETS\n"
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


def test_functional_and_port_examples_load_no_jax_or_triton():
    """The functional module (its exports too) and every port example's
    imports (each script loaded as a module, main() not run) load neither
    jax, triton nor the JAX package."""
    code = (
        "import sys, glob, runpy\n"
        "from speex_resampler_tpu_torch import make_stream_fn, "
        "resample_array\n"
        "from speex_resampler_tpu_torch.functional import StreamFn\n"
        "from speex_resampler_tpu_torch.parallel.mesh import split_lanes\n"
        "assert make_stream_fn and resample_array and StreamFn\n"
        "paths = sorted(glob.glob('examples/torch_port/*.py'))\n"
        "assert len(paths) == 7, paths\n"
        "for p in paths:\n"
        "    runpy.run_path(p, run_name='example')\n"
        "print(sorted(m for m in ('jax', 'triton', 'speex_resampler_tpu')"
        " if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
    for p in sorted((REPO / "examples" / "torch_port").glob("*.py")):
        text = p.read_text()
        assert "import jax" not in text and "speex_resampler_tpu." not in \
            text.replace("speex_resampler_tpu_torch", ""), p.name


def test_last_probe_modules_load_no_jax_or_triton():
    """The probes P9-P12 (``probes/v5_int8_bench.py``, ``v4_k_layout.py``,
    ``batched_dot.py``, ``v3_bench.py``) and the tool that runs them load
    neither jax, triton, ``experiments/`` nor the JAX package, and build
    nothing at import."""
    code = (
        "import sys, importlib\n"
        "for m in ('v5_int8_bench', 'v4_k_layout', 'batched_dot',\n"
        "          'v3_bench'):\n"
        "    importlib.import_module('speex_resampler_tpu_torch.probes.' + m)\n"
        "sys.argv = ['tc_probes.py']\n"
        "import tools.tc_probes as t\n"
        "assert {'v5', 'klayout', 'batched', 'v3step'} <= set(t.PARTS)\n"
        "import speex_resampler_tpu_torch.ops._build as b\n"
        "assert b._probe_lib is None and b._lib is None\n"
        "print(sorted(m for m in ('jax', 'triton', 'speex_resampler_tpu')"
        " if m in sys.modules or any(k.startswith('experiment')"
        " for k in sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_fuzz_and_soak_tools_load_no_jax_or_triton():
    """``tools/fuzz_torch.py`` and ``tools/soak_torch.py`` load neither
    jax, triton, ``experiments/`` nor the JAX package, and build nothing
    at import.  Neither loads ``chip_smoke.py``, which loads them in its
    phase 11: the kernel names and launch counts they share live in
    ``utils/launches.py``."""
    code = (
        "import sys\n"
        "import tools.fuzz_torch as f, tools.soak_torch as s\n"
        "assert f.CLASSES and f.campaign and s.soak and s.CONFIGS\n"
        "assert 'chip_smoke' not in sys.modules\n"
        "import speex_resampler_tpu_torch.ops._build as b\n"
        "assert b._lib is None\n"
        "print(sorted(m for m in ('jax', 'triton', 'speex_resampler_tpu')"
        " if m in sys.modules or any(k.startswith('experiment')"
        " for k in sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
    for name in ("fuzz_torch.py", "soak_torch.py"):
        text = (REPO / "tools" / name).read_text()
        assert "import jax" not in text and "speex_resampler_tpu." not in \
            text.replace("speex_resampler_tpu_torch", ""), name
