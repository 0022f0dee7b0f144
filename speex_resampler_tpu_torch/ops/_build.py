"""Build and load the port's CUDA kernels: nvcc into a shared library with a
plain C interface, loaded with ``ctypes``.

The library is compiled at first use, for ``sm_90a``, from the sources in
``csrc/`` into ``build/torch_kernels/`` at the root of the checkout.  Its
file name carries a hash of the sources and flags, so an edited kernel is
rebuilt and a stale library is never loaded.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["load", "build_dir"]

_PKG = Path(__file__).resolve().parent.parent
_SOURCES = (_PKG / "csrc" / "tiled_fir.cu",)
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None
_lock = threading.Lock()


def build_dir() -> Path:
    return _PKG.parent / "build" / "torch_kernels"


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc"
        if cand and path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _lib_path() -> Path:
    h = hashlib.sha1(" ".join(_FLAGS).encode())
    for src in _SOURCES:
        h.update(src.read_bytes())
    return build_dir() / f"libtiled_fir.{h.hexdigest()[:12]}.so"


def _compile(out: Path) -> None:
    """nvcc to a per-process temporary name, then an atomic rename, so a
    concurrent loader never opens a half-written library.  The compiler's
    report (registers, shared memory, spills from ``-Xptxas -v``) is kept
    beside the library as ``.log``."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *_FLAGS, "-o", str(tmp), *map(str, _SOURCES)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)


def load() -> ctypes.CDLL:
    """The kernels' library, compiled first if no build of these sources
    exists.  Raises if nvcc is missing or the build fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = _lib_path()
        if not path.exists():
            _compile(path)
        lib = ctypes.CDLL(str(path))
        c = ctypes
        ptr, i32, f32 = c.c_void_p, c.c_int, c.c_float
        lib.tiled_fir_row_tile.restype = i32
        lib.tiled_fir_row_tile.argtypes = []
        lib.tiled_fir_error_string.restype = c.c_char_p
        lib.tiled_fir_error_string.argtypes = [i32]
        lib.tiled_fir_f32.restype = i32
        lib.tiled_fir_f32.argtypes = [ptr] * 6 + [i32] * 8 + [ptr]
        lib.tiled_fir_int8.restype = i32
        lib.tiled_fir_int8.argtypes = ([ptr] * 7 + [i32] + [f32] * 4
                                       + [i32] * 8 + [ptr])
        _lib = lib
        return lib
