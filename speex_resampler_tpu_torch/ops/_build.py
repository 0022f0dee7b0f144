"""Build and load the port's CUDA kernels: nvcc into a shared library with a
plain C interface, loaded with ``ctypes``.

The library is compiled at first use, for ``sm_90a``, from the sources in
``csrc/`` into ``build/torch_kernels/`` at the root of the checkout: one
nvcc per source, all started together, then one link.  Its file name
carries a hash of the sources, headers and flags, so an edited kernel is
rebuilt and a stale library is never loaded.  Nothing here runs at import.

A second library, ``libprobes.<hash>.so``, holds the tensor-core probe
kernels (``csrc/probes/``, driven by ``speex_resampler_tpu_torch.probes``):
built the same way at the first probe launch (:func:`load_probes`), its
hash over its sources and every header they include, its compiler reports
in ``build/torch_kernels/probes/``.  Its nvcc runs and libfir's may run at
the same time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

__all__ = ["load", "build_dir", "lib_path", "compile_library", "declare",
           "use_csrc", "stream_handle", "load_probes", "probe_lib_path"]

_PKG = Path(__file__).resolve().parent.parent
_SOURCE_NAMES = ("tiled_fir.cu", "streamed_fir.cu", "dense_fir.cu")
_HEADER_NAMES = ("fir_common.cuh", "split5_wgmma.cuh", "f32_fir.cuh",
                 "int8_wgmma.cuh", "fixed_wgmma.cuh")
_CSRC = _PKG / "csrc"
_SOURCES = tuple(_CSRC / name for name in _SOURCE_NAMES)
_HEADERS = tuple(_CSRC / name for name in _HEADER_NAMES)
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: C function -> (restype, argtypes)
_SIGNATURES = {
    "tiled_fir_row_tile": (_I, []),
    "f32_fir_sub_rows": (_I, []),
    "fixed_fir_rows": (_I, [_I]),
    "tiled_fir_error_string": (ctypes.c_char_p, [_I]),
    "tiled_fir_f32": (_I, [_P] * 6 + [_I] * 8 + [_P]),
    "tiled_fir_int8": (_I, [_P] * 7 + [_I] + [_F] * 4 + [_I] * 9 + [_P]),
    "tiled_fir_int8_max_slices": (_I, [_I]),
    "tiled_fir_fixed": (_I, [_P] * 8 + [_I] * 9 + [_P]),
    "tiled_fir_split5": (_I, [_P] * 6 + [_I] * 8 + [_P]),
    "streamed_fir_row_tile": (_I, []),
    "streamed_fir_error_string": (ctypes.c_char_p, [_I]),
    "streamed_fir_f32": (_I, [_P] * 5 + [_I] * 11 + [_P]),
    "streamed_fir_int8": (_I, [_P] * 6 + [_I] + [_F] * 4 + [_I] * 11 + [_P]),
    "streamed_fir_fixed": (_I, [_P] * 7 + [_I] * 12 + [_P]),
    "streamed_fir_split5": (_I, [_P] * 5 + [_I] * 11 + [_P]),
    "dense_fir_row_tile": (_I, []),
    "dense_fir_error_string": (ctypes.c_char_p, [_I]),
    "dense_fir_f32": (_I, [_P] * 5 + [_I] * 8 + [_P]),
}

_lib = None
_lock = threading.Lock()

# the probe library: its sources (under _CSRC) include the production headers,
# most through probes/probe_common.cuh
_PROBE_SOURCE_NAMES = ("probes/tc_rate.cu", "probes/int8_anatomy.cu",
                       "probes/fixed_anatomy.cu", "probes/v3_anatomy.cu",
                       "probes/f32_anatomy.cu", "probes/prec_fir.cu",
                       "probes/v5_bench.cu", "probes/batched_dot.cu")
_PROBE_HEADER_NAMES = ("probes/probe_common.cuh",
                       "probes/f32_anatomy.cuh") + _HEADER_NAMES
_PROBE_CSRC = _CSRC
_PROBE_SIGNATURES = {
    "probe_error_string": (ctypes.c_char_p, [_I]),
    "probe_tc_rate_smem": (_I, [_I] * 6),
    "probe_tc_rate_fill": (_I, [_I] * 9),
    "probe_tc_rate": (_I, [_P] * 5 + [_I] * 13 + [_P]),
    "probe_int8_anatomy_smem": (_I, [_I] * 4),
    "probe_int8_anatomy_fill": (_I, [_I] * 6),
    "probe_int8_anatomy": (_I, [_P] * 5 + [_I] * 9 + [_P]),
    "probe_fixed_anatomy_smem": (_I, [_I] * 2),
    "probe_fixed_anatomy_rows": (_I, []),
    "probe_fixed_anatomy_fill": (_I, [_I] * 4),
    "probe_fixed_anatomy": (_I, [_P] * 6 + [_I] * 7 + [_P]),
    "probe_v3_anatomy_smem": (_I, [_I] * 3),
    "probe_v3_split": (_I, [_P] * 3 + [_I] * 4 + [_P]),
    "probe_v3_anatomy": (_I, [_P] * 8 + [_I] + [_F] * 3 + [_I] * 9 + [_P]),
    "probe_f32_anatomy_smem": (_I, [_I]),
    "probe_f32_anatomy": (_I, [_P] * 5 + [_I] * 8 + [_P]),
    "probe_prec_fir_smem": (_I, [_I]),
    "probe_prec_fir": (_I, [_P] * 4 + [_I] * 8 + [_P]),
    "probe_v5_bench": (_I, [_P] * 6 + [_I] + [_F] * 3 + [_I] * 8 + [_P]),
    "probe_batched_patches": (_I, [_P] * 4 + [_I] * 7 + [_P]),
    "probe_batched_dot": (_I, [_P] * 7 + [_I] * 10 + [_P]),
}
_probe_lib = None
_probe_lock = threading.Lock()


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


def _hashed_path(stem: str, files) -> Path:
    h = hashlib.sha1(" ".join(_FLAGS).encode())
    for src in files:
        h.update(src.read_bytes())
    return build_dir() / f"{stem}.{h.hexdigest()[:12]}.so"


def lib_path() -> Path:
    """The library this checkout's sources and flags build."""
    return _hashed_path("libfir", (*_HEADERS, *_SOURCES))


def compile_library(out: Path, sources=None, csrc=None,
                    log_dir=None) -> None:
    """One nvcc per source (``sources``, by default libfir's, with ``-I
    csrc``), all started together, to per-process object files; then one
    link to a temporary name and an atomic rename, so a concurrent loader
    never opens a half-written library.  Each source's compiler report
    (registers, shared memory, spills from ``-Xptxas -v``) is kept as
    ``<source>.log`` in ``log_dir`` (the build directory by default).
    Raises if a build fails, after every started nvcc has ended."""
    sources = _SOURCES if sources is None else sources
    csrc = _CSRC if csrc is None else csrc
    log_dir = out.parent if log_dir is None else log_dir
    out.parent.mkdir(parents=True, exist_ok=True)
    log_dir.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{out.stem}.{os.getpid()}"
    jobs = []
    for src in sources:
        obj = out.with_name(f"{src.stem}.{tag}.o")
        cmd = [nvcc, *_FLAGS, "-I", str(csrc), "-c", "-o", str(obj),
               str(src)]
        jobs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for src, _, proc in jobs:
        report, _ = proc.communicate()
        (log_dir / f"{src.stem}.log").write_text(report)
        if proc.returncode != 0:
            failed.append(f"{src.name}: nvcc exit {proc.returncode}\n{report}")
    objs = [obj for _, obj, _ in jobs]
    try:
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        res = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                              *map(str, objs)], capture_output=True,
                             text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, out)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)


def load() -> ctypes.CDLL:
    """The kernels' library, compiled first if no build of these sources
    exists.  Raises if nvcc is missing or the build fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = lib_path()
        if not path.exists():
            compile_library(path)
        _lib = declare(ctypes.CDLL(str(path)))
        return _lib


def declare(lib: ctypes.CDLL, names=None, signatures=None) -> ctypes.CDLL:
    """Sets the C signatures of ``lib``'s entry points ``names`` (all of
    this library's, or of ``signatures``, by default); returns ``lib``."""
    signatures = _SIGNATURES if signatures is None else signatures
    for fn in names or signatures:
        restype, argtypes = signatures[fn]
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    return lib


def use_csrc(csrc: Path) -> None:
    """Builds and loads from another ``csrc/`` directory from now on: a
    copy of this one with edited kernels, or an earlier checkout's (whose
    headers may be fewer).  The next :func:`load` compiles it."""
    global _CSRC, _SOURCES, _HEADERS, _lib
    csrc = Path(csrc).resolve()
    with _lock:
        _CSRC = csrc
        _SOURCES = tuple(csrc / name for name in _SOURCE_NAMES)
        _HEADERS = tuple(csrc / name for name in _HEADER_NAMES
                         if (csrc / name).exists())
        _lib = None


def _probe_files():
    return (tuple(_PROBE_CSRC / name for name in _PROBE_SOURCE_NAMES),
            tuple(_PROBE_CSRC / name for name in _PROBE_HEADER_NAMES))


def probe_log_dir() -> Path:
    """Where the probe sources' compiler reports go."""
    return build_dir() / "probes"


def probe_lib_path() -> Path:
    """The probe library this checkout's sources, headers and flags build."""
    sources, headers = _probe_files()
    return _hashed_path("libprobes", (*headers, *sources))


def load_probes() -> ctypes.CDLL:
    """The probe kernels' library, compiled first if no build of these
    sources exists.  Raises if nvcc is missing or the build fails (each
    call tries again: no failure is cached)."""
    global _probe_lib
    with _probe_lock:
        if _probe_lib is not None:
            return _probe_lib
        path = probe_lib_path()
        if not path.exists():
            compile_library(path, _probe_files()[0], _PROBE_CSRC,
                            probe_log_dir())
        _probe_lib = declare(ctypes.CDLL(str(path)),
                             signatures=_PROBE_SIGNATURES)
        return _probe_lib


def stream_handle(device: torch.device) -> int:
    """The raw handle of ``device``'s current CUDA stream (the capture
    stream while a CUDA graph is captured), for a launch through the C
    interface.  It reads the handle without building a
    ``torch.cuda.Stream``, which costs ~8 us of host time a call (PERF.md,
    ``tools/dense_ablate.py``)."""
    return torch._C._cuda_getCurrentRawStream(device.index)
