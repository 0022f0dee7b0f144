"""ctypes bindings for the native host runtime
(``speex_resampler_tpu_torch/native/speex_tpu_runtime.cpp``, a byte-identical
copy of the JAX package's source, so the port imports nothing of that
package): the fleet's stager and the single-stream FIR hot loops.

The shared library is compiled at first use with g++ into
``build/torch_runtime/`` at the root of the checkout (per-pid temporary
name, then an atomic rename: concurrent importers such as pytest-xdist
workers never open a half-written library).  When the compiler is missing
or fails, ``make_stager`` falls back to ``PyStager``, the NumPy
implementation of the same interface and the stager's plain version, and
the FIR twins return None so their callers (``ops/fir_exact``,
``ops/fir_fixed``) run their NumPy loops, which give the same bits; each
fallback logs a warning.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from pathlib import Path

import numpy as np

from ..utils.errors import ResamplerError, ResamplerErrorCode

__all__ = ["load_runtime", "NativeStager", "PyStager", "make_stager",
           "fir_q15_direct", "fir_q15_interp", "fir_f32_direct",
           "fir_f32_interp"]

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "native" / "speex_tpu_runtime.cpp"
_log = logging.getLogger(__name__)


def _host_tag() -> str:
    """Key of the executing CPU.  The library is built -march=native, so
    one built on another machine (a shared home directory, an image built
    on a newer host) may die of an illegal instruction here; the machine
    arch and the CPU feature flags go into the file name, so a different
    CPU rebuilds (~1 s) instead."""
    import hashlib
    import platform
    ident = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    ident += " " + " ".join(sorted(line.split()[2:]))
                    break
    except OSError:
        ident += " " + platform.processor()
    return hashlib.sha1(ident.encode()).hexdigest()[:12]


def _lib_path() -> Path:
    """``build/torch_runtime/`` of the checkout.  The file name carries the
    host-CPU tag (see _host_tag) and a hash of the source, so an edited
    source is rebuilt whatever the files' times; it differs from the JAX
    package's library name."""
    import hashlib
    src = hashlib.sha1(_SRC.read_bytes()).hexdigest()[:12]
    return (_PKG.parent / "build" / "torch_runtime"
            / f"libspeex_torch_runtime.{_host_tag()}.{src}.so")


_LIB = _lib_path()

_lib = None
_lib_failed = False


def load_runtime():
    """Build (if stale) and load the native runtime; None if unavailable
    (no compiler, a failed build or an unwritable build directory)."""
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    try:
        _LIB.parent.mkdir(parents=True, exist_ok=True)
        if not _LIB.exists():
            # build to a per-pid temp name + atomic rename: concurrent
            # importers (pytest-xdist workers) must never CDLL a
            # half-written .so.  -march=native is safe (the .so is built
            # on the host that runs it; measured +35% on the scatter
            # transpose) but some toolchains reject it — retry plain.
            tmp = _LIB.with_suffix(f".so.{os.getpid()}.tmp")
            # -fwrapv: the Q15 hot loops accumulate in int32 with
            # two's-complement wraparound (the reference semantics) —
            # make signed overflow defined instead of UB.
            # -ffp-contract=off: the float hot loops' accumulation order
            # is a bit-exactness contract; FMA contraction would change
            # rounding (the reference oracle is built without FMA).
            base = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                    "-fwrapv", "-ffp-contract=off",
                    "-pthread", "-o", str(tmp), str(_SRC)]
            try:
                subprocess.run(base[:2] + ["-march=native"] + base[2:],
                               check=True, capture_output=True)
            except subprocess.CalledProcessError:
                subprocess.run(base, check=True, capture_output=True)
            os.replace(tmp, _LIB)
        lib = ctypes.CDLL(str(_LIB))
    except (OSError, subprocess.CalledProcessError):
        _lib_failed = True
        return None

    c = ctypes
    lib.srt_create.restype = c.c_void_p
    lib.srt_create.argtypes = [c.c_int, c.c_int, c.c_long]
    lib.srt_destroy.argtypes = [c.c_void_p]
    lib.srt_push.restype = c.c_int
    lib.srt_push.argtypes = [c.c_void_p, c.c_int, c.c_void_p, c.c_long]
    lib.srt_push_bytes.restype = c.c_long
    lib.srt_push_bytes.argtypes = [c.c_void_p, c.c_int, c.c_void_p, c.c_long]
    lib.srt_staged.argtypes = [c.c_void_p, c.c_void_p]
    lib.srt_staged_one.restype = c.c_long
    lib.srt_staged_one.argtypes = [c.c_void_p, c.c_int]
    lib.srt_set_active.restype = c.c_int
    lib.srt_set_active.argtypes = [c.c_void_p, c.c_int, c.c_int]
    lib.srt_set_threads.restype = c.c_int
    lib.srt_set_threads.argtypes = [c.c_void_p, c.c_int]
    lib.srt_ready_launches.restype = c.c_long
    lib.srt_ready_launches.argtypes = [c.c_void_p]
    lib.srt_fill_launch.restype = c.c_int
    lib.srt_fill_launch.argtypes = [c.c_void_p, c.c_void_p]
    lib.srt_fill_flush.restype = c.c_long
    lib.srt_fill_flush.argtypes = [c.c_void_p, c.c_void_p, c.c_void_p]
    lib.srt_peek.restype = c.c_int
    lib.srt_peek.argtypes = [c.c_void_p, c.c_int, c.c_void_p]
    lib.srt_carry_size.restype = c.c_long
    lib.srt_carry_size.argtypes = [c.c_void_p, c.c_int]
    lib.srt_get_carry.restype = c.c_int
    lib.srt_get_carry.argtypes = [c.c_void_p, c.c_int, c.c_void_p]
    lib.srt_unpack.restype = c.c_int
    lib.srt_unpack.argtypes = [c.c_void_p, c.c_void_p, c.c_long, c.c_int,
                               c.c_void_p]
    lib.srt_unpack_all.argtypes = [c.c_void_p, c.c_void_p, c.c_long,
                                   c.c_void_p]
    lib.srt_fill_launch_lm.restype = c.c_int
    lib.srt_fill_launch_lm.argtypes = [c.c_void_p, c.c_void_p, c.c_long]
    lib.srt_unpack_all_lm.argtypes = [c.c_void_p, c.c_void_p, c.c_long,
                                      c.c_void_p]
    lib.srt_fir_q15_direct.argtypes = [
        c.c_void_p, c.c_long, c.c_long, c.c_void_p, c.c_long,
        c.c_void_p, c.c_void_p, c.c_long, c.c_void_p]
    lib.srt_fir_q15_interp.argtypes = [
        c.c_void_p, c.c_long, c.c_long, c.c_void_p, c.c_void_p, c.c_long,
        c.c_void_p, c.c_void_p, c.c_long, c.c_void_p]
    lib.srt_fir_f32_direct.argtypes = [
        c.c_void_p, c.c_long, c.c_long, c.c_void_p, c.c_long,
        c.c_void_p, c.c_void_p, c.c_long, c.c_int, c.c_long, c.c_long,
        c.c_void_p]
    lib.srt_fir_f32_interp.argtypes = [
        c.c_void_p, c.c_long, c.c_long, c.c_void_p, c.c_long, c.c_long,
        c.c_long, c.c_void_p, c.c_void_p, c.c_long, c.c_int, c.c_void_p]
    for f in (lib.srt_fir_q15_direct, lib.srt_fir_q15_interp,
              lib.srt_fir_f32_direct, lib.srt_fir_f32_interp):
        f.restype = None
    _lib = lib
    return _lib


# ---------------------------------------------------------------------------
# Single-stream FIR hot loops (native twins of ops/fir_fixed.py /
# ops/fir_exact.py — those modules remain the semantics references and
# call these when the library is available).  All return None if the
# native runtime could not be built, so callers fall back to NumPy.
# ---------------------------------------------------------------------------

_fir_warned = False


def _fir_lib():
    """The loaded runtime, or None after one logged warning."""
    global _fir_warned
    lib = load_runtime()
    if lib is None and not _fir_warned:
        _fir_warned = True
        _log.warning("native FIR loops unavailable (g++ build of %s "
                     "failed); the host route runs the NumPy loops", _SRC)
    return lib


def _c16(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int16)


def _c64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int64)


def _fir_args(x: np.ndarray, starts: np.ndarray,
              phases: np.ndarray) -> tuple:
    """Checked (starts, phases, B, T, m): the loops index x by them."""
    starts, phases = _c64(starts), _c64(phases)
    if x.ndim != 2 or starts.shape != phases.shape or starts.ndim != 1:
        _invalid(f"x {x.shape}, starts {starts.shape}, phases "
                 f"{phases.shape}")
    return starts, phases, x.shape[0], x.shape[1], starts.shape[0]


def fir_q15_direct(x: np.ndarray, taps: np.ndarray, starts: np.ndarray,
                   phases: np.ndarray) -> np.ndarray | None:
    """x int16 [B, T]; taps int16 [rows, N]; -> int16 [B, m] or None."""
    lib = _fir_lib()
    if lib is None:
        return None
    x, taps = _c16(x), _c16(taps)
    starts, phases, B, T, m = _fir_args(x, starts, phases)
    out = np.empty((B, m), dtype=np.int16)
    lib.srt_fir_q15_direct(_ptr(x), B, T, _ptr(taps), taps.shape[1],
                           _ptr(starts), _ptr(phases), m, _ptr(out))
    return out


def fir_q15_interp(x: np.ndarray, taps4: np.ndarray, coef4: np.ndarray,
                   starts: np.ndarray, phases: np.ndarray
                   ) -> np.ndarray | None:
    """x int16 [B, T]; taps4 int16 [rows, 4, N]; coef4 int16 [rows, 4]."""
    lib = _fir_lib()
    if lib is None:
        return None
    x, taps4, coef4 = _c16(x), _c16(taps4), _c16(coef4)
    starts, phases, B, T, m = _fir_args(x, starts, phases)
    out = np.empty((B, m), dtype=np.int16)
    lib.srt_fir_q15_interp(_ptr(x), B, T, _ptr(taps4), _ptr(coef4),
                           taps4.shape[2], _ptr(starts), _ptr(phases), m,
                           _ptr(out))
    return out


def fir_f32_direct(x: np.ndarray, taps: np.ndarray, starts: np.ndarray,
                   phases: np.ndarray, double: bool, *, num: int = 0,
                   den: int = 0) -> np.ndarray | None:
    """x f32 [B, T]; taps f32 [rows, N]; -> raw f32 sums [B, m] or None.
    Pass num/den when starts/phases follow the canonical recurrence
    (phases[k] = (f0+k*num) mod den) to enable the phase-grouped
    output-vectorized path (bit-identical; each output keeps its serial
    j-order)."""
    lib = _fir_lib()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, dtype=np.float32)
    taps = np.ascontiguousarray(taps, dtype=np.float32)
    starts, phases, B, T, m = _fir_args(x, starts, phases)
    out = np.empty((B, m), dtype=np.float32)
    lib.srt_fir_f32_direct(_ptr(x), B, T, _ptr(taps), taps.shape[1],
                           _ptr(starts), _ptr(phases), m, int(double),
                           int(num), int(den), _ptr(out))
    return out


def fir_f32_interp(x: np.ndarray, sinc: np.ndarray, ov: int, den: int,
                   N: int, starts: np.ndarray, phases: np.ndarray,
                   double: bool) -> np.ndarray | None:
    """x f32 [B, T]; sinc = raw interp-layout table (ov*N+8 entries,
    offset 4); -> raw f32 sums [B, m] or None.  The caller must ensure
    every tap index is in-bounds (offset <= ov + 2; see fir_exact)."""
    lib = _fir_lib()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, dtype=np.float32)
    sinc = np.ascontiguousarray(sinc, dtype=np.float32)
    starts, phases, B, T, m = _fir_args(x, starts, phases)
    out = np.empty((B, m), dtype=np.float32)
    lib.srt_fir_f32_interp(_ptr(x), B, T, _ptr(sinc), ov, den, N,
                           _ptr(starts), _ptr(phases), m, int(double),
                           _ptr(out))
    return out


def _invalid(msg: str):
    """Boundary-guard failure in the package error taxonomy: callers that
    contain failures by catching ResamplerError (the package-wide
    input-validation contract) must also catch a mis-shaped push/slab
    surfacing from a stager.  The descriptive message rides the chained
    cause so debuggability is not lost."""
    raise ResamplerError(ResamplerErrorCode.INVALID_ARG) from ValueError(msg)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


class NativeStager:
    """Fleet staging buffer: ragged per-stream pushes -> time-major launch
    slabs [n_in, B] (lane = stream*channels + channel)."""

    def __init__(self, n_streams: int, channels: int, n_in_per_launch: int):
        lib = load_runtime()
        if lib is None:
            raise RuntimeError("native runtime unavailable")
        self._lib = lib
        self.n_streams = n_streams
        self.channels = channels
        self.n_in = n_in_per_launch
        self.B = n_streams * channels
        self._h = lib.srt_create(n_streams, channels, n_in_per_launch)
        if not self._h:
            raise MemoryError("srt_create failed")

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.srt_destroy(h)
            self._h = None

    def push(self, stream: int, frames: np.ndarray) -> None:
        """frames: int16 [n, C] interleaved."""
        f = np.ascontiguousarray(frames, dtype=np.int16)
        # explicit raise, not assert: these guard raw ctypes pointer
        # calls, and `python -O` strips asserts (an accepted bad shape
        # would be an out-of-bounds memcpy in the C scatter/gather)
        if f.ndim != 2 or f.shape[1] != self.channels:
            _invalid(
                f"frames must be [n, {self.channels}] int16, got {f.shape}")
        rc = self._lib.srt_push(self._h, stream, _ptr(f), f.shape[0])
        if rc != 0:
            _invalid(f"srt_push failed for stream {stream}")

    def push_bytes(self, stream: int, data: bytes) -> int:
        """Raw bytes with frame-alignment carry; returns frames accepted."""
        buf = np.frombuffer(data, dtype=np.uint8)
        buf = np.ascontiguousarray(buf)
        n = self._lib.srt_push_bytes(self._h, stream, _ptr(buf), len(data))
        if n < 0:
            _invalid(f"srt_push_bytes failed for stream {stream}")
        return int(n)

    def set_active(self, stream: int, active: bool) -> None:
        """Inactive slots are excluded from lockstep readiness and
        zero-filled in launch slabs (dynamic fleet occupancy)."""
        if self._lib.srt_set_active(self._h, stream, int(active)) != 0:
            _invalid(f"bad stream {stream}")

    def set_threads(self, n: int) -> int:
        """Resize the gather/scatter thread pool (default: hardware
        concurrency); returns the effective size."""
        r = int(self._lib.srt_set_threads(self._h, int(n)))
        if r < 0:
            _invalid(f"bad thread count {n}")
        return r

    def staged(self) -> np.ndarray:
        out = np.zeros(self.n_streams, dtype=np.int64)
        self._lib.srt_staged(self._h, _ptr(out))
        return out

    def staged_one(self, stream: int) -> int:
        """Staged frames for ONE stream, O(1) (per-push backpressure)."""
        n = int(self._lib.srt_staged_one(self._h, stream))
        if n < 0:
            _invalid(f"bad stream {stream}")
        return n

    def ready_launches(self) -> int:
        return int(self._lib.srt_ready_launches(self._h))

    def fill_launch(self, out: np.ndarray | None = None) -> np.ndarray:
        """Gather one launch quantum; writes into ``out[:n_in]`` when given
        (must be C-contiguous int16 with at least n_in rows of width B)."""
        if out is None:
            slab = np.empty((self.n_in, self.B), dtype=np.int16)
        else:
            if not (out.dtype == np.int16 and out.flags["C_CONTIGUOUS"]
                    and out.ndim == 2 and out.shape[0] >= self.n_in
                    and out.shape[1] == self.B):
                _invalid(
                    f"out must be C-contiguous int16 [>= {self.n_in}, "
                    f"{self.B}], got {out.dtype} {out.shape}")
            slab = out
        rc = self._lib.srt_fill_launch(self._h, _ptr(slab))
        if rc != 0:
            _invalid("not enough staged frames for a launch")
        return slab

    def fill_launch_lm(self, out: np.ndarray) -> np.ndarray:
        """Lane-major gather: writes ``out[:, :n_in]`` where ``out`` is a
        C-contiguous int16 [B, stride] slab (stride >= n_in; the zero tail
        beyond n_in is never touched).  Per-stream deinterleave into
        contiguous rows — the cache-friendly twin of ``fill_launch`` (the
        time-major transpose instead rides the device inside the jitted
        step)."""
        if not (out.dtype == np.int16 and out.flags["C_CONTIGUOUS"]
                and out.ndim == 2 and out.shape[0] == self.B
                and out.shape[1] >= self.n_in):
            _invalid(
                f"out must be C-contiguous int16 [{self.B}, >= "
                f"{self.n_in}], got {out.dtype} {out.shape}")
        rc = self._lib.srt_fill_launch_lm(self._h, _ptr(out), out.shape[1])
        if rc != 0:
            _invalid("not enough staged frames for a launch")
        return out

    def unpack_all_lm(self, y: np.ndarray,
                      out: np.ndarray | None = None) -> np.ndarray:
        """y: lane-major int16 [B, n_out] -> [S, n_out, C] (contiguous
        per-stream zip; pass ``out`` to reuse the destination buffer)."""
        y = np.ascontiguousarray(y, dtype=np.int16)
        if y.ndim != 2 or y.shape[0] != self.B:
            _invalid(f"slab lane axis {y.shape} != B={self.B}")
        n_out = y.shape[1]
        dst = out if out is not None else np.empty(
            (self.n_streams, n_out, self.channels), dtype=np.int16)
        if not (dst.shape == (self.n_streams, n_out, self.channels)
                and dst.dtype == np.int16 and dst.flags["C_CONTIGUOUS"]):
            _invalid(
                f"out must be C-contiguous int16 [{self.n_streams}, "
                f"{n_out}, {self.channels}], got {dst.dtype} {dst.shape}")
        self._lib.srt_unpack_all_lm(self._h, _ptr(y), n_out, _ptr(dst))
        return dst

    def fill_flush(self) -> tuple[np.ndarray | None, np.ndarray]:
        """(zero-padded slab or None, pre-drain staged frames per stream)."""
        slab = np.empty((self.n_in, self.B), dtype=np.int16)
        staged = np.zeros(self.n_streams, dtype=np.int64)
        mx = self._lib.srt_fill_flush(self._h, _ptr(slab), _ptr(staged))
        if mx == 0:
            return None, staged
        return slab, staged

    def peek(self, stream: int) -> np.ndarray:
        """Staged frames for one stream (not consumed): int16 [n, C]."""
        n = int(self.staged()[stream])
        dst = np.empty((n, self.channels), dtype=np.int16)
        if self._lib.srt_peek(self._h, stream, _ptr(dst)) != 0:
            _invalid(f"bad stream {stream}")
        return dst

    def carry(self, stream: int) -> bytes:
        n = self.carry_size(stream)
        if not n:
            return b""
        dst = np.empty(n, dtype=np.uint8)
        self._lib.srt_get_carry(self._h, stream, _ptr(dst))
        return dst.tobytes()

    def carry_size(self, stream: int) -> int:
        """Pending alignment-carry bytes, O(1) (per-push backpressure
        math — ``carry()`` materializes the bytes and allocates)."""
        n = int(self._lib.srt_carry_size(self._h, stream))
        if n < 0:
            _invalid(f"bad stream {stream}")
        return n

    def unpack_all(self, y: np.ndarray) -> np.ndarray:
        """y: int16 [n_out, B] -> [S, n_out, C]."""
        y = np.ascontiguousarray(y, dtype=np.int16)
        if y.ndim != 2 or y.shape[1] != self.B:  # C walks y with stride B
            _invalid(f"slab lane axis {y.shape} != B={self.B}")
        n_out = y.shape[0]
        dst = np.empty((self.n_streams, n_out, self.channels), dtype=np.int16)
        self._lib.srt_unpack_all(self._h, _ptr(y), n_out, _ptr(dst))
        return dst

    def unpack(self, y: np.ndarray, stream: int) -> np.ndarray:
        y = np.ascontiguousarray(y, dtype=np.int16)
        if y.ndim != 2 or y.shape[1] != self.B:
            _invalid(f"slab lane axis {y.shape} != B={self.B}")
        n_out = y.shape[0]
        dst = np.empty((n_out, self.channels), dtype=np.int16)
        if self._lib.srt_unpack(self._h, _ptr(y), n_out, stream,
                                _ptr(dst)) != 0:
            _invalid(f"bad stream {stream}")
        return dst


class PyStager:
    """NumPy reference implementation of the NativeStager interface."""

    def __init__(self, n_streams: int, channels: int, n_in_per_launch: int):
        self.n_streams = n_streams
        self.channels = channels
        self.n_in = n_in_per_launch
        self.B = n_streams * channels
        self._bufs = [np.zeros((0, channels), dtype=np.int16)
                      for _ in range(n_streams)]
        self._carry = [b""] * n_streams
        self._active = [True] * n_streams

    def push(self, stream: int, frames: np.ndarray) -> None:
        f = np.ascontiguousarray(frames, dtype=np.int16)
        if f.ndim != 2 or f.shape[1] != self.channels:
            _invalid(
                f"frames must be [n, {self.channels}] int16, got {f.shape}")
        self._bufs[stream] = np.concatenate([self._bufs[stream], f])

    def push_bytes(self, stream: int, data: bytes) -> int:
        data = self._carry[stream] + data
        self._carry[stream] = b""
        fb = self.channels * 2
        extra = len(data) % fb
        if extra:
            self._carry[stream] = data[len(data) - extra:]
            data = data[:len(data) - extra]
        frames = np.frombuffer(data, dtype="<i2").reshape(-1, self.channels)
        self.push(stream, frames)
        return frames.shape[0]

    def set_active(self, stream: int, active: bool) -> None:
        self._active[stream] = bool(active)
        if not active:
            self._bufs[stream] = np.zeros((0, self.channels), dtype=np.int16)
            self._carry[stream] = b""

    def set_threads(self, n: int) -> int:
        return 1  # NumPy fallback is single-threaded

    def staged(self) -> np.ndarray:
        return np.array([b.shape[0] for b in self._bufs], dtype=np.int64)

    def staged_one(self, stream: int) -> int:
        return int(self._bufs[stream].shape[0])

    def ready_launches(self) -> int:
        act = [b.shape[0] for b, a in zip(self._bufs, self._active) if a]
        if not act:
            return 0
        return int(min(act)) // self.n_in

    def fill_launch(self, out: np.ndarray | None = None) -> np.ndarray:
        if self.ready_launches() < 1:
            _invalid("not enough staged frames for a launch")
        slab = out if out is not None else np.zeros(
            (self.n_in, self.B), dtype=np.int16)
        if out is not None:
            slab[:self.n_in] = 0
        for s in range(self.n_streams):
            if not self._active[s]:
                continue
            slab[:, s * self.channels:(s + 1) * self.channels] = \
                self._bufs[s][:self.n_in]
            self._bufs[s] = self._bufs[s][self.n_in:]
        return slab

    def fill_launch_lm(self, out: np.ndarray) -> np.ndarray:
        if self.ready_launches() < 1:
            _invalid("not enough staged frames for a launch")
        c = self.channels
        for s in range(self.n_streams):
            if not self._active[s]:
                out[s * c:(s + 1) * c, :self.n_in] = 0
                continue
            out[s * c:(s + 1) * c, :self.n_in] = self._bufs[s][:self.n_in].T
            self._bufs[s] = self._bufs[s][self.n_in:]
        return out

    def unpack_all_lm(self, y: np.ndarray,
                      out: np.ndarray | None = None) -> np.ndarray:
        n_out = y.shape[1]
        r = np.ascontiguousarray(
            y.reshape(self.n_streams, self.channels, n_out).transpose(
                0, 2, 1))
        if out is not None:
            out[...] = r
            return out
        return r

    def fill_flush(self) -> tuple[np.ndarray | None, np.ndarray]:
        staged = np.minimum(self.staged(), self.n_in)
        staged[~np.array(self._active)] = 0
        if staged.max() == 0:
            return None, staged
        slab = np.zeros((self.n_in, self.B), dtype=np.int16)
        for s in range(self.n_streams):
            f = int(staged[s])
            slab[:f, s * self.channels:(s + 1) * self.channels] = \
                self._bufs[s][:f]
            self._bufs[s] = self._bufs[s][f:]
        return slab, staged

    def peek(self, stream: int) -> np.ndarray:
        return self._bufs[stream].copy()

    def carry(self, stream: int) -> bytes:
        return self._carry[stream]

    def carry_size(self, stream: int) -> int:
        return len(self._carry[stream])

    def unpack_all(self, y: np.ndarray) -> np.ndarray:
        n_out = y.shape[0]
        return np.ascontiguousarray(
            y.reshape(n_out, self.n_streams, self.channels).transpose(
                1, 0, 2))

    def unpack(self, y: np.ndarray, stream: int) -> np.ndarray:
        c = self.channels
        return np.ascontiguousarray(y[:, stream * c:(stream + 1) * c])


def make_stager(n_streams: int, channels: int, n_in_per_launch: int):
    """Native stager when buildable, NumPy fallback otherwise (logged as a
    warning: the fallback is correct but slower)."""
    if load_runtime() is not None:
        return NativeStager(n_streams, channels, n_in_per_launch)
    _log.warning("native stager unavailable (g++ build of %s failed); "
                 "staging with the NumPy PyStager", _SRC)
    return PyStager(n_streams, channels, n_in_per_launch)
