"""Public API mirroring the reference's TypeScript layer (src/index.ts).

``SpeexResampler`` reproduces the JS wrapper byte-for-byte in behavior:
  - ``process_chunk(bytes) -> bytes`` with interleaved s16 PCM
    (src/index.ts:50-116), including the chunk-alignment validation
    (:55-57), the ``ceil(len*outRate/inRate)`` output-capacity rule (:80)
    with its drop-unconsumed-input consequence, and identical error
    messages.
  - ``SpeexResampler.init_promise`` — the wasm-module-ready promise analog
    (src/index.ts:31). There is no wasm to load here, so it resolves
    immediately (``SpeexResampler.wait_ready()`` is the sync counterpart).

``SpeexResamplerTransform`` reproduces the Node Transform stream
(src/index.ts:121-162): a push-based transformer with the byte-alignment
carry buffer, usable directly or over any iterable of byte chunks.

The port of the JAX package's ``api.py``; ``device`` passes through to
``ResamplerCore`` (where its device route runs).
"""

from __future__ import annotations

import math

import numpy as np

from .core.resampler import ResamplerCore
from .utils.errors import ResamplerError, ResamplerErrorCode

__all__ = ["SpeexResampler", "SpeexResamplerTransform"]

_BYTES_PER_SAMPLE = 2


class SpeexResampler:
    """One audio stream's resampler ("you need a new resampler for every
    audio stream", reference Readme.md:20-21).

    Parameters match the JS constructor (src/index.ts:40-44):
      channels: number of interleaved channels (min 1)
      in_rate / out_rate: Hz
      quality: 0-10, default 7
      fixed_point: select the reference's FIXED_POINT build universe
        (arch.h:39-67) — Q15 integer hot loops, bit-exact vs the fixed
        oracle — instead of the shipped WASM's float build semantics
      exact: float universe, order-faithful host hot loops — output is
        BIT-IDENTICAL to the reference (zero mismatches) instead of the
        device path's <=1 LSB, at single-stream host speed
      engine: float hot-loop placement — "auto" (default: host loops at
        <= core.HOST_AUTO_MAX_CHANNELS channels, device above), "host", or
        "device" (see ResamplerCore.__init__)
      device: where the device route runs, "cuda" (default) or "cpu"
    """

    def __init__(self, channels: int, in_rate: int, out_rate: int,
                 quality: int = 7, *, fixed_point: bool = False,
                 exact: bool = False, engine: str = "auto",
                 device="cuda"):
        self.channels = channels
        self.in_rate = in_rate
        self.out_rate = out_rate
        self.quality = quality
        self.fixed_point = fixed_point
        self.exact = exact
        self.engine = engine
        self.device = device
        if fixed_point and exact:
            # the fixed universe is exact everywhere already; fail at
            # construction, not at the first process call
            raise ResamplerError(ResamplerErrorCode.INVALID_ARG)
        if engine not in ("auto", "host", "device"):
            raise ResamplerError(ResamplerErrorCode.INVALID_ARG)
        self._core: ResamplerCore | None = None
        # JS wrapper's retained output buffer: grows to the largest
        # ceil(len*outRate/inRate) seen and never shrinks; the capacity
        # passed to the core is derived from the RETAINED size
        # (src/index.ts:80-87, :95), so a small chunk after a large one may
        # legally emit more than its own ceil.
        self._out_buffer_size = 0

    # -- module-ready analog (src/index.ts:31) --------------------------
    @classmethod
    async def init_promise(cls):
        """Awaitable analog of ``SpeexResampler.initPromise``; resolves
        immediately (no wasm module to instantiate)."""
        return cls

    @classmethod
    def wait_ready(cls):
        """Synchronous counterpart of init_promise (no-op)."""
        return cls

    def _ensure_core(self) -> ResamplerCore:
        # Lazy init on first chunk, like the JS wrapper creating the C
        # state inside processChunk (src/index.ts:59-68).
        if self._core is None:
            self._core = ResamplerCore(self.channels, self.in_rate,
                                       self.out_rate, self.in_rate,
                                       self.out_rate, self.quality,
                                       fixed_point=self.fixed_point,
                                       exact=self.exact,
                                       engine=self.engine,
                                       device=self.device)
        return self._core

    def process_chunk(self, chunk: bytes | bytearray | memoryview) -> bytes:
        """Resample one chunk of interleaved signed-16-bit PCM.

        Mirrors processChunk (src/index.ts:50-116): output capacity is the
        retained (monotonically grown) buffer of
        ``max over chunks of ceil(len(chunk) * out_rate / in_rate)`` bytes;
        if that binds (it essentially never does for sane rates), excess
        input is dropped exactly like the JS wrapper, which ignores the
        returned in_len.
        """
        chunk = bytes(chunk)
        # JS quirk preserved: channels == 0 makes the modulus NaN, which
        # fails the alignment check (src/index.ts:55-57) before the C init
        # would ever report INVALID_ARG.
        if (self.channels <= 0
                or len(chunk) % (self.channels * _BYTES_PER_SAMPLE) != 0):
            raise ValueError(
                "Chunk length should be a multiple of channels * 2 bytes")
        core = self._ensure_core()

        frames = np.frombuffer(chunk, dtype="<i2").reshape(
            -1, self.channels)
        out_buf_bytes = math.ceil(
            len(chunk) * self.out_rate / self.in_rate)
        if out_buf_bytes > self._out_buffer_size:
            self._out_buffer_size = out_buf_bytes
        capacity = (self._out_buffer_size // self.channels
                    // _BYTES_PER_SAMPLE)
        out = core.process_interleaved(frames, capacity)
        return out.astype("<i2").tobytes()

    # JS-style alias
    processChunk = process_chunk

    def process_chunk_float(self, samples: "np.ndarray") -> "np.ndarray":
        """Float-sample path (speex_resampler_process_interleaved_float,
        resample.c:1037-1059): f32 samples on the ±32768 scale, interleaved
        [n, channels] (or flat [n*channels]); returns f32 [m, channels].
        No WORD2INT on output — raw filter sums, like the C float API."""
        x = np.asarray(samples, dtype=np.float32)
        if x.ndim == 1:
            if self.channels <= 0 or x.size % self.channels:
                raise ValueError(
                    "Chunk length should be a multiple of channels")
            x = x.reshape(-1, self.channels)
        core = self._ensure_core()
        capacity = math.ceil(x.shape[0] * self.out_rate / self.in_rate) + 1
        return core.process_interleaved_float(x, capacity)

    # -- full runtime API parity (C surface, speex_resampler.h) ---------

    def set_rate(self, in_rate: int, out_rate: int):
        """speex_resampler_set_rate (resample.c:1084-1087)."""
        self._ensure_core().set_rate(in_rate, out_rate)
        self.in_rate, self.out_rate = in_rate, out_rate

    def set_rate_frac(self, ratio_num: int, ratio_den: int, in_rate: int,
                      out_rate: int):
        self._ensure_core().set_rate_frac(ratio_num, ratio_den, in_rate,
                                          out_rate)
        self.in_rate, self.out_rate = in_rate, out_rate

    def get_rate(self) -> tuple[int, int]:
        return self._ensure_core().get_rate()

    def get_ratio(self) -> tuple[int, int]:
        return self._ensure_core().get_ratio()

    def set_quality(self, quality: int):
        self._ensure_core().set_quality(quality)
        self.quality = quality

    def get_quality(self) -> int:
        return self._ensure_core().quality

    def get_input_latency(self) -> int:
        return self._ensure_core().input_latency()

    def get_output_latency(self) -> int:
        return self._ensure_core().output_latency()

    def skip_zeros(self):
        self._ensure_core().skip_zeros()

    def reset_mem(self):
        self._ensure_core().reset_mem()


_EMPTY = b""


class SpeexResamplerTransform:
    """Streaming transform with the byte-alignment carry buffer
    (src/index.ts:121-162).

    Usage (push style, like Node's Transform):
        t = SpeexResamplerTransform(2, 44100, 48000)
        out = t.transform(chunk_bytes)   # may be b"" if all bytes carried
        ... ; tail = t.flush()

    or pull style over an iterable of byte chunks:
        for out in t.iter_transform(chunks): ...
    """

    def __init__(self, channels: int, in_rate: int, out_rate: int,
                 quality: int = 7, *, fixed_point: bool = False,
                 exact: bool = False, engine: str = "auto",
                 device="cuda"):
        self.channels = channels
        self.resampler = SpeexResampler(channels, in_rate, out_rate, quality,
                                        fixed_point=fixed_point, exact=exact,
                                        engine=engine, device=device)
        self._alignment_buffer = _EMPTY

    def transform(self, chunk: bytes) -> bytes:
        data = self._alignment_buffer + bytes(chunk)
        self._alignment_buffer = _EMPTY
        # Speex needs 16 bits * channels alignment; keep extraneous bytes
        # for the next chunk (src/index.ts:148-154)
        extraneous = len(data) % (self.channels * _BYTES_PER_SAMPLE)
        if extraneous:
            self._alignment_buffer = data[len(data) - extraneous:]
            data = data[:len(data) - extraneous]
        return self.resampler.process_chunk(data)

    def iter_transform(self, chunks):
        for chunk in chunks:
            out = self.transform(chunk)
            if out:
                yield out
        tail = self.flush()
        if tail:
            yield tail

    def flush(self) -> bytes:
        """End-of-stream: any carried bytes are an incomplete frame and are
        dropped (the Node stream simply ends with them unconsumed)."""
        self._alignment_buffer = _EMPTY
        return _EMPTY

    async def atransform(self, chunk: bytes) -> bytes:
        """Asyncio counterpart of :meth:`transform` — runs the resample off
        the event loop (the Node Transform is push-async; this is the
        asyncio-native equivalent)."""
        import asyncio
        return await asyncio.get_running_loop().run_in_executor(
            None, self.transform, chunk)

    async def aiter_transform(self, chunks):
        """Transform an async iterable of byte chunks."""
        async for chunk in chunks:
            out = await self.atransform(chunk)
            if out:
                yield out
        tail = self.flush()
        if tail:
            yield tail
