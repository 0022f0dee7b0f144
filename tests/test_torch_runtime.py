"""The port's native stager against its NumPy twin and the JAX package's.

``speex_resampler_tpu_torch/native/speex_tpu_runtime.cpp`` is a copy of the
JAX package's source (the port imports nothing of that package), built by
the port's own loader into ``build/torch_runtime/``.  The same ragged
pushes, byte pushes (alignment carry), slot deactivations, lane-major
gathers and scatters, flushes and peeks go through the port's
``NativeStager``, the port's ``PyStager`` and the JAX package's
``NativeStager``; every result must be identical.
"""

import logging

import numpy as np
import pytest

from speex_resampler_tpu.runtime import native as jn
from speex_resampler_tpu_torch.runtime import native as tn
from speex_resampler_tpu_torch import (FleetResampler, ResamplerError,
                                       ResamplerErrorCode)

S, C, N_IN = 4, 2, 37


def test_cpp_source_is_a_byte_identical_copy():
    assert tn._SRC.read_bytes() == jn._SRC.read_bytes()
    assert tn._SRC != jn._SRC
    assert "torch_runtime" in str(tn._LIB)
    assert tn._LIB.name != jn._LIB.name


def _stagers():
    assert tn.load_runtime() is not None and jn.load_runtime() is not None
    return [tn.NativeStager(S, C, N_IN), tn.PyStager(S, C, N_IN),
            jn.NativeStager(S, C, N_IN)]


def _same(results):
    first = results[0]
    for r in results[1:]:
        if isinstance(first, tuple):
            for a, b in zip(first, r):
                _same([a, b])
        elif first is None:
            assert r is None
        else:
            a, b = np.asarray(first), np.asarray(r)
            assert a.dtype == b.dtype and a.shape == b.shape, (a, b)
            assert np.array_equal(a, b)


def test_stagers_agree_on_a_ragged_schedule():
    rng = np.random.default_rng(11)
    sts = _stagers()
    for rnd in range(6):
        for s in range(S):
            n = int(rng.integers(0, 2 * N_IN))
            frames = rng.integers(-32768, 32768, (n, C), dtype=np.int16)
            if (s + rnd) % 2:
                raw = frames.astype("<i2").tobytes()
                cut = int(rng.integers(0, len(raw) + 1)) | 1 if raw else 0
                cut = min(cut, len(raw))
                _same([st.push_bytes(s, raw[:cut]) for st in sts])
                _same([st.carry_size(s) for st in sts])
                _same([st.carry(s) for st in sts])
                _same([st.push_bytes(s, raw[cut:] + b"\x07")
                       for st in sts])
            else:
                for st in sts:
                    st.push(s, frames)
            _same([st.staged_one(s) for st in sts])
        if rnd == 2:
            for st in sts:
                st.set_active(1, False)
        if rnd == 4:
            for st in sts:
                st.set_active(1, True)
        _same([st.staged() for st in sts])
        _same([st.ready_launches() for st in sts])
        for s in range(S):
            _same([st.peek(s) for st in sts])
            _same([st.carry_size(s) for st in sts])
        while sts[0].ready_launches():
            slabs = []
            for st in sts:
                slab = np.full((S * C, N_IN + 5), 99, dtype=np.int16)
                st.fill_launch_lm(slab)
                slabs.append(slab)
            _same(slabs)
            assert (slabs[0][:, N_IN:] == 99).all()   # the tail untouched
        y = rng.integers(-32768, 32768, (S * C, 29), dtype=np.int16)
        _same([st.unpack_all_lm(y) for st in sts])
        out = [np.empty((S, 29, C), dtype=np.int16) for _ in sts]
        _same([st.unpack_all_lm(y, out=o) for st, o in zip(sts, out)])
    while True:
        flushed = [st.fill_flush() for st in sts]
        _same(flushed)
        if flushed[0][0] is None:
            break


def test_native_stager_threads_match_serial():
    """The gather/scatter thread pool gives the same bytes at every pool
    size (disjoint row/stream ranges)."""
    n_s, n_c, n_in = 37, 2, 513      # deliberately non-round
    rng = np.random.default_rng(77)
    frames = rng.integers(-32768, 32768, (n_s, n_in + 40, n_c),
                          dtype=np.int16)
    y = rng.integers(-32768, 32768, (n_s * n_c, 700), dtype=np.int16)
    ref = None
    for n in (1, 2, 4, 7):
        st = tn.NativeStager(n_s, n_c, n_in)
        assert st.set_threads(n) == n
        for s in range(n_s):
            st.push(s, frames[s])
        slab = np.zeros((n_s * n_c, n_in + 16), dtype=np.int16)
        st.fill_launch_lm(slab)
        unp = st.unpack_all_lm(y)
        for s in range(n_s):
            st.push(s, frames[s][:(s * 13) % n_in])
        got = (slab, unp, *st.fill_flush())
        if ref is None:
            ref = got
        else:
            _same([ref, got])


@pytest.mark.parametrize("kind", ["native", "numpy"])
def test_out_of_bounds_streams_raise(kind):
    """Calls that reach the C library's guards raise ResamplerError (INVALID_ARG); a
    NumPy-side index past the streams raises IndexError (as in the JAX
    package); none writes out of bounds."""
    cls = tn.NativeStager if kind == "native" else tn.PyStager
    st = cls(2, 2, 32)
    frames = np.zeros((4, 2), dtype=np.int16)
    bad = (2, 99, -1) if kind == "native" else (2, 99)
    for s in bad:
        for call in (lambda: st.push(s, frames),
                     lambda: st.push_bytes(s, b"\x00" * 8),
                     lambda: st.set_active(s, False),
                     lambda: st.staged_one(s),
                     lambda: st.peek(s),
                     lambda: st.carry_size(s)):
            with pytest.raises((ResamplerError, IndexError)):
                call()


def test_stager_boundary_validation_raises():
    """The guards in front of the raw ctypes calls raise ResamplerError
    (INVALID_ARG), with the message on the chained cause."""
    for st in (tn.NativeStager(2, 2, 32), tn.PyStager(2, 2, 32)):
        with pytest.raises(ResamplerError) as ei:
            st.push(0, np.zeros(64, dtype=np.int16))       # 1-D
        assert ei.value.code == ResamplerErrorCode.INVALID_ARG
        assert "frames must be" in str(ei.value.__cause__)
        with pytest.raises(ResamplerError):
            st.push(0, np.zeros((4, 3), dtype=np.int16))   # wrong C
    nat = tn.NativeStager(2, 2, 32)
    with pytest.raises(ResamplerError):
        nat.fill_launch_lm(np.zeros((4, 8), dtype=np.int16))    # short
    with pytest.raises(ResamplerError):
        nat.fill_launch_lm(np.zeros((4, 40), dtype=np.float32))  # dtype
    with pytest.raises(ResamplerError):
        nat.unpack_all_lm(np.zeros((4, 8), dtype=np.int16),
                          out=np.zeros((2, 8, 1), dtype=np.int16))


def test_fallback_to_numpy_stager_is_logged(monkeypatch, caplog):
    """Without a buildable library the stager is PyStager, the fleet says
    so in ``stager_kind`` and a warning is logged."""
    monkeypatch.setattr(tn, "load_runtime", lambda: None)
    with caplog.at_level(logging.WARNING, logger=tn.__name__):
        fleet = FleetResampler(2, 2, 44100, 48000, 7, device="cpu",
                               target_chunk_frames=2352)
    assert isinstance(fleet._stager, tn.PyStager)
    assert fleet.stager_kind == "numpy"
    assert "PyStager" in caplog.text
    monkeypatch.undo()
    assert FleetResampler(2, 2, 44100, 48000, 7, device="cpu",
                          target_chunk_frames=2352).stager_kind == "native"
