"""The port's SpeexResampler, SpeexResamplerTransform and CLI against the
JAX package's.

Seeded stereo and mono PCM through the reference's integration matrix
(conftest.AUDIO_TESTS, src/test.ts:14-22): one shot and in ragged chunks
(the JS wrapper's retained output buffer binding on small chunks after a
large one), the fixed-point and exact universes, the transform's byte
carry over odd splits, sync and async.  Tolerance: byte-identical output
(the default route at these channel counts is the host loops, which are
bit-identical to the reference).  The CLI's ``resample`` files and its
``info`` / ``presets`` stdout are identical.
"""

import asyncio

import numpy as np
import pytest
import torch

from speex_resampler_tpu import cli as jcli
from speex_resampler_tpu import (SpeexResampler as JaxResampler,
                                 SpeexResamplerTransform as JaxTransform)
from speex_resampler_tpu_torch import (SpeexResampler,
                                       SpeexResamplerTransform,
                                       ResamplerError, strerror,
                                       QUALITY_DEFAULT, QUALITY_MAX)
from speex_resampler_tpu_torch import cli

from conftest import AUDIO_TESTS, assert_lsb_close

torch.set_num_threads(1)

MATRIX = sorted({(c, i, o, q) for (_, i, o, c, q) in AUDIO_TESTS})


def _pcm(seconds, channels, rate, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-32768, 32768, (int(seconds * rate), channels),
                        dtype=np.int16).astype("<i2").tobytes()


def _run(r, pcm, cuts):
    return b"".join(r.process_chunk(pcm[a:b])
                    for a, b in zip([0] + cuts, cuts + [len(pcm)]))


def _cuts(pcm, channels, seed):
    """Frame-aligned ragged chunk boundaries: a large chunk, then small
    and empty ones, then mid-sized."""
    fb = 2 * channels
    n = len(pcm) // fb
    rng = np.random.default_rng(seed)
    frames = [n // 3, n // 3, n // 3 + 1, n // 3 + 2, n // 3 + 2]
    frames += sorted(rng.integers(n // 3 + 3, n, 6).tolist())
    return [f * fb for f in frames]


@pytest.mark.parametrize("channels,in_rate,out_rate,q", MATRIX)
@pytest.mark.parametrize("universe", ["float", "fixed", "exact"])
def test_process_chunk_byte_identical(channels, in_rate, out_rate, q,
                                      universe):
    kw = {"fixed": {"fixed_point": True}, "exact": {"exact": True},
          "float": {}}[universe]
    pcm = _pcm(0.5, channels, in_rate, q + channels)
    port = SpeexResampler(channels, in_rate, out_rate, q, device="cpu", **kw)
    want = JaxResampler(channels, in_rate, out_rate, q, **kw).process_chunk(
        pcm)
    assert port.process_chunk(pcm) == want
    cuts = _cuts(pcm, channels, q)
    port = SpeexResampler(channels, in_rate, out_rate, q, device="cpu", **kw)
    jax = JaxResampler(channels, in_rate, out_rate, q, **kw)
    assert _run(port, pcm, cuts) == _run(jax, pcm, cuts)
    assert port._out_buffer_size == jax._out_buffer_size


def test_retained_capacity_small_chunks_after_large():
    """The JS wrapper's retained output buffer (src/index.ts:80-87): a
    1-frame chunk after a large one may emit more than its own ceil."""
    pcm = _pcm(0.03, 1, 44100, 3)
    sched = [1000] + [1] * (len(pcm) // 2 - 1000)
    outs = []
    for r in (SpeexResampler(1, 44100, 48000, 7, device="cpu"),
              JaxResampler(1, 44100, 48000, 7)):
        pos, parts = 0, []
        for c in sched:
            parts.append(r.process_chunk(pcm[pos:pos + 2 * c]))
            pos += 2 * c
        outs.append(parts)
    assert outs[0] == outs[1]
    # two outputs (4 bytes) from one frame: its own ceil allows one
    assert any(len(p) == 4 for p in outs[0][1:])


def test_float_api_and_runtime_parity():
    """process_chunk_float (raw f32 sums), set_rate / set_quality
    mid-stream, the getters, skip_zeros and reset_mem."""
    x = np.random.default_rng(1).standard_normal((3000, 2)).astype(
        np.float32) * 8000
    port = SpeexResampler(2, 24000, 48000, 5, device="cpu")
    jax = JaxResampler(2, 24000, 48000, 5)
    for r in (port, jax):
        r.outs = [r.process_chunk_float(x[:1000]),
                  r.process_chunk_float(x[1000:1500].ravel())]
        r.set_rate(24000, 44100)
        r.set_quality(8)
        r.outs.append(r.process_chunk(x[1500:].astype("<i2").tobytes()))
        r.skip_zeros()
        r.outs.append(r.process_chunk(x[:999].astype("<i2").tobytes()))
        r.reset_mem()
        r.outs.append(r.process_chunk(x[:500].astype("<i2").tobytes()))
        r.set_rate_frac(3, 7, 21000, 49000)
    for a, b in zip(port.outs, jax.outs):
        if isinstance(a, bytes):
            assert a == b
        else:
            assert a.dtype == b.dtype and np.array_equal(a, b)
    for getter in ("get_rate", "get_ratio", "get_quality",
                   "get_input_latency", "get_output_latency"):
        assert getattr(port, getter)() == getattr(jax, getter)(), getter
    assert (port.in_rate, port.out_rate) == (21000, 49000)


def test_errors_and_constants():
    """Identical messages: the alignment check (src/index.ts:55-57, the
    channels 0 NaN quirk included), the C error strings on bad
    arguments, the fixed + exact and engine checks."""
    with pytest.raises(ValueError, match=r"multiple of channels \* 2 bytes"):
        SpeexResampler(2, 44100, 48000, device="cpu").process_chunk(b"\0" * 3)
    with pytest.raises(ValueError, match="Chunk length"):
        SpeexResampler(0, 44100, 48000, device="cpu").process_chunk(b"")
    for bad in (dict(in_rate=0, out_rate=48000),
                dict(in_rate=44100, out_rate=48000, quality=11)):
        r = SpeexResampler(1, device="cpu", **bad)
        with pytest.raises(ResamplerError, match="Invalid argument."):
            r.process_chunk(b"\0\0")
    with pytest.raises(ResamplerError):
        SpeexResampler(1, 8000, 16000, fixed_point=True, exact=True)
    with pytest.raises(ResamplerError):
        SpeexResampler(1, 8000, 16000, engine="mxu")
    assert SpeexResampler(1, 24000, 48000).quality == 7
    assert (QUALITY_DEFAULT, QUALITY_MAX) == (4, 10)
    assert strerror(99).startswith("Unknown error.")


def test_device_passthrough_and_wide_streams():
    """``device`` reaches the core; a 16-channel stream takes the device
    route (here on the CPU) within the LSB contract of the JAX package's
    device route."""
    pcm = _pcm(0.2, 16, 44100, 9)
    port = SpeexResampler(16, 44100, 48000, 7, device="cpu")
    got = np.frombuffer(port.process_chunk(pcm), "<i2")
    assert not port._core._host_route and port._core.device.type == "cpu"
    want = np.frombuffer(
        JaxResampler(16, 44100, 48000, 7).process_chunk(pcm), "<i2")
    assert_lsb_close(got, want)


def test_init_promise_and_wait_ready():
    assert asyncio.run(SpeexResampler.init_promise()) is SpeexResampler
    assert SpeexResampler.wait_ready() is SpeexResampler


@pytest.mark.parametrize("channels", [1, 2])
def test_transform_byte_carry_sync_and_async(channels):
    """Odd byte splits: the alignment carry, iter_transform, atransform
    and aiter_transform all give the JAX transform's bytes."""
    pcm = _pcm(0.3, channels, 24000, channels)[:-1]      # odd byte count
    pieces = [pcm[i:i + 1001] for i in range(0, len(pcm), 1001)]
    jt = JaxTransform(channels, 24000, 48000, 5)
    want = [jt.transform(p) for p in pieces]
    pt = SpeexResamplerTransform(channels, 24000, 48000, 5, device="cpu")
    assert [pt.transform(p) for p in pieces] == want
    assert pt._alignment_buffer == jt._alignment_buffer
    assert pt.flush() == b"" and pt._alignment_buffer == b""
    it = SpeexResamplerTransform(channels, 24000, 48000, 5, device="cpu")
    assert b"".join(it.iter_transform(pieces)) == b"".join(want)

    async def run():
        t = SpeexResamplerTransform(channels, 24000, 48000, 5, device="cpu")

        async def gen():
            for p in pieces:
                yield p

        first = await t.atransform(b"")
        return first + b"".join([o async for o in t.aiter_transform(gen())])

    assert asyncio.run(run()) == b"".join(want)


@pytest.mark.parametrize("args", [
    ["-c", "1", "-i", "24000", "-o", "48000", "-q", "5", "--chunk-frames",
     "4096"],
    ["-c", "2", "-i", "44100", "-o", "48000"],
    ["-c", "2", "-i", "44100", "-o", "24000", "-q", "5", "--skip-zeros",
     "--chunk-frames", "1000"],
    ["-c", "2", "-i", "48000", "-o", "44100", "--fixed-point"],
    ["-c", "1", "-i", "44100", "-o", "48000", "-q", "10", "--exact"]])
def test_cli_resample_identical_files(tmp_path, capsys, args):
    ch = int(args[1])
    src = tmp_path / "in.pcm"
    pcm = _pcm(0.4, ch, int(args[3]), 4)
    # chunked runs drop a partial frame at the end; one shot refuses it
    src.write_bytes(pcm[:-1] if "--chunk-frames" in args else pcm)
    outs = []
    for main in (cli.main, jcli.main):
        dst = tmp_path / f"out{len(outs)}.pcm"
        assert main(["resample", *args, str(src), str(dst)]) == 0
        outs.append(dst.read_bytes())
        cap = capsys.readouterr()
        assert cap.out == "" and "x realtime, single stream" in cap.err
    assert outs[0] == outs[1] and len(outs[0]) > 0


@pytest.mark.parametrize("argv", [
    ["info", "-i", "24000", "-o", "48000", "-q", "5"],
    ["info", "-i", "44100", "-o", "48000", "--fixed-point"],
    ["info", "-c", "1", "-i", "48000", "-o", "44100", "-q", "10"],
    ["presets"], ["presets", "-i", "48000", "-o", "8000"]])
def test_cli_info_and_presets_identical_stdout(capsys, argv):
    assert cli.main(argv) == 0
    got = capsys.readouterr()
    assert jcli.main(argv) == 0
    want = capsys.readouterr()
    assert got.out == want.out and got.out and got.err == want.err == ""
