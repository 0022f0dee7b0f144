"""The fuzz campaign and the MultiFleet soak of the port (``tools/
fuzz_torch.py``, ``tools/soak_torch.py``) on the CPU.

- The draw generator is a pure function of (seed, index), and its
  stratified round reaches every class, computed without building weights.
- Seeded draws of both universes (fixed-point cores included) through the
  port on ``device="cpu"`` (the kernels' plain versions) and through the
  JAX package (``BatchedResampler(use_pallas=False)``, ``ResamplerCore``),
  through the campaign's own call sequences.  Tolerance: fixed
  bit-identical; float within 1 LSB under ``conftest.lsb_tie_limit``.  The
  engines' launch quanta differ, so a batch draw compares the concatenated
  outputs over their common prefix.
- A float draw of square waves: the JAX engine itself exceeds the tie
  bound against the exact host route there, within 1 LSB, as the port does.
- A plain version moved by one LSB on one output makes the campaign report
  that draw and exit 1.
- The soak runs a few seconds on the CPU and writes its fields; a leak of a
  few MB a round makes it fail.
"""

import json

import numpy as np
import pytest
import torch

from speex_resampler_tpu.core.resampler import ResamplerCore as JaxCore
from speex_resampler_tpu.parallel.batch import BatchedResampler as JaxEngine
from speex_resampler_tpu_torch.ops import streamed_fir as sf
from speex_resampler_tpu_torch.runtime import MultiFleet
from tools import fuzz_torch as fz
from tools import soak_torch as sk

from conftest import lsb_tie_limit

torch.set_num_threads(1)

LANES = 3


def test_draws_are_reproducible_and_stratified():
    """Draw i of a seed is the same config twice; the first len(CLASSES)
    draws of two seeds each reach their class (the kernel by name, or the
    core route), predicted from the config alone."""
    for seed in (0, 5):
        for i, klass in enumerate(fz.CLASSES):
            cfg = fz.make_draw(seed, i, LANES)
            assert cfg == fz.make_draw(seed, i, LANES)
            assert fz.predict(cfg) == klass, (seed, i, cfg)
    free = [fz.make_draw(0, i) for i in range(len(fz.CLASSES),
                                              len(fz.CLASSES) + 40)]
    assert free != [fz.make_draw(1, i) for i in range(len(fz.CLASSES),
                                                      len(fz.CLASSES) + 40)]
    assert {c["mode"] for c in free} == {"batch", "chunks", "caps",
                                         "setrate"}
    lanes = [c["streams"] * c["channels"] for c in free
             if c["mode"] == "batch"]
    assert any(b % 2 for b in lanes) and max(lanes) > 256


def test_lane_counts_weight_the_edges():
    rng = np.random.default_rng(0)
    lanes = [fz._lanes(rng, fz.MAX_LANES) for _ in range(2000)]
    spots = sum(any(lo <= b <= hi for lo, hi in fz.LANE_SPOTS)
                for b in lanes)
    assert spots > 1200 and min(lanes) >= 1 and max(lanes) <= fz.MAX_LANES
    assert {1, 2, 3, 63, 64, 65, 127, 130, 2047, 2048, 2049} <= set(lanes)


def test_fixed_draws_drive_an_accumulator_past_2_31():
    """The fixed draws' wrap window: its exact accumulator passes 2^31
    and the frames carry 32767 * sign(taps) over it on every third lane."""
    cfg = fz.make_draw(
        0, fz.CLASSES.index("streamed_fir_fixed_kernel<4> (tiled)"), LANES)
    assert fz.wrap_sum(cfg) > 2 ** 31
    row0, taps = fz.wrap_window(cfg)
    x = fz.batch_frames(cfg)
    lanes = x.transpose(1, 0, 2).reshape(x.shape[1], -1)
    sign = (32767 * np.sign(taps)).astype(np.int16)
    assert np.array_equal(lanes[row0:row0 + len(taps), 0], sign)


def _lsb_or_exact(got, want, fixed):
    assert got.shape == want.shape and got.size
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    if fixed:
        assert int((d > 0).sum()) == 0
    else:
        assert d.max() <= 1 and (d > 0).sum() <= lsb_tie_limit(d.size)


def _batch_vs_jax(cfg):
    frames = fz.batch_frames(cfg)
    port = fz.drive_engine(fz.port_engine(cfg, "cpu"), frames, cfg)
    jax_eng = JaxEngine(cfg["streams"], cfg["channels"], cfg["ir"],
                        cfg["orr"], cfg["q"],
                        target_chunk_frames=cfg["target"], use_pallas=False,
                        fixed_point=cfg["fixed"],
                        max_latency_ms=cfg["max_latency_ms"])
    jax = fz.drive_engine(jax_eng, frames, cfg)
    a, b = np.concatenate(port, axis=1), np.concatenate(jax, axis=1)
    m = min(a.shape[1], b.shape[1])
    _lsb_or_exact(a[:, :m], b[:, :m], cfg["fixed"])
    for s in (0, cfg["streams"] - 1):
        core = fz.ResamplerCore(cfg["channels"], cfg["ir"], cfg["orr"],
                                cfg["ir"], cfg["orr"], cfg["q"],
                                fixed_point=cfg["fixed"], engine="host",
                                device="cpu")
        jcore = JaxCore(cfg["channels"], cfg["ir"], cfg["orr"], cfg["ir"],
                        cfg["orr"], cfg["q"], fixed_point=cfg["fixed"])
        want, _ = fz.drive_core_stream(jcore, frames[s], cfg)
        got, _ = fz.drive_core_stream(core, frames[s], cfg)
        _lsb_or_exact(got, want, cfg["fixed"])
        _lsb_or_exact(a[s, :m], got[:m], cfg["fixed"])


def _core_vs_jax(cfg):
    frames = fz.core_frames(cfg)
    drive = fz.CORE_CALLS[cfg["mode"]]
    engine = "host" if cfg["fixed"] else "device"
    ir, orr, q = cfg["rates"][0]
    got = drive(fz.port_core(cfg, engine, "cpu"), frames, cfg)
    want = drive(JaxCore(cfg["channels"], ir, orr, ir, orr, q,
                         fixed_point=cfg["fixed"], engine=engine),
                 frames, cfg)
    if cfg["mode"] == "caps":
        assert [r[:2] for r in got] == [r[:2] for r in want]
        got, want = [r[2] for r in got], [r[2] for r in want]
        if cfg["use_float"]:
            g, w = np.concatenate(got), np.concatenate(want)
            assert not g.size or np.abs(g - w).max() <= 0.1
            return
    assert [o.shape for o in got] == [o.shape for o in want]
    _lsb_or_exact(np.concatenate([o.reshape(-1) for o in got]),
                  np.concatenate([o.reshape(-1) for o in want]),
                  cfg["fixed"])


def _class_draw(klass, seed=3):
    cfg = fz.make_draw(seed, fz.CLASSES.index(klass), LANES)
    if not cfg["fixed"]:
        # the tie bound counts independent rounding events; float square
        # waves: test_square_waves_repeat_ties_in_the_jax_engine_too
        cfg["pcm"] = "noise"
    return cfg


def _core_draw(mode, fixed, seed):
    cfg = fz.draw_core(np.random.default_rng(seed), mode=mode, fixed=fixed)
    if fixed and mode == "caps":
        cfg["use_float"] = False
    return cfg


DRAWS = {
    "tiled-highest": lambda: _class_draw("streamed_fir_f32_kernel (tiled)"),
    "tiled-fixed4": lambda: _class_draw(
        "streamed_fir_fixed_kernel<4> (tiled)"),
    "tiled-fixed1": lambda: _class_draw(
        "streamed_fir_fixed_kernel<1> (tiled)"),
    "dense-float": lambda: _class_draw("dense_fir_f32_kernel"),
    "gather-band-fixed": lambda: _class_draw(
        "gather_fir_fixed_band_kernel<4>"),
    "chunks-fixed": lambda: _core_draw("chunks", True, 4),
    "caps-fixed": lambda: _core_draw("caps", True, 8),
    "setrate-float": lambda: _core_draw("setrate", False, 2),
}


@pytest.mark.parametrize("name", list(DRAWS))
def test_draw_matches_jax(name):
    cfg = DRAWS[name]()
    if cfg["mode"] == "batch":
        _batch_vs_jax(cfg)
    else:
        _core_vs_jax(cfg)


def test_square_waves_repeat_ties_in_the_jax_engine_too():
    """Why the campaign holds a float draw of square waves within 1 LSB and
    reports its ties without bounding them: on such a draw (a full-scale
    square wave a lane, "highest", 192k -> 16k q6) the JAX engine itself
    puts more outputs 1 LSB off the exact host route than the tie bound
    allows, since a periodic input repeats its ties every period; the
    port's engine does the same, and stays within 1 LSB of both."""
    cfg = fz.make_draw(3, fz.CLASSES.index("streamed_fir_f32_kernel (tiled)"),
                       LANES)
    assert cfg["pcm"] == "square" and not cfg["fixed"]
    frames = fz.batch_frames(cfg)
    port = np.concatenate(fz.drive_engine(fz.port_engine(cfg, "cpu"),
                                          frames, cfg), axis=1)
    jax_eng = JaxEngine(cfg["streams"], cfg["channels"], cfg["ir"],
                        cfg["orr"], cfg["q"],
                        target_chunk_frames=cfg["target"], use_pallas=False,
                        max_latency_ms=cfg["max_latency_ms"])
    jax = np.concatenate(fz.drive_engine(jax_eng, frames, cfg), axis=1)
    over = []
    for s in range(cfg["streams"]):
        core = fz.ResamplerCore(cfg["channels"], cfg["ir"], cfg["orr"],
                                cfg["ir"], cfg["orr"], cfg["q"],
                                engine="host", device="cpu")
        want, _ = fz.drive_core_stream(core, frames[s], cfg)
        m = min(len(want), port.shape[1], jax.shape[1])
        for y in (port, jax):
            d = np.abs(y[s, :m].astype(np.int32) - want[:m].astype(np.int32))
            assert d.max() <= 1
        d = np.abs(jax[s, :m].astype(np.int32) - want[:m].astype(np.int32))
        over.append(int((d > 0).sum()) > lsb_tie_limit(d.size))
        d = np.abs(port[s, :m].astype(np.int32) - jax[s, :m].astype(np.int32))
        assert d.max() <= 1
    assert any(over)


def test_campaign_passes_on_the_cpu(tmp_path, monkeypatch):
    """The stratified round and a few free draws through the campaign on
    the plain versions: no failure, every class reached."""
    monkeypatch.setattr(fz, "OUT", tmp_path / "fuzz.json")
    rc = fz.main(["--device", "cpu", "--max-lanes", str(LANES), "--draws",
                  str(len(fz.CLASSES) + 2), "--seed", "2"])
    out = json.loads((tmp_path / "fuzz.json").read_text())
    assert rc == 0 and out["failures"] == [], out["failures"]
    assert out["draws"] == len(fz.CLASSES) + 2
    assert all(any(k.startswith(c) for k in out["by_class"])
               for c in fz.CLASSES), out["by_class"]


def test_campaign_catches_an_injected_fault(tmp_path, monkeypatch):
    """A phase-tiled plain version that moves one output by one LSB: the
    fixed tiled draw fails (exact against the host cores), is reported
    with its config, and the campaign exits 1."""
    plain = sf.resample_streamed_reference

    def off_by_one(*args, **kw):
        y = plain(*args, **kw).clone()
        y[7, 0] += 1 if y[7, 0] < 32767 else -1
        return y

    monkeypatch.setattr(sf, "resample_streamed_reference", off_by_one)
    monkeypatch.setattr(fz, "OUT", tmp_path / "fuzz.json")
    rc = fz.main(["--device", "cpu", "--max-lanes", str(LANES), "--draws",
                  "5", "--seed", "0"])
    out = json.loads((tmp_path / "fuzz.json").read_text())
    assert rc == 1
    fixed = fz.CLASSES.index("streamed_fir_fixed_kernel<4> (tiled)")
    failed = {f["index"]: f for f in out["failures"]}
    assert fixed in failed and "mismatches" in failed[fixed]["detail"]
    assert failed[fixed]["cfg"] == fz.make_draw(0, fixed, LANES)


@pytest.fixture
def light_soak(monkeypatch, tmp_path):
    """The soak at a CPU's size: six low-quality configs, 8 streams a
    bucket, 3 live a config."""
    monkeypatch.setattr(sk, "CONFIGS", [
        (44100, 48000, 3), (24000, 48000, 2), (48000, 44100, 2),
        (44100, 24000, 2), (32000, 48000, 1), (16000, 8000, 2)])
    monkeypatch.setattr(sk, "PER_BUCKET", 8)
    monkeypatch.setattr(sk, "LIVE_PER_CONFIG", 3)
    monkeypatch.setattr(sk, "OUT", tmp_path / "soak.json")
    return tmp_path / "soak.json"


def test_soak_runs_and_writes_its_fields(light_soak):
    rc = sk.main(["--device", "cpu", "--seconds", "4"])
    out = json.loads(light_soak.read_text())
    assert rc == 0 and out["pass"], out["failed"]
    assert out["rounds"] > 10 and out["launches"] > 0
    assert out["out_samples"] > 0 and not out["degraded"]
    assert len(out["launches_by_config"]) == len(sk.CONFIGS)
    assert set(out["series"]["rss"]) == {
        "baseline_mb", "peak_mb", "final_mb", "growth_peak_mb",
        "growth_final_mb", "slope_mb_per_min"}
    assert out["thresholds"]["slope_mb_per_min"] is None   # seconds only


def test_soak_fails_on_a_leak(light_soak, monkeypatch):
    """Each poll() keeps 8 MB alive: the flat-memory assertion fails."""
    leak, poll = [], MultiFleet.poll

    def leaky(self):
        leak.append(np.ones(1 << 20))          # 8 MB, touched
        return poll(self)

    monkeypatch.setattr(MultiFleet, "poll", leaky)
    rc = sk.main(["--device", "cpu", "--seconds", "4"])
    out = json.loads(light_soak.read_text())
    assert rc == 1 and not out["pass"]
    assert any(f.startswith("rss") for f in out["failed"]), out["failed"]


def test_int8_tie_rate_at_full_scale_is_the_schemes():
    """What the campaign found and holds int8 to (ROADMAP section 3): at
    the flagship, int8 (D = 3, certificate 0.164 LSB) puts more than the
    tie bound's 5e-3 of full-scale noise outputs 1 LSB off the exact host
    route, within 1 LSB; "highest" stays under it on the same frames.
    The port's int8 is the JAX package's bit for bit (tests/
    test_torch_batch.py), so the rate is the reference scheme's."""
    rng = np.random.default_rng(1)
    x = rng.integers(-32768, 32768, (4, 60000, 1), dtype=np.int16)
    rates = {}
    for scheme in ("int8", "highest"):
        eng = fz.BatchedResampler(4, 1, 44100, 48000, 7, device="cpu",
                                  target_chunk_frames=4096, scheme=scheme)
        y = np.concatenate([eng.process(x), eng.flush()], axis=1)
        d = []
        for s in range(4):
            core = fz.ResamplerCore(1, 44100, 48000, 44100, 48000, 7,
                                    engine="host", device="cpu")
            want = core.process_interleaved(x[s], 70000)
            d.append(np.abs(y[s, :len(want), 0].astype(np.int32)
                            - want[:, 0]))
        d = np.concatenate(d)
        assert d.max() == 1
        rates[scheme] = (d > 0).sum() / d.size
    assert rates["int8"] > 5e-3 > rates["highest"], rates
