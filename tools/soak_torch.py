"""MultiFleet soak of the PyTorch port on the card: minutes of churn, flat
memory asserted.

    SOAK_S=300 python3 tools/soak_torch.py [--seconds S] [--device cuda|cpu]

The port of ``experiments/soak_multifleet.py``, with the same churn mix a
round: push (backpressure honoured: ``writable`` first, refusals counted),
poll and pull on every live stream; one detach and one attach with a
never-reused stream id; every 3rd round an exact rate switch to the next
config; every 10th an ``end_stream`` and a drain; every 25th a
``state_dict()``, ``stats()`` and an extra ``poll()``.  The same six
configs and ``max_idle_buckets=3``, so idle buckets are evicted (their
fleets closed) and rebuilt all the time.  A bucket holds
:data:`PER_BUCKET` stereo streams (the kernels launch at its full width,
128 lanes), eight live streams a config at the start.

Three memory series are sampled every :data:`SAMPLE_S` seconds: VmRSS
(``/proc/self/status``), ``torch.cuda.memory_allocated()`` (the caching
allocator keeps freed blocks, so ``memory_reserved()`` is printed beside
it but not asserted) and the pinned host bytes in use
(``torch.cuda.host_memory_stats()``, else the live fleets' pinned slabs
and readback buffers).  Past a warm-up (the later of a quarter of the run
and the round by which every config's bucket has launched) each series is
held to the JAX soak's thresholds: peak growth over the baseline within 64 MB, final
growth within 32 MB and, in a run of at least two minutes (not the 60 s of
``chip_smoke.py`` phase 11), a least-squares slope of at most 4 MB/min.
Also asserted: no bucket degraded, launches and output, and, on the card,
every bucket's kernel launched (counted by kernel name).

Writes ``build/soak_torch.json`` and exits 1 on a failed assertion.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import weakref
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from speex_resampler_tpu_torch.runtime import MultiFleet  # noqa: E402
from speex_resampler_tpu_torch.utils.launches import (  # noqa: E402
    count_launches, reset_launches, step_kernel)

OUT = REPO / "build" / "soak_torch.json"

WARMUP_FRAC = 0.25
GROWTH_PEAK_MB = 64.0    # ceiling past the baseline, any sample
GROWTH_FINAL_MB = 32.0   # where a series must settle at the end
SLOPE_MB_PER_MIN = 4.0   # post-baseline least-squares drift ceiling
# a slope over seconds measures the allocators' noise, not a leak: it is
# asserted in runs of at least this many seconds
SLOPE_MIN_S = 120.0

CONFIGS = [(44100, 48000, 7), (24000, 48000, 5),
           (48000, 44100, 10), (44100, 24000, 5),
           (32000, 48000, 3), (16000, 8000, 4)]
CHANNELS = 2
PER_BUCKET = 64
LIVE_PER_CONFIG = 8
CHUNK_FRAMES = 512
MB = 1024.0 * 1024.0
# memory is sampled this often (sampling every round, thousands a minute,
# would grow the sample lists faster than the slope ceiling)
SAMPLE_S = 0.5
LOG_S = 15.0


def rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    raise RuntimeError("no VmRSS")


def pinned_bytes(mf: MultiFleet) -> tuple:
    """(pinned host bytes in use, where the number comes from)."""
    stats = getattr(torch.cuda, "host_memory_stats", None)
    if stats is not None:
        s = stats()
        for key in ("active_bytes.current", "allocated_bytes.current"):
            if key in s:
                return int(s[key]), f"torch.cuda.host_memory_stats {key}"
    n = 0
    for b in mf._buckets.values():
        f = b.fleet
        for t in [s._pinned for s in f._slabs] + list(f._readback_bufs):
            if t is not None:
                n += t.numel() * t.element_size()
    return n, "live fleets' pinned slabs and readback buffers"


def _series(samples, baseline_t: float) -> dict:
    """Baseline, peak and final growth and slope of one (t, MB) series
    past ``baseline_t``."""
    post = [(t, v) for t, v in samples if t >= baseline_t] or samples[-1:]
    base = post[0][1]
    slope = 0.0
    if len(post) >= 2:
        ts, vs = np.array(post).T
        slope = float(np.polyfit(ts, vs, 1)[0]) * 60.0
    return {"baseline_mb": round(base, 3),
            "peak_mb": round(max(v for _, v in post), 3),
            "final_mb": round(post[-1][1], 3),
            "growth_peak_mb": round(max(v for _, v in post) - base, 3),
            "growth_final_mb": round(post[-1][1] - base, 3),
            "slope_mb_per_min": round(slope, 3)}


def soak(seconds: float, device: str = "cuda", log=print) -> dict:
    """Run the churn for ``seconds``; returns the result (``pass`` and,
    where it failed, ``failed``: the assertions that did not hold)."""
    cuda = device == "cuda"
    check_slope = seconds >= SLOPE_MIN_S
    rng = np.random.default_rng(7)
    mf = MultiFleet(channels=CHANNELS, capacity_per_bucket=PER_BUCKET,
                    target_chunk_frames=CHUNK_FRAMES, device=device,
                    max_staged_frames=24576, max_banked_frames=65536,
                    max_idle_buckets=3)
    chunks: dict = {}
    kernels: dict = {}       # config -> ((geometry, launch key), name)
    launches: dict = {}            # config -> fleet launches
    seen = weakref.WeakKeyDictionary()     # fleet -> its launches so far
    live: list = []
    next_sid = 0

    def chunk_for(cfg):
        if cfg not in chunks:
            q = mf._buckets[cfg].fleet.bspec.in_per_launch
            chunks[cfg] = rng.integers(-32768, 32768, (q, CHANNELS),
                                       dtype=np.int16)
        return chunks[cfg]

    def attach(cfg):
        nonlocal next_sid
        sid = f"s{next_sid}"          # never reused
        next_sid += 1
        mf.add_stream(sid, *cfg)
        live.append((sid, cfg))

    def note_buckets():
        for cfg, b in mf._buckets.items():
            f = b.fleet
            n = f.stats.launches
            launches[cfg] = launches.get(cfg, 0) + n - seen.get(f, 0)
            seen[f] = n
            if cfg not in kernels and f._step is not None:
                kernels[cfg] = step_kernel(f._step)

    if cuda:
        reset_launches()
    for cfg in CONFIGS[:4]:
        for _ in range(LIVE_PER_CONFIG):
            attach(cfg)

    t0 = time.monotonic()
    samples = {"rss": [], "device_allocated": [], "pinned": []}
    reserved_max = 0
    pinned_src = "none"
    rounds = fleet_launches = out_samples = refused = 0
    degraded = False
    warm_t = None        # when every config's bucket had launched once
    next_sample = next_log = 0.0

    def sample(now):
        nonlocal reserved_max, pinned_src
        samples["rss"].append((now, rss_mb()))
        if cuda:
            torch.cuda.synchronize()
            samples["device_allocated"].append(
                (now, torch.cuda.memory_allocated() / MB))
            reserved_max = max(reserved_max, torch.cuda.memory_reserved())
            n, pinned_src = pinned_bytes(mf)
            samples["pinned"].append((now, n / MB))
    while time.monotonic() - t0 < seconds:
        rounds += 1
        for sid, cfg in live:
            c = chunk_for(cfg)
            if mf.writable(sid, len(c)):
                mf.push(sid, c)
            else:
                refused += 1
        fleet_launches += mf.poll()
        note_buckets()
        degraded |= mf.degraded
        for sid, _ in live:
            out_samples += mf.pull(sid).size
        sid, _ = live.pop(rounds % len(live))
        mf.remove_stream(sid)
        attach(CONFIGS[rounds % len(CONFIGS)])
        if rounds % 3 == 0:
            i = rounds % len(live)
            sid, cfg = live[i]
            new = CONFIGS[(CONFIGS.index(cfg) + 1) % len(CONFIGS)]
            mf.set_stream_rate(sid, *new)
            live[i] = (sid, new)
        if rounds % 10 == 0:
            sid, cfg = live.pop(0)
            mf.end_stream(sid)
            mf.pull(sid)               # drain the tail
            attach(cfg)
        if rounds % 25 == 0:
            state = mf.state_dict()
            del state
            mf.stats()
            fleet_launches += mf.poll()
            note_buckets()
        now = time.monotonic() - t0
        if warm_t is None and len(launches) == len(CONFIGS) \
                and min(launches.values()) > 0:
            warm_t = now
        if now >= next_sample:
            next_sample = now + SAMPLE_S
            sample(now)
        if now >= next_log:
            next_log = now + LOG_S
            log(f"soak [{now:6.1f} s] round {rounds}: "
                + ", ".join(f"{k} {v[-1][1]:.1f} MB"
                            for k, v in samples.items() if v)
                + (f", device reserved "
                   f"{torch.cuda.memory_reserved() / MB:.1f} MB"
                   if cuda else "")
                + f", {len(live)} live, {len(mf._buckets)} buckets")
    sample(time.monotonic() - t0)
    elapsed = time.monotonic() - t0
    baseline_t = min(max(WARMUP_FRAC * seconds, warm_t or 0.0),
                     samples["rss"][-1][0])
    series = {k: _series(v, baseline_t) for k, v in samples.items() if v}
    failed = []
    for name, s in series.items():
        if s["growth_peak_mb"] >= GROWTH_PEAK_MB:
            failed.append(f"{name} peak growth {s['growth_peak_mb']} MB")
        if s["growth_final_mb"] >= GROWTH_FINAL_MB:
            failed.append(f"{name} final growth {s['growth_final_mb']} MB")
        if check_slope and s["slope_mb_per_min"] >= SLOPE_MB_PER_MIN:
            failed.append(f"{name} slope {s['slope_mb_per_min']} MB/min")
    if degraded:
        failed.append(f"degraded buckets {mf.degraded_buckets()}")
    if fleet_launches == 0 or out_samples == 0:
        failed.append("no launch or no output")
    if set(launches) != set(CONFIGS) or min(launches.values()) == 0:
        failed.append(f"bucket launches {launches}")
    by_kernel = count_launches(dict(kernels.values())) if cuda else {}
    if cuda and any(by_kernel.get(name, 0) == 0
                    for _, name in kernels.values()):
        failed.append(f"kernel launches {by_kernel}")
    return {
        "device": device, "seconds": round(elapsed, 1), "rounds": rounds,
        "launches": fleet_launches, "out_samples": out_samples,
        "pushes_refused": refused, "streams_created": next_sid,
        # a removed stream's record stays until it is pulled (its banked
        # output stays pullable), and this churn never pulls one
        "stream_records": len(mf._streams),
        "configs": len(CONFIGS), "per_bucket": PER_BUCKET,
        "max_idle_buckets": 3,
        "launches_by_config": {str(k): v for k, v in launches.items()},
        "launches_by_kernel": by_kernel,
        "baseline_s": round(baseline_t, 1),
        "series": series, "pinned_source": pinned_src,
        "device_reserved_max_mb": round(reserved_max / MB, 3),
        "thresholds": {"growth_peak_mb": GROWTH_PEAK_MB,
                       "growth_final_mb": GROWTH_FINAL_MB,
                       "slope_mb_per_min": (SLOPE_MB_PER_MIN if check_slope
                                            else None)},
        "degraded": degraded, "failed": failed, "pass": not failed}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float,
                    default=float(os.environ.get("SOAK_S", "300")))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            sys.exit("soak_torch: no CUDA device")
        from tools.fuzz_torch import card
        print(f"card: {card()}")
    result = soak(args.seconds, args.device)
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0 if result["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
