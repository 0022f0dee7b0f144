"""The benchmark's one traffic generator: a pool of distinct input quanta
made on the device from the seed, as a traffic mix's parameters say.

A mix's file (``traffic/<mix>.json``) gives the lanes' classes and their
shares, the tones, levels and silent gaps of the signal, and the least
size of the pool.  Every seed gets the same sizes and the same number of
lanes in each class; the seed draws which lanes they are, the signals
themselves and the order in which a stream walks through the pool.

Classes, each lane in one:
  * ``music``: a sum of tones at log-uniform frequencies, with a little
    noise, at a level drawn from a range of RMS levels;
  * ``noise``: white noise at a level drawn from a range;
  * ``peak``: music driven past full scale, clipped to int16 (full-scale
    samples and saturated outputs);
  * ``silence``: digital silence (zeros).
Every lane also has a silent gap at a random place of each quantum,
whose longest length is a share of the quantum.
"""

from __future__ import annotations

import math

import torch

CLASSES = ("music", "noise", "peak", "silence")


def _uniform(gen, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)


def _db_to_amp(db: torch.Tensor) -> torch.Tensor:
    return 32768.0 * torch.pow(10.0, db / 20.0)


def lane_classes(gen: torch.Generator, lanes: int, shares: dict,
                 device) -> torch.Tensor:
    """int64 [lanes]: each lane's class index into CLASSES.  The counts
    are fixed by the shares (rounded, the remainder to ``music``); the
    seed draws which lanes take them."""
    counts = {c: int(math.floor(shares.get(c, 0.0) * lanes)) for c in CLASSES}
    counts["music"] += lanes - sum(counts.values())
    cls = torch.cat([torch.full((counts[c],), i, dtype=torch.int64)
                     for i, c in enumerate(CLASSES)]).to(device)
    return cls[torch.randperm(lanes, generator=gen, device=device)]


def make_quantum(gen: torch.Generator, cls: torch.Tensor, n: int,
                 rate: int, sig: dict, device) -> torch.Tensor:
    """int16 [n, lanes]: one quantum of every lane."""
    lanes = cls.shape[0]
    tones = int(sig["tones"])
    lo, hi = (math.log(f) for f in sig["tone_hz"])
    freq = torch.exp(_uniform(gen, (lanes, tones), lo, hi, device))
    phase = _uniform(gen, (lanes, tones), 0.0, 2 * math.pi, device)
    weight = _uniform(gen, (lanes, tones), 0.2, 1.0, device)
    weight = weight / weight.square().sum(1, keepdim=True).sqrt()
    t = torch.arange(n, device=device, dtype=torch.float64)[:, None]
    x = torch.zeros((n, lanes), device=device)
    for i in range(tones):
        arg = t * (2 * math.pi * freq[:, i].double() / rate) + phase[:, i]
        x += (weight[:, i] * math.sqrt(2)) * torch.sin(arg).float()
    x += 10 ** (sig["music_noise_db"] / 20) * torch.randn(
        (n, lanes), generator=gen, device=device)
    music_amp = _db_to_amp(_uniform(gen, (lanes,), *sig["music_rms_dbfs"],
                                    device))
    noise_amp = _db_to_amp(_uniform(gen, (lanes,), *sig["noise_rms_dbfs"],
                                    device))
    peak_amp = _db_to_amp(_uniform(gen, (lanes,), *sig["peak_rms_dbfs"],
                                   device))
    noise = torch.randn((n, lanes), generator=gen, device=device)
    c_noise, c_peak, c_silence = (CLASSES.index(c)
                                  for c in ("noise", "peak", "silence"))
    amp = torch.where(cls == c_peak, peak_amp, music_amp)
    y = torch.where(cls == c_noise, noise * noise_amp, x * amp)
    y = torch.where(cls == c_silence, torch.zeros_like(y), y)
    gap = (_uniform(gen, (lanes,), 0.0, sig["gap_share"], device)
           * n).long()
    start = (_uniform(gen, (lanes,), 0.0, 1.0, device)
             * (n - gap + 1)).long()
    rows = torch.arange(n, device=device)[:, None]
    y = torch.where((rows >= start) & (rows < start + gap),
                    torch.zeros_like(y), y)
    return torch.round(y).clamp_(-32768, 32767).to(torch.int16)


def make_pool(traffic: dict, n_in: int, lanes: int, rate: int, seed: int,
              device) -> tuple[torch.Tensor, list]:
    """(int16 [P, n_in, lanes] on ``device``, the stream's walk: a list
    of P pool indices, call k reading ``pool[walk[k % P]]``).  P is the
    fewest quanta that fill ``pool_min_bytes``, and at least 2."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 64))
    quantum_bytes = n_in * lanes * 2
    P = max(2, -(-int(traffic["pool_min_bytes"]) // quantum_bytes))
    sig = traffic["signal"]
    cls = lane_classes(gen, lanes, sig["lane_shares"], device)
    pool = torch.empty((P, n_in, lanes), dtype=torch.int16, device=device)
    for p in range(P):
        pool[p] = make_quantum(gen, cls, n_in, rate, sig, device)
    walk = torch.randperm(P, generator=gen, device=device).tolist()
    return pool, walk
