"""Command-line front-end: resample raw s16 PCM files.

The functional equivalent of the reference's test/demo harness
(src/test.ts) as a user-facing tool, with the JAX package's CLI's flags
and printed text:

    speex-resampler-tpu-torch resample --channels 2 --in-rate 44100 \\
        --out-rate 48000 --quality 7 in.pcm out.pcm
    speex-resampler-tpu-torch info --in-rate 44100 --out-rate 48000 -q 7
    python -m speex_resampler_tpu_torch.cli presets
"""

from __future__ import annotations

import argparse
import math
import sys
import time


def _add_common(p):
    p.add_argument("--channels", "-c", type=int, default=2)
    p.add_argument("--in-rate", "-i", type=int, required=True)
    p.add_argument("--out-rate", "-o", type=int, required=True)
    p.add_argument("--quality", "-q", type=int, default=7)
    p.add_argument("--fixed-point", action="store_true",
                   help="use the FIXED_POINT (Q15 integer) build universe")
    p.add_argument("--exact", action="store_true",
                   help="order-faithful mode: output bit-identical to the "
                        "reference float build (host hot loops)")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="speex-resampler-tpu-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    rp = sub.add_parser("resample", help="resample a raw s16 PCM file")
    _add_common(rp)
    rp.add_argument("--chunk-frames", type=int, default=0,
                    help="stream in chunks of this many frames (0 = one shot)")
    rp.add_argument("--skip-zeros", action="store_true",
                    help="swallow the leading filter delay")
    rp.add_argument("infile")
    rp.add_argument("outfile")

    ip = sub.add_parser("info", help="print filter design for a config")
    _add_common(ip)

    pp = sub.add_parser("presets",
                        help="list operating-point presets for a rate pair")
    pp.add_argument("--in-rate", "-i", type=int, default=44100)
    pp.add_argument("--out-rate", "-o", type=int, default=48000)

    args = ap.parse_args(argv)

    if args.cmd == "presets":
        from .models.presets import PRESETS, describe
        for name in PRESETS:
            d = describe(name, args.in_rate, args.out_rate)
            hard = " (HARD cap)" if d["hard_latency"] else ""
            print(f"{name:10s} q{d['quality']:<2d} "
                  f"launch {d['launch_ms']:6.1f} ms{hard}  "
                  f"taps {d['filter_taps']:<4d} {d['path']:<12s} "
                  f"latency in/out {d['input_latency_ms']:.1f}/"
                  f"{d['output_latency_ms']:.1f} ms  — "
                  f"{PRESETS[name].description}")
        return 0

    if args.cmd == "info":
        from .ops import filter_design as fd
        g = math.gcd(args.in_rate, args.out_rate)
        spec = fd.design_filter(args.in_rate // g, args.out_rate // g,
                                args.quality,
                                fixed_point=args.fixed_point)
        print(f"universe     {'fixed (Q15)' if args.fixed_point else 'float'}")
        print(f"ratio        {spec.num}/{spec.den}")
        print(f"filt_len     {spec.filt_len}")
        print(f"path         {'direct' if spec.use_direct else 'interpolated'}")
        print(f"oversample   {spec.oversample}")
        print(f"cutoff       {spec.cutoff:.6f}")
        print(f"in latency   {spec.input_latency} samples")
        print(f"out latency  {spec.output_latency} samples")
        return 0

    from .api import SpeexResampler
    data = open(args.infile, "rb").read()
    r = SpeexResampler(args.channels, args.in_rate, args.out_rate,
                       args.quality, fixed_point=args.fixed_point,
                       exact=args.exact)
    if args.skip_zeros:
        r._ensure_core().skip_zeros()
    frame_bytes = args.channels * 2
    t0 = time.perf_counter()
    with open(args.outfile, "wb") as out:
        if args.chunk_frames <= 0:
            out.write(r.process_chunk(data))
        else:
            step = args.chunk_frames * frame_bytes
            for pos in range(0, len(data) - len(data) % frame_bytes, step):
                out.write(r.process_chunk(
                    data[pos:min(pos + step,
                                 len(data) - len(data) % frame_bytes)]))
    dt = time.perf_counter() - t0
    in_s = len(data) / frame_bytes / args.in_rate
    print(f"{in_s:.2f}s of audio in {dt*1e3:.0f} ms "
          f"({in_s/dt:.1f}x realtime, single stream)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
