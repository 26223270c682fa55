#!/usr/bin/env python3
"""Host time of the port's mp3 decode against the JAX package's on one file.

    python tools/mp3_decode_time.py [FILE.mp3] [--runs N]

Times knnsvc_torch.io.mp3.decode_mp3 (the clean-room decoder,
csrc/mp3dec.cc) and knnsvc_tpu.io.mp3.decode_mp3 (pygame's SDL_mixer over
libmpg123) in turns, after one untimed call of each, and prints the minimum
and median of each and their ratio. The default file is the 30-s 44.1-kHz
stereo fixture of chip_smoke.py's [mp3] phase. Needs pygame, so it runs
where the JAX package's decoder does, not on the card's machine.
"""

from __future__ import annotations

import argparse
import os
import platform
import statistics
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT = os.path.join(REPO, "tests", "torch_data", "mp3_ref_44k_stereo_128k.mp3")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("path", nargs="?", default=DEFAULT)
    parser.add_argument("--runs", type=int, default=9)
    args = parser.parse_args()
    sys.path.insert(0, REPO)
    from knnsvc_torch.io import mp3 as port
    from knnsvc_tpu.io import mp3 as jax_mp3

    decoders = {"port": port.decode_mp3, "jax": jax_mp3.decode_mp3}
    for fn in decoders.values():
        fn(args.path)
    times = {name: [] for name in decoders}
    for _ in range(args.runs):
        for name, fn in decoders.items():
            t0 = time.perf_counter()
            x, sr = fn(args.path)
            times[name].append(time.perf_counter() - t0)
    seconds = x.shape[1] / sr
    print(f"{os.path.relpath(args.path, REPO)}: {seconds:.2f} s at {sr} Hz x {x.shape[0]}, "
          f"{args.runs} runs each in turns on {platform.processor() or platform.machine()}, "
          f"{os.cpu_count()} CPUs")
    for name, ts in times.items():
        print(f"{name}: min {1e3 * min(ts):.1f} ms, median {1e3 * statistics.median(ts):.1f} ms")
    print(f"port / jax: min {min(times['port']) / min(times['jax']):.2f}x, median "
          f"{statistics.median(times['port']) / statistics.median(times['jax']):.2f}x")
    return 0


if __name__ == "__main__":
    sys.exit(main())
