"""Check the C layer's float32 formatter against numpy's Dragon4 on every
float32 bit pattern in a range (by default every finite float32 in [0, 1]:
1,065,353,217 values), over worker processes.

    python scripts/check_f32_format.py [--lo 0] [--hi 0x3f800000] [--workers N]

Prints the count, the mismatches (with the first few) and the time; exits
1 on any mismatch.
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK = 1 << 20


def _oracle(x: np.float32) -> str:
    if np.isnan(x):
        return "NaN"
    if np.isinf(x):
        return "inf" if x > 0 else "-inf"
    s = np.format_float_positional(x, unique=True, trim="-")
    return s[:-1] if s.endswith(".") else s


def check_chunk(bounds):
    """(values, mismatches, the first few as (bits, got, want)) of the bit
    patterns lo..hi-1."""
    sys.path.insert(0, ROOT)
    from panacus_torch import native

    lo, hi = bounds
    vals = np.arange(lo, hi, dtype=np.uint32).view(np.float32)
    got = native.format_f32_table(vals.reshape(1, -1), [""])[1:-1].split("\t")
    bad = [(int(b), g, _oracle(x)) for b, g, x in zip(range(lo, hi), got, vals) if g != _oracle(x)]
    return hi - lo, len(bad), bad[:5]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--lo", type=lambda s: int(s, 0), default=0)
    p.add_argument("--hi", type=lambda s: int(s, 0), default=0x3F800000, help="last pattern, included")
    p.add_argument("--workers", type=int, default=os.cpu_count() or 1)
    args = p.parse_args(argv)
    chunks = [(a, min(a + CHUNK, args.hi + 1)) for a in range(args.lo, args.hi + 1, CHUNK)]
    t0 = time.perf_counter()
    n = mismatches = 0
    first = []
    with multiprocessing.get_context("spawn").Pool(args.workers) as pool:
        for k, (count, bad, some) in enumerate(pool.imap_unordered(check_chunk, chunks)):
            n += count
            mismatches += bad
            first.extend(some)
            if k % 64 == 63:
                print(f"{k + 1}/{len(chunks)} chunks, {n} values, {mismatches} mismatches, "
                      f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(f"bits {args.lo:#x}..{args.hi:#x}: {n} values, {mismatches} mismatches, "
          f"{time.perf_counter() - t0:.1f} s with {args.workers} workers")
    for b, g, w in first[:10]:
        print(f"  {b:#010x}: got {g!r}, numpy {w!r}")
    return 1 if mismatches else 0


if __name__ == "__main__":
    sys.exit(main())
