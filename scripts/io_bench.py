#!/usr/bin/env python
"""Host I/O benchmark: native libfdio MRC path vs the NumPy fallback.

Measures, at a given volume size (default 512^3):
  - read float32 MRC: read_mrc (NumPy) vs read_mrc_f32 (native fused decode)
  - read int16 MRC with f32 convert: NumPy fromfile+astype vs native fused
  - write float32 MRC: native streamed write vs NumPy tofile fallback

The reference delegates all of this to ``mrcfile`` (Python + NumPy,
/root/reference/src/flowdenoising.py:466-475,541-545); the native path is
this package's C++ runtime (flowdenoising_tpu/runtime/native).

Usage: python scripts/io_bench.py [--size 512] [--reps 3]
"""

import argparse
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from flowdenoising_tpu.io import mrc
from flowdenoising_tpu import runtime


def drop_cache_hint(path):
    """Advise the kernel to drop the page cache for ``path`` (best effort —
    POSIX_FADV_DONTNEED needs no privileges).  Keeps reads comparable."""
    try:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        finally:
            os.close(fd)
    except (AttributeError, OSError):
        pass


def best_of(reps, fn, *args, cold_path=None):
    best = float("inf")
    for _ in range(reps):
        if cold_path:
            drop_cache_hint(cold_path)
        t0 = time.perf_counter()
        fn(*args)
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--warm", action="store_true",
                    help="skip the page-cache drop between reps (measures "
                    "decode cost, not disk)")
    args = ap.parse_args()
    n = args.size
    nbytes_f32 = n * n * n * 4

    print(f"volume {n}^3  f32 payload {nbytes_f32 / 1e9:.2f} GB  "
          f"native runtime available: {runtime.native_available()}")

    rng = np.random.default_rng(0)
    vol_f32 = rng.normal(scale=100.0, size=(n, n, n)).astype(np.float32)
    vol_i16 = (vol_f32 / 2).astype(np.int16)

    with tempfile.TemporaryDirectory() as td:
        p32 = os.path.join(td, "v32.mrc")
        p16 = os.path.join(td, "v16.mrc")
        mrc.write_mrc(p32, vol_f32)
        mrc.write_mrc(p16, vol_i16)
        cold32 = None if args.warm else p32
        cold16 = None if args.warm else p16

        rows = []

        # --- read f32 ---
        dt_np = best_of(args.reps, lambda: mrc.read_mrc(p32)[0].astype(np.float32),
                        cold_path=cold32)
        dt_nat = best_of(args.reps, lambda: mrc.read_mrc_f32(p32),
                         cold_path=cold32)
        rows.append(("read f32 -> f32", dt_np, dt_nat))

        # --- read i16 -> f32 (fused convert) ---
        dt_np = best_of(args.reps, lambda: mrc.read_mrc(p16)[0].astype(np.float32),
                        cold_path=cold16)
        dt_nat = best_of(args.reps, lambda: mrc.read_mrc_f32(p16),
                         cold_path=cold16)
        rows.append(("read i16 -> f32", dt_np, dt_nat))

        # --- write f32: native streamed vs tofile fallback ---
        # Interleaved best-of with a sync between reps: disk writeback on
        # this host swings raw write timings by >10x, so back-to-back
        # single-path timing is meaningless (the second path inherits the
        # first one's dirty pages).
        out = os.path.join(td, "out.mrc")

        def write_native():
            mrc.write_mrc(out, vol_f32)

        def write_numpy():
            # same code path with the native write disabled
            orig = runtime.write_raw
            runtime.write_raw = lambda *a, **k: False
            try:
                mrc.write_mrc(out, vol_f32)
            finally:
                runtime.write_raw = orig

        dt_np = dt_nat = float("inf")
        for _ in range(args.reps):
            for which, fn in (("np", write_numpy), ("nat", write_native)):
                os.sync()
                t0 = time.perf_counter()
                fn()
                dt = time.perf_counter() - t0
                if which == "np":
                    dt_np = min(dt_np, dt)
                else:
                    dt_nat = min(dt_nat, dt)
        rows.append(("write f32 (incl. stats)", dt_np, dt_nat))

        gb = nbytes_f32 / 1e9
        print(f"{'op':28s} {'numpy_s':>9s} {'native_s':>9s} "
              f"{'np_GB/s':>8s} {'nat_GB/s':>9s} {'speedup':>8s}")
        for name, a, b in rows:
            print(f"{name:28s} {a:9.3f} {b:9.3f} {gb / a:8.2f} {gb / b:9.2f} "
                  f"{a / b:7.2f}x")


if __name__ == "__main__":
    main()
