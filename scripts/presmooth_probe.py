#!/usr/bin/env python
"""Measure FlowConfig.presmooth's effect on the noisy first pass, ON HARDWARE.

Per-pixel flow noise is what keeps the fused iteration kernels' y-shift trip
counts high on the noisy input pass (BASELINE.md: headline Z pass 166.6 s vs
Y/X 24.7/20.6 s).  This times one Z pass of the bench volume at several
estimation-presmooth sigmas, plus the full 3-pass denoise, and reports the
output divergence vs the presmooth=0 baseline.

  python scripts/presmooth_probe.py [--n 256] [--sigmas 0,0.75,1.0,1.5,2.0]
"""
import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def psnr(a, b, peak=None):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    peak = peak if peak is not None else (a.max() - a.min())
    mse = np.mean((a - b) ** 2)
    return 10 * np.log10(peak * peak / mse) if mse else np.inf


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--sigmas", type=str, default="0,0.75,1.0,1.5,2.0")
    ap.add_argument("--full", action="store_true",
                    help="also time the full 3-pass denoise per sigma")
    args = ap.parse_args()
    sigmas = [float(s) for s in args.sigmas.split(",")]

    from flowdenoising_tpu.utils.compile_cache import enable_compilation_cache
    enable_compilation_cache()
    import jax
    import jax.numpy as jnp
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "benchmod", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "bench.py"))
    benchmod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(benchmod)
    from flowdenoising_tpu.config import Boundary, FilterConfig, FlowConfig
    from flowdenoising_tpu.core.axis_filter import of_pass_padded, pad_stack
    from flowdenoising_tpu.core.pipeline import denoise
    from flowdenoising_tpu.kernels import get_gaussian_kernels

    n = args.n
    vol = jax.device_put(jnp.asarray(benchmod.make_volume(n, n, n, seed=0)))
    taps = get_gaussian_kernels((2.0, 2.0, 2.0))[0]
    ks2 = len(taps) // 2
    padded = pad_stack(vol, ks2, Boundary.WRAP)
    padded.block_until_ready()

    base_out = None
    for s in sigmas:
        fc = FlowConfig(levels=3, winsize=5, presmooth=s)

        @jax.jit
        def zpass(p):
            return of_pass_padded(p, taps, fc)

        sync = jax.block_until_ready

        out = zpass(padded)
        sync(out)  # compile + warm
        reps = []
        for _ in range(2):
            t0 = time.perf_counter()
            out = zpass(padded)
            sync(out)
            reps.append(time.perf_counter() - t0)
        t = min(reps)
        out_np = np.asarray(out)
        if base_out is None:
            base_out = out_np
            div = float("inf")
        else:
            div = psnr(base_out, out_np)
        print(f"presmooth={s:<5} Z-pass {t:7.3f} s   "
              f"PSNR vs s=0: {div:6.2f} dB", flush=True)

        if args.full:
            cfg = FilterConfig(sigma=(2.0,) * 3, boundary=Boundary.WRAP,
                               flow=fc)
            full = denoise(vol, cfg)
            sync(full)
            t0 = time.perf_counter()
            full = denoise(vol, cfg)
            sync(full)
            print(f"             full 3-pass {time.perf_counter() - t0:7.3f} s",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
