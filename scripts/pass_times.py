#!/usr/bin/env python
"""Per-pass (Z/Y/X) wall times of one full solve denoise, ON HARDWARE.

The Z pass sees near-constant in-plane flows (global drift), while the
Y/X passes' planes span the drift axis, so their flow fields vary along
rows and the dyn kernels sample more shifts.  This prints the split so
pass-level regressions are attributable.

  python scripts/pass_times.py [--n 256]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=256)
    args = ap.parse_args()

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
    from flowdenoising_tpu.core.pipeline import denoise

    n = args.n
    vol = jax.device_put(jnp.asarray(benchmod.make_volume(n, n, n, seed=0)))
    cfg = FilterConfig(sigma=(2.0,) * 3, boundary=Boundary.WRAP,
                       flow=FlowConfig(levels=3, winsize=5,
                                       use_initial_flow=True))

    # Per-pass wall: run denoise 0..i passes via start_pass trick is resume
    # semantics, not timing; instead use on_pass to force sync points.
    times = []

    def on_pass(i, out):
        out.block_until_ready()
        times.append((i, time.perf_counter()))

    # warmup (compiles all three pass layouts)
    jax.block_until_ready(denoise(vol, cfg))
    for rep in range(2):
        times.clear()
        t0 = time.perf_counter()
        jax.block_until_ready(denoise(vol, cfg, on_pass=on_pass))
        t_end = time.perf_counter()
        prev = t0
        for i, t in enumerate(times):
            print(f"  pass {'ZYX'[i]}: {t[1] - prev:7.3f}s", flush=True)
            prev = t[1]
        print(f"  total: {t_end - t0:7.3f}s (incl. per-pass sync overhead)",
              flush=True)


if __name__ == "__main__":
    main()
