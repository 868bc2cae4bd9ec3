#!/usr/bin/env python
"""Measure shard_map overhead on ONE chip (VERDICT r3 missing #3).

`denoise_sharded(mesh=make_mesh(1))` runs the exact multi-chip program --
shard_map, ring ppermute halos (self-loops at N=1), pass-boundary sharding
constraints -- on a single device, so (sharded - plain)/plain is the pure
framework overhead of the sharded path, with zero interconnect cost.

The volume is generated ON-DEVICE (bench.device_volume), so no host
transfer enters the timing.

Usage: python scripts/sharded_overhead.py [--size 256] [--mode solve|fast]
"""

import argparse
import sys
import time

sys.path.insert(0, ".")


def sync(x):
    import jax
    jax.block_until_ready(x)


def main():
    from flowdenoising_tpu.utils.compile_cache import enable_compilation_cache
    enable_compilation_cache()
    p = argparse.ArgumentParser()
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--mode", default="solve", choices=["solve", "fast"])
    p.add_argument("--reps", type=int, default=3)
    args = p.parse_args()

    import jax
    from bench import device_volume
    from flowdenoising_tpu.config import Boundary, FilterConfig, FlowConfig
    from flowdenoising_tpu.core.pipeline import denoise
    from flowdenoising_tpu.parallel.mesh import denoise_sharded, make_mesh

    if args.mode == "solve":
        flow = FlowConfig(levels=3, winsize=5, use_initial_flow=True)
    else:
        flow = FlowConfig(levels=3, winsize=5, use_initial_flow=True,
                          precision="bfloat16", tap_mode="compose",
                          symmetric_adjacent=True)
    cfg = FilterConfig(sigma=(2.0,) * 3, boundary=Boundary.WRAP, flow=flow)

    s = args.size
    vol = device_volume(s, s, s, seed=0)

    jfn = jax.jit(lambda v: denoise(v, cfg))
    sync(jfn(vol))
    t_plain = min(_timed(jfn, vol) for _ in range(args.reps))
    print(f"plain denoise   {s}^3 {args.mode}: {t_plain:.3f}s", flush=True)

    mesh = make_mesh(1)
    sync(denoise_sharded(vol, cfg, mesh=mesh))
    best = float("inf")
    for _ in range(args.reps):
        t0 = time.perf_counter()
        sync(denoise_sharded(vol, cfg, mesh=mesh))
        best = min(best, time.perf_counter() - t0)
    print(f"sharded 1-chip  {s}^3 {args.mode}: {best:.3f}s "
          f"(overhead {100 * (best - t_plain) / t_plain:+.1f}%)", flush=True)


def _timed(jfn, vol):
    t0 = time.perf_counter()
    sync(jfn(vol))
    return time.perf_counter() - t0


if __name__ == "__main__":
    main()
