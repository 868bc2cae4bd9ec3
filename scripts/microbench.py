#!/usr/bin/env python
"""Per-op device timings of the flow path, as plain XLA.

Times, at the shapes the pipeline runs (512x512 planes, a batch of slices):

- bounded-displacement bilinear sampling (ops.warp.displace_sample) of
  the 5-channel Farneback reference expansion and of 1-channel tap warps,
  for several displacement bounds D;
- one Farneback iteration at pyramid level 0, split into update_matrices
  (UM) then update_flow (UF);
- one compose tap step (core.axis_filter.compose_tap_step);
- the whole single-device denoise (solve and compose tap modes).

Each op runs ``--reps`` times inside one jitted scan, so dispatch overhead
amortizes away; the best of ``--outer`` timed calls is reported per op, in
milliseconds per application.  Prints one JSON object per measurement.

  python scripts/microbench.py [--batch 32] [--size 512] [--sections all]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def timed_scan(step, init, *consts, reps=8, outer=3):
    """Best per-application seconds of ``reps`` sequential applications of
    ``step(carry, *consts)`` inside one jit."""
    import jax

    @jax.jit
    def many(x, *cs):
        def body(c, _):
            return step(c, *cs), None
        out, _ = jax.lax.scan(body, x, None, length=reps)
        return out

    jax.block_until_ready(many(init, *consts))
    best = float("inf")
    for _ in range(outer):
        t0 = time.perf_counter()
        jax.block_until_ready(many(init, *consts))
        best = min(best, time.perf_counter() - t0)
    return best / reps


def timed_call(fn, *args, outer=3):
    import jax
    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(outer):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def emit(rec):
    print(json.dumps(rec), flush=True)


def noisy_flow(rng, shape, std=1.4):
    """Flow with the per-pixel noise the bench volume's solves show."""
    return rng.normal(scale=std, size=shape).astype(np.float32)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--outer", type=int, default=3)
    ap.add_argument("--sections", default="all",
                    help="comma list of samplers,iteration,compose,e2e")
    args = ap.parse_args()
    sections = ({"samplers", "iteration", "compose", "e2e"}
                if args.sections == "all" else set(args.sections.split(",")))

    from flowdenoising_tpu.utils.compile_cache import enable_compilation_cache
    enable_compilation_cache()
    import jax
    import jax.numpy as jnp
    from flowdenoising_tpu.config import FilterConfig, FlowConfig
    from flowdenoising_tpu.core.axis_filter import compose_tap_step
    from flowdenoising_tpu.ops.farneback import (
        _level_displacement, poly_expand, update_flow, update_matrices)
    from flowdenoising_tpu.ops.warp import displace_sample

    dev = jax.devices()[0]
    emit({"device": {"platform": dev.platform, "kind": dev.device_kind,
                     "count": len(jax.devices())},
          "batch": args.batch, "size": args.size, "reps": args.reps})
    b, n = args.batch, args.size
    rng = np.random.default_rng(0)
    img = jnp.asarray(rng.normal(size=(b, n, n)).astype(np.float32) * 50)
    flow = jnp.asarray(noisy_flow(rng, (b, n, n, 2)))
    cfg = FlowConfig()

    if "samplers" in sections:
        r1 = jax.jit(lambda x: poly_expand(x, cfg.poly_n, cfg.poly_sigma))(img)
        for d in (4, 8, 24):
            t5 = timed_scan(
                lambda r, f: r + 1e-3 * displace_sample(
                    r, f[..., 0], f[..., 1], d, channels_last=True),
                r1, flow, reps=args.reps, outer=args.outer)
            t1 = timed_scan(
                lambda s, f: s + 1e-3 * displace_sample(
                    s, f[..., 0], f[..., 1], d),
                img, flow, reps=args.reps, outer=args.outer)
            emit({"op": "displace_sample", "d": d,
                  "ms_5ch": round(t5 * 1e3, 4), "ms_1ch": round(t1 * 1e3, 4)})

    if "iteration" in sections:
        r0 = jax.jit(lambda x: poly_expand(x, cfg.poly_n, cfg.poly_sigma))(img)
        r1 = r0 + 0.01
        d0 = _level_displacement(cfg, 0)
        t_um = timed_scan(
            lambda f, a, c: f + 1e-6 * update_matrices(a, c, f, d0)[..., :2],
            flow, r0, r1, reps=args.reps, outer=args.outer)
        m0 = jax.jit(lambda f, a, c: update_matrices(a, c, f, d0))(
            flow, r0, r1)
        t_uf = timed_scan(
            lambda m: m + 1e-6 * jnp.pad(update_flow(m, cfg.winsize),
                                         [(0, 0)] * 3 + [(0, 3)]),
            m0, reps=args.reps, outer=args.outer)
        t_it = timed_scan(
            lambda f, a, c: update_flow(update_matrices(a, c, f, d0),
                                        cfg.winsize),
            flow, r0, r1, reps=args.reps, outer=args.outer)
        emit({"op": "farneback_iteration_L0", "d": d0,
              "ms_um": round(t_um * 1e3, 4), "ms_uf": round(t_uf * 1e3, 4),
              "ms_um_then_uf": round(t_it * 1e3, 4)})

    if "compose" in sections:
        link = jnp.asarray(noisy_flow(rng, (b, n, n, 2), std=0.3))
        d = cfg.max_displacement
        t = timed_scan(
            lambda c, lk, nb: compose_tap_step(lk, c[0], nb, c[1], 0.05, d),
            (jnp.zeros_like(flow), jnp.zeros_like(img)), link, img,
            reps=args.reps, outer=args.outer)
        emit({"op": "compose_tap_step", "d": d, "ms": round(t * 1e3, 4)})

    if "e2e" in sections:
        import dataclasses
        from flowdenoising_tpu.core.pipeline import denoise
        sys.path.insert(0, os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        from bench import make_volume
        vol = jnp.asarray(make_volume(b, n, n, seed=0))
        for tap_mode in ("solve", "compose"):
            fcfg = FilterConfig(flow=dataclasses.replace(
                FlowConfig(), tap_mode=tap_mode))
            t = timed_call(jax.jit(lambda v, c=fcfg: denoise(v, c)), vol,
                           outer=2)
            emit({"op": "denoise", "tap_mode": tap_mode, "shape": [b, n, n],
                  "s": round(t, 4)})


if __name__ == "__main__":
    main()
