#!/usr/bin/env python
"""Quality parity evaluation: the JAX pipeline vs the cv2 reference algorithm.

Round-2 scope (VERDICT "Next round" #8): two volume classes -- smooth blob
fields AND textured structures (curved membrane sheets + filaments, the
morphology of FIB-SEM biological volumes the method paper targets) -- at
multiple noise levels, evaluated for PSNR/SSIM vs clean and cross-PSNR vs
the cv2 reference output for the parity mode and every fast mode.

Run on the GPU host:
  python scripts/quality_eval.py                 # standard tier (32x128x128)
  python scripts/quality_eval.py --big           # adds a 128x256x256 tier
"""

import argparse
import sys
import time

import numpy as np

sys.path.insert(0, ".")
sys.path.insert(0, "tests")

from flowdenoising_tpu.config import Boundary, FilterConfig, FlowConfig
from flowdenoising_tpu.kernels import get_gaussian_kernels
from flowdenoising_tpu.utils.metrics import psnr, ssim


def make_blobs(n, h, w, seed=0):
    import importlib.util
    spec = importlib.util.spec_from_file_location("mtv", "scripts/make_test_volume.py")
    mtv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mtv)
    return mtv.make_volume(n, h, w, seed=seed, noise=0.0)


def make_membranes(n, h, w, seed=0):
    """Textured FIB-SEM-like phantom: curved membrane sheets and filament
    tubes drifting smoothly with Z, over a mid-gray cytoplasm background.

    Membranes are thin bright curves y = f(x) per slice (smooth in x and z);
    filaments are bright points sweeping smooth 3-D trajectories.  Both
    carry structure at the ~2-px scale the Gaussian would destroy without
    OF compensation, which is exactly the regime the method paper evaluates
    (structure-preserving denoising of FIB-SEM).
    """
    rng = np.random.default_rng(seed)
    xs = np.arange(w, dtype=np.float32)
    vol = np.full((n, h, w), 80.0, np.float32)
    # global drift path (what the OF must track)
    dz = np.cumsum(rng.uniform(-0.7, 0.7, size=n)).astype(np.float32)
    dy = np.cumsum(rng.uniform(-0.7, 0.7, size=n)).astype(np.float32)

    n_mem = 6
    for k in range(n_mem):
        y0 = rng.uniform(0.1 * h, 0.9 * h)
        amp = rng.uniform(3, 12)
        wl = rng.uniform(0.5 * w, 2.0 * w)
        ph = rng.uniform(0, 2 * np.pi)
        thick = rng.uniform(1.2, 2.5)
        bright = rng.uniform(60, 140)
        zwl = rng.uniform(2 * n, 6 * n)
        for z in range(n):
            yc = (y0 + amp * np.sin(2 * np.pi * xs / wl + ph
                                    + 2 * np.pi * z / zwl) + dy[z])
            yy = np.arange(h, dtype=np.float32)[:, None]
            vol[z] += bright * np.exp(-((yy - yc[None, :]) ** 2)
                                      / (2 * thick * thick))

    n_fil = 10
    for k in range(n_fil):
        cy = rng.uniform(0, h)
        cx = rng.uniform(0, w)
        vy = rng.uniform(-1.5, 1.5)
        vx = rng.uniform(-1.5, 1.5)
        rad = rng.uniform(1.5, 3.0)
        bright = rng.uniform(80, 160)
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        for z in range(n):
            py = (cy + vy * z + dy[z]) % h
            px = (cx + vx * z + dz[z]) % w
            vol[z] += bright * np.exp(-(((yy - py) ** 2 + (xx - px) ** 2))
                                      / (2 * rad * rad))
    return vol


PATTERNS = {"blobs": make_blobs, "membranes": make_membranes}


def eval_tier(pattern, n, hw, noises, sigma, skip_reference, lines):
    clean = PATTERNS[pattern](n, hw, hw, seed=0)
    sig = (sigma,) * 3
    kernels = get_gaussian_kernels(sig)
    L, W = 3, 5

    import jax
    import jax.numpy as jnp
    from flowdenoising_tpu.core.pipeline import denoise

    configs = [
        ("f32 solve (parity mode)", dict()),
        ("f32 solve presmooth=1.5", dict(presmooth=1.5)),
        ("f32 solve presmooth=2.5", dict(presmooth=2.5)),
        ("f32 compose", dict(tap_mode="compose")),
        ("f32 compose symmetric", dict(tap_mode="compose",
                                       symmetric_adjacent=True)),
        ("f32 compose sym presmooth=1.5",
         dict(tap_mode="compose", symmetric_adjacent=True, presmooth=1.5)),
    ]
    # Unbounded row: direct on probe-scale tiers; on the big tier it runs
    # through denoise_streamed, a HOST-driven slab loop whose every
    # dispatch covers 16 output slices ("_stream" key), to keep each
    # device program short.
    if n * hw * hw <= 2 ** 21:
        configs.insert(1, ("f32 solve unbounded (--max_displacement 0)",
                           dict(max_displacement=None)))
    else:
        configs.insert(1, ("f32 solve unbounded (--max_displacement 0, "
                           "streamed slab 16)",
                           dict(max_displacement=None, _stream=16)))
    # One jitted executable per config, shared across all noise levels
    # (shapes are identical) -- without this, each (config, noise) pair
    # recompiles and the evaluation is compile-bound.
    jits = {}
    auto_jits = {}
    for name, over in configs:
        over = dict(over)
        stream_slab = over.pop("_stream", None)
        cfg = FilterConfig(sigma=sig, boundary=Boundary.WRAP,
                           flow=FlowConfig(levels=L, winsize=W, **over))
        if stream_slab:
            from flowdenoising_tpu.core.stream import denoise_streamed
            jits[name] = (lambda x, c=cfg, s=stream_slab:
                          jnp.asarray(denoise_streamed(
                              np.asarray(x), c, slab_size=s)))
        else:
            jits[name] = jax.jit(lambda x, c=cfg: denoise(x, c))

    for noise in noises:
        rng = np.random.default_rng(1234 + int(noise))
        noisy = clean + rng.normal(scale=noise, size=clean.shape).astype(np.float32)
        lines += [
            "",
            f"## {pattern} {n}x{hw}x{hw}, noise sigma={noise}",
            "",
            f"Noisy input: PSNR {psnr(clean, noisy):.2f} dB, "
            f"SSIM {ssim(clean, noisy):.4f} vs clean.",
            "",
            "| Pipeline | time (s) | PSNR vs clean | SSIM vs clean | PSNR vs cv2 ref |",
            "|---|---|---|---|---|",
        ]
        ref_out = None
        if not skip_reference:
            import ref_pipeline as R
            t0 = time.perf_counter()
            ref_out = R.of_denoise_wrap(noisy, kernels, L, W, seeded=True)
            t_ref = time.perf_counter() - t0
            lines.append(f"| cv2 reference (1-core) | {t_ref:.2f} | "
                         f"{psnr(clean, ref_out):.2f} dB | "
                         f"{ssim(clean, ref_out):.4f} | -- |")

        # Auto displacement bound: resolved per noisy volume (the probe
        # measures the clamp cost on the actual data, core/autodisp.py);
        # jitted executables cached by the resolved bounds.
        from flowdenoising_tpu.core.autodisp import resolve_auto_displacement
        base_auto = FilterConfig(sigma=sig, boundary=Boundary.WRAP,
                                 flow=FlowConfig(levels=L, winsize=W))
        t0 = time.perf_counter()
        rcfg = resolve_auto_displacement(noisy, base_auto)
        t_probe = time.perf_counter() - t0
        key = (rcfg.flow.max_displacement, rcfg.flow.adjacent_displacement)
        auto_name = f"f32 solve auto (picked D={key[0]}, probe {t_probe:.2f}s)"
        if key not in auto_jits:
            auto_jits[key] = jax.jit(lambda x, c=rcfg: denoise(x, c))
        run_list = configs + [(auto_name, None)]

        v = jax.device_put(jnp.asarray(noisy))
        rows = {}
        for name, over in run_list:
            jfn = auto_jits[key] if over is None else jits[name]
            jax.block_until_ready(jfn(v))
            t0 = time.perf_counter()
            out = jax.block_until_ready(jfn(v))
            dt = time.perf_counter() - t0
            out = np.asarray(out)
            cross = "--" if ref_out is None else f"{psnr(ref_out, out):.2f} dB"
            rows[name] = (dt, psnr(clean, out), ssim(clean, out), cross)
            lines.append(f"| {name} | {dt:.2f} | {psnr(clean, out):.2f} dB | "
                         f"{ssim(clean, out):.4f} | {cross} |")

        # Auto-presmooth POLICY row (core/noise.py): report the measured rel
        # and the picked setting's metrics, so boundary tiers (rel ~ 0.4-0.5)
        # show what the decision costs against the better alternative.
        from flowdenoising_tpu.core.noise import (
            _noise_and_spread, resolve_auto_presmooth)
        base_ps = FilterConfig(sigma=sig, boundary=Boundary.WRAP,
                               flow=FlowConfig(levels=L, winsize=W))
        ps = resolve_auto_presmooth(noisy, base_ps).flow.presmooth
        sn, ts = _noise_and_spread(noisy)
        rel = sn / max(np.sqrt(max(ts ** 2 - sn ** 2, 1e-12)), 1e-12)
        pick = ("f32 solve (parity mode)" if ps == 0
                else "f32 solve presmooth=1.5")
        if pick in rows:
            dt, p, s, cross = rows[pick]
            lines.append(f"| f32 solve presmooth=auto (rel={rel:.2f} -> "
                         f"ps={ps}) | {dt:.2f} | {p:.2f} dB | {s:.4f} | "
                         f"{cross} |")
        print("\n".join(lines[-12:]), flush=True)


def main():
    from flowdenoising_tpu.utils.compile_cache import enable_compilation_cache
    enable_compilation_cache()
    p = argparse.ArgumentParser()
    p.add_argument("-n", type=int, default=32)
    p.add_argument("--hw", type=int, default=128)
    p.add_argument("--sigma", type=float, default=2.0)
    p.add_argument("--noises", type=float, nargs="+", default=[15.0, 30.0, 60.0])
    p.add_argument("--patterns", nargs="+", default=["blobs", "membranes"])
    p.add_argument("--big", action="store_true",
                   help="add a 128x256x256 tier (single noise level)")
    p.add_argument("--boundary", action="store_true",
                   help="add tiers engineered at the auto-presmooth "
                        "decision boundary (rel ~ 0.40 / 0.50)")
    p.add_argument("--skip-reference", action="store_true")
    p.add_argument("-o", "--output", default="QUALITY.md")
    args = p.parse_args()

    lines = [
        "# Quality parity evaluation",
        "",
        f"Filter sigma={args.sigma} (17 taps/axis), levels=3, winsize=5, wrap "
        "boundary, seeded flow chaining -- the reference main-CLI defaults.  "
        "Reference = cv2-based oracle (tests/ref_pipeline.py), bit-matching "
        "the reference algorithm's semantics.",
        "",
        "Round-4 findings baked into these tables:",
        "",
        "- **The membranes parity gap was 100% displacement clamping, not an "
        "algorithm mismatch**: the `unbounded (--max_displacement 0)` row "
        "matches the cv2 oracle to 74-82 dB cross-PSNR and identical "
        "PSNR-vs-clean on every membranes tier (full D ladder: "
        "scripts/disp_decompose.py; D=32 is within 0.04 dB of unbounded at "
        "~1/70th its cost).  `--max_displacement auto` now sizes the bound "
        "from clamp-cost curves normalized by the flow's tracking benefit "
        "(core/autodisp.py), picking D=24-32 on these volumes.",
        "- **Auto-presmooth boundary tiers** (rel ~ 0.40 / 0.50, "
        "engineered): the decision boundary is content-ambiguous -- at "
        "rel=0.50 presmooth wins on blobs (+0.13 dB, +0.025 SSIM) but "
        "costs PSNR on membranes (-0.35 dB, +0.002 SSIM).  The policy's "
        "worst boundary penalty is 0.35 dB PSNR with SSIM never below "
        "the alternative; `_REL_THRESHOLD=0.45` sits between the "
        "measured regimes (core/noise.py).",
        "- **The big membranes tier now carries the unbounded row** "
        "(streamed 16-slice slabs keep every device dispatch short): "
        "unbounded = cv2 exactly (32.51 dB, 60.4 dB cross-PSNR), and "
        "`auto` (D=48) lands on the same 32.51 dB -- the clamping "
        "decomposition is uniform across all tiers.",
        "- **compose_refine was REMOVED in v0.5.0**: a measured "
        "trust-region ladder (round 4, clip 0/0.5/0.75/1.5 px, 1-2 "
        "iterations) found no setting that lifts it to >= plain compose "
        "everywhere; its correction direction is noise-driven.  Best case "
        "+0.1 dB (membranes n60), worst -0.24 dB (blobs n60), at ~2x "
        "compose's cost.",
    ]
    for pattern in args.patterns:
        eval_tier(pattern, args.n, args.hw, args.noises, args.sigma,
                  args.skip_reference, lines)
    if args.boundary:
        # Tiers engineered to straddle the auto-presmooth decision boundary
        # (_REL_THRESHOLD=0.45, core/noise.py): noise sigma chosen as a
        # fraction of each clean volume's spread so the measured rel lands
        # ~0.40 / ~0.50 (previously unprobed, VERDICT r4 weak #4).
        for pattern in ("membranes", "blobs"):
            s = float(PATTERNS[pattern](args.n, args.hw, args.hw,
                                        seed=0).std())
            eval_tier(pattern, args.n, args.hw,
                      [round(0.40 * s, 1), round(0.50 * s, 1)], args.sigma,
                      args.skip_reference, lines)
    if args.big:
        eval_tier("membranes", 128, 256, [30.0], args.sigma,
                  args.skip_reference, lines)

    with open(args.output, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"\nwrote {args.output}")


if __name__ == "__main__":
    main()
