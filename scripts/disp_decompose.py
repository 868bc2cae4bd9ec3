#!/usr/bin/env python
"""Decompose the membranes-tier parity gap: clamping vs algorithm.

QUALITY.md round 3 shows parity mode trailing the cv2 oracle by 0.2-0.8 dB
PSNR on the membranes (FIB-SEM-like) tiers.  Two candidate causes:

  (a) the sampling kernels' displacement bound D clamps real motion that
      cv2's calcOpticalFlowFarneback follows unboundedly
      (/root/reference/src/flowdenoising.py:69-79), or
  (b) a residual mismatch in the Farneback port itself (border band,
      min_size level clamp, seeded-chain divergence across taps).

This script separates them: for each membranes tier it runs the f32 solve
(parity) pipeline across a D ladder ENDING AT UNBOUNDED (max_displacement
None -> exact gather path, no clamping anywhere).  If unbounded reaches the
cv2 output, the gap is (a) and autodisp needs tightening; if a gap remains
at unbounded, it is (b) and needs a per-tap flow bisection.

Usage: python scripts/disp_decompose.py [--noises 15 30 60] [-n 32 --hw 128]
"""

import argparse
import dataclasses
import sys
import time

import numpy as np

sys.path.insert(0, ".")
sys.path.insert(0, "tests")
sys.path.insert(0, "scripts")

from flowdenoising_tpu.config import Boundary, FilterConfig, FlowConfig
from flowdenoising_tpu.kernels import get_gaussian_kernels
from flowdenoising_tpu.utils.metrics import psnr, ssim


def main():
    from flowdenoising_tpu.utils.compile_cache import enable_compilation_cache
    enable_compilation_cache()
    p = argparse.ArgumentParser()
    p.add_argument("-n", type=int, default=32)
    p.add_argument("--hw", type=int, default=128)
    p.add_argument("--noises", type=float, nargs="+", default=[15.0, 30.0, 60.0])
    p.add_argument("--pattern", default="membranes")
    p.add_argument("--ladder", type=int, nargs="+", default=[8, 12, 16, 24, 32])
    args = p.parse_args()

    import jax
    import jax.numpy as jnp
    import ref_pipeline as R
    from quality_eval import PATTERNS
    from flowdenoising_tpu.core.pipeline import denoise

    clean = PATTERNS[args.pattern](args.n, args.hw, args.hw, seed=0)
    sig = (2.0,) * 3
    kernels = get_gaussian_kernels(sig)
    L, W = 3, 5

    ds = list(args.ladder) + [None]
    jits = {}
    for d in ds:
        cfg = FilterConfig(sigma=sig, boundary=Boundary.WRAP,
                           flow=FlowConfig(levels=L, winsize=W,
                                           max_displacement=d))
        jits[d] = jax.jit(lambda x, c=cfg: denoise(x, c))

    for noise in args.noises:
        rng = np.random.default_rng(1234 + int(noise))
        noisy = clean + rng.normal(scale=noise, size=clean.shape).astype(np.float32)
        t0 = time.perf_counter()
        ref_out = R.of_denoise_wrap(noisy, kernels, L, W, seeded=True)
        t_ref = time.perf_counter() - t0
        print(f"\n== {args.pattern} {args.n}x{args.hw}x{args.hw} "
              f"noise={noise} | cv2 ref: {t_ref:.1f}s "
              f"PSNR {psnr(clean, ref_out):.2f} dB SSIM {ssim(clean, ref_out):.4f}",
              flush=True)
        v = jax.device_put(jnp.asarray(noisy))
        for d in ds:
            jax.block_until_ready(jits[d](v))
            t0 = time.perf_counter()
            out = jax.block_until_ready(jits[d](v))
            dt = time.perf_counter() - t0
            out = np.asarray(out)
            print(f"  D={'unbounded' if d is None else d:>9}: {dt:6.2f}s  "
                  f"PSNR {psnr(clean, out):.2f} dB  SSIM {ssim(clean, out):.4f}  "
                  f"cross-PSNR vs cv2 {psnr(ref_out, out):.2f} dB", flush=True)


if __name__ == "__main__":
    main()
