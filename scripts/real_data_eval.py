#!/usr/bin/env python
"""Real-data quality protocol (docs/REAL_DATA.md section 2).

Evaluates the JAX pipeline against the cv2 reference algorithm on a crop of
a REAL volume (no clean ground truth): cross-PSNR vs the cv2 oracle output,
structure-preservation stats, and volume-stats parity.

  python scripts/real_data_eval.py data/TS_026.mrc [--crop 64 256 256]
"""

import argparse
import sys
import time

import numpy as np

sys.path.insert(0, ".")
sys.path.insert(0, "tests")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("volume")
    ap.add_argument("--crop", type=int, nargs=3, default=(64, 256, 256),
                    metavar=("Z", "Y", "X"),
                    help="centered evaluation crop run through the 1-core "
                         "cv2 oracle (full real volumes take days there)")
    ap.add_argument("--sigma", type=float, default=2.0)
    ap.add_argument("--levels", type=int, default=3)
    ap.add_argument("--winsize", type=int, default=5)
    args = ap.parse_args()

    from flowdenoising_tpu.utils.compile_cache import enable_compilation_cache
    enable_compilation_cache()
    import jax
    import jax.numpy as jnp
    import ref_pipeline as R
    from flowdenoising_tpu.config import Boundary, FilterConfig, FlowConfig
    from flowdenoising_tpu.core.pipeline import denoise
    from flowdenoising_tpu.io.volume import read_volume
    from flowdenoising_tpu.kernels import get_gaussian_kernels
    from flowdenoising_tpu.utils.metrics import psnr, ssim

    vol = np.asarray(read_volume(args.volume, as_f32=True))
    cz, cy, cx = [min(c, s) for c, s in zip(args.crop, vol.shape)]
    z0, y0, x0 = [(s - c) // 2 for s, c in zip(vol.shape, (cz, cy, cx))]
    crop = np.ascontiguousarray(vol[z0:z0 + cz, y0:y0 + cy, x0:x0 + cx])
    print(f"{args.volume}: shape {vol.shape}, evaluation crop {crop.shape} "
          f"at ({z0},{y0},{x0})")

    sig = (args.sigma,) * 3
    kernels = get_gaussian_kernels(sig)
    print("running cv2 reference on the crop (1-core)...", flush=True)
    t0 = time.perf_counter()
    ref_out = R.of_denoise_wrap(crop, kernels, args.levels, args.winsize,
                                seeded=True)
    print(f"  cv2 reference: {time.perf_counter() - t0:.1f} s")

    def stats(v):
        return (f"min {v.min():.2f} max {v.max():.2f} mean {v.mean():.3f} "
                f"rms {np.sqrt(np.mean(v.astype(np.float64) ** 2)):.3f}")

    print(f"input crop: {stats(crop)}")
    print(f"cv2 output: {stats(ref_out)}")
    print(f"SSIM(input, cv2 out) = {ssim(crop, ref_out):.4f}")
    print()
    print("| Mode | time (s) | PSNR vs cv2 | SSIM vs input | out std |")
    print("|---|---|---|---|---|")

    modes = [
        ("parity (solve f32)", dict()),
        ("solve presmooth=1.5", dict(presmooth=1.5)),
        ("compose f32", dict(tap_mode="compose")),
        ("bf16 compose symmetric", dict(tap_mode="compose",
                                        precision="bfloat16",
                                        symmetric_adjacent=True)),
    ]
    v = jax.device_put(jnp.asarray(crop))
    for name, over in modes:
        cfg = FilterConfig(sigma=sig, boundary=Boundary.WRAP,
                           flow=FlowConfig(levels=args.levels,
                                           winsize=args.winsize, **over))
        jfn = jax.jit(lambda x, c=cfg: denoise(x, c))
        jax.block_until_ready(jfn(v))
        t0 = time.perf_counter()
        out = jax.block_until_ready(jfn(v))
        dt = time.perf_counter() - t0
        out = np.asarray(out)
        print(f"| {name} | {dt:.2f} | {psnr(ref_out, out):.2f} dB | "
              f"{ssim(crop, out):.4f} | {out.std():.3f} |", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
