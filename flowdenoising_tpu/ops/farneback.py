"""Farneback dense optical flow as batched JAX.

Re-implements the algorithm behind ``cv2.calcOpticalFlowFarneback`` -- the
native C++ engine that accounts for ~90% of the reference pipeline's runtime
(/root/reference/src/flowdenoising.py:69-79) -- as batched, jit-compiled JAX.

Algorithm (Farneback 2003, "Two-frame motion estimation based on polynomial
expansion"), staged exactly like OpenCV so flows agree numerically:

1. **Polynomial expansion** (`poly_expand`): each image neighborhood is fit
   with a quadratic ``f(x) ~ c + b^T x + x^T A x`` via Gaussian-weighted least
   squares; separable correlations with taps ``g, x*g, x^2*g`` (poly_n=5,
   poly_sigma=1.2) followed by a fixed linear combination with the inverse
   Gram matrix entries (ig11/ig03/ig33/ig55).  Output: 5 channels
   ``[b_y, b_x, a_yy, a_xx, a_xy]`` in OpenCV's scaling.
2. **Constraint matrices** (`update_matrices`): sample the second image's
   expansion at positions displaced by the current flow (bilinear), average
   the quadratic terms, form the 2x2 normal-equation entries
   ``G = A^T A, h = A^T db`` per pixel, down-weighting a 5-pixel border band.
3. **Flow solve** (`update_flow`): box-aggregate G,h over ``winsize`` (border
   replicate) and solve the regularized 2x2 system per pixel.
4. **Pyramid driver** (`farneback_flow`): coarse-to-fine over
   ``levels`` (clamped at 32px), per-level pre-smoothing with OpenCV's
   level-dependent Gaussian, INTER_LINEAR down/up-sampling, optional initial
   flow seeding (OPTFLOW_USE_INITIAL_FLOW) via INTER_AREA.

Parallelization note: OpenCV's FarnebackUpdateFlow_Blur interleaves the flow
solve with stripe-wise matrix updates row-by-row; because an M row is only
rewritten after every output row that reads it has been produced, the sweep is
exactly equivalent to "solve all rows from the pre-iteration M, then rebuild M
from the new flow" -- which is the batched form implemented here.

Everything is batched over a leading slice axis: one call computes the flow
between all Z-adjacent slice pairs of a volume at once.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from flowdenoising_tpu.config import FlowConfig
from flowdenoising_tpu.ops.blur import (
    box_blur_sum, smooth_kernel_for_level, _sep_correlate, corr1d)
from flowdenoising_tpu.ops.resize import resize_linear, resize_area, pyramid_sizes
from flowdenoising_tpu.ops.warp import displace_sample

# Border down-weighting ramp (OpenCV farneback.cpp FarnebackUpdateMatrices).
_BORDER_RAMP = np.array([0.14, 0.14, 0.4472, 0.4472, 0.4472], dtype=np.float64)
_BORDER = 5


@functools.lru_cache(maxsize=None)
def poly_exp_constants(n: int, sigma: float):
    """Gaussian applicability taps and inverse-Gram coefficients.

    Returns (g, xg, xxg, ig11, ig03, ig33, ig55); g/xg/xxg are length 2n+1
    float64 taps over offsets [-n, n].
    """
    if sigma < 1e-7:
        sigma = n * 0.3
    x = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(x * x) / (2.0 * sigma * sigma))
    g /= g.sum()
    xg = x * g
    xxg = x * x * g

    G = np.zeros((6, 6), dtype=np.float64)
    s2 = float((g * x * x).sum())      # sum g[x] * x^2
    s4 = float((g * x * x * x * x).sum())
    G[0, 0] = 1.0
    G[1, 1] = G[2, 2] = s2
    G[0, 3] = G[0, 4] = G[3, 0] = G[4, 0] = s2
    G[3, 3] = G[4, 4] = s4
    G[5, 5] = G[3, 4] = G[4, 3] = s2 * s2
    invG = np.linalg.inv(G)
    return g, xg, xxg, float(invG[1, 1]), float(invG[0, 3]), float(invG[3, 3]), float(invG[5, 5])


def poly_expand(img: jnp.ndarray, n: int = 5,
                sigma: float = 1.2) -> jnp.ndarray:
    """Quadratic polynomial expansion of (..., H, W) -> (..., H, W, 5).

    Channels: [b_y, b_x, a_yy, a_xx, a_xy] in OpenCV's internal scaling.
    Border handling: replicate, both axes.
    """
    g, xg, xxg, ig11, ig03, ig33, ig55 = poly_exp_constants(n, float(sigma))

    # Vertical: three correlations along H (g, xg, xxg), replicate border.
    row0 = corr1d(img, g, -2, "edge")
    row1 = corr1d(img, xg, -2, "edge")
    row2 = corr1d(img, xxg, -2, "edge")

    # Horizontal: six raw moments along W.
    b1 = corr1d(row0, g, -1, "edge")
    b2 = corr1d(row0, xg, -1, "edge")
    b4 = corr1d(row0, xxg, -1, "edge")
    b3 = corr1d(row1, g, -1, "edge")
    b6 = corr1d(row1, xg, -1, "edge")
    b5 = corr1d(row2, g, -1, "edge")

    return jnp.stack([
        b3 * ig11,
        b2 * ig11,
        b1 * ig03 + b5 * ig33,
        b1 * ig03 + b4 * ig33,
        b6 * ig55,
    ], axis=-1)


@functools.lru_cache(maxsize=None)
def _border_scale_map(h: int, w: int) -> np.ndarray:
    """Per-pixel down-weighting of the outer 5-pixel band (float64, (H, W))."""
    sy = np.ones(h, dtype=np.float64)
    sx = np.ones(w, dtype=np.float64)
    for i in range(min(_BORDER, h)):
        sy[i] *= _BORDER_RAMP[i]
    for i in range(min(_BORDER, h)):
        sy[h - 1 - i] *= _BORDER_RAMP[i]
    for i in range(min(_BORDER, w)):
        sx[i] *= _BORDER_RAMP[i]
    for i in range(min(_BORDER, w)):
        sx[w - 1 - i] *= _BORDER_RAMP[i]
    return np.outer(sy, sx)


def update_matrices(r0: jnp.ndarray, r1: jnp.ndarray, flow: jnp.ndarray,
                    max_displacement: int | None = None) -> jnp.ndarray:
    """Per-pixel normal-equation entries M = [G11, G12, G22, h1, h2].

    r0, r1: (..., H, W, 5) polynomial expansions of target and reference;
    flow: (..., H, W, 2) current displacement (x, y).
    ``max_displacement`` bounds the displacement r1 is sampled at
    (``ops.warp.displace_sample``).
    """
    h, w = r0.shape[-3], r0.shape[-2]
    dtype = r0.dtype

    dx = flow[..., 0]
    dy = flow[..., 1]
    gx = jnp.arange(w, dtype=dtype)
    gy = jnp.arange(h, dtype=dtype).reshape(h, 1)
    fx = gx + dx
    fy = gy + dy
    x1 = jnp.floor(fx)
    y1 = jnp.floor(fy)
    inb = (x1 >= 0) & (x1 <= w - 2) & (y1 >= 0) & (y1 <= h - 2)

    # Bilinear sample of r1's five channels at the displaced positions
    # (out-of-bounds lanes are masked out below; sampling weights are shared
    # across the channel dim).
    r1s = displace_sample(r1, dx, dy, max_displacement, channels_last=True)

    half = jnp.asarray(0.5, dtype)
    quarter = jnp.asarray(0.25, dtype)
    r4 = jnp.where(inb, (r0[..., 2] + r1s[..., 2]) * half, r0[..., 2])
    r5 = jnp.where(inb, (r0[..., 3] + r1s[..., 3]) * half, r0[..., 3])
    r6 = jnp.where(inb, (r0[..., 4] + r1s[..., 4]) * quarter, r0[..., 4] * half)
    r2 = (r0[..., 0] - jnp.where(inb, r1s[..., 0], 0.0)) * half
    r3 = (r0[..., 1] - jnp.where(inb, r1s[..., 1], 0.0)) * half

    r2 = r2 + r4 * dy + r6 * dx
    r3 = r3 + r6 * dy + r5 * dx

    scale = jnp.asarray(_border_scale_map(h, w), dtype=dtype)
    r2 = r2 * scale
    r3 = r3 * scale
    r4 = r4 * scale
    r5 = r5 * scale
    r6 = r6 * scale

    return jnp.stack([
        r4 * r4 + r6 * r6,
        (r4 + r5) * r6,
        r5 * r5 + r6 * r6,
        r4 * r2 + r6 * r3,
        r6 * r2 + r5 * r3,
    ], axis=-1)


def update_flow(m: jnp.ndarray, winsize: int) -> jnp.ndarray:
    """Box-aggregate M over winsize and solve the per-pixel 2x2 system.

    Returns flow (..., H, W, 2) with channel 0 = x displacement.
    """
    ms = box_blur_sum(jnp.moveaxis(m, -1, -3), winsize)
    ms = jnp.moveaxis(ms, -3, -1) * (1.0 / float(winsize * winsize))
    g11, g12, g22, h1, h2 = (ms[..., i] for i in range(5))
    idet = 1.0 / (g11 * g22 - g12 * g12 + 1e-3)
    u = (g11 * h2 - g12 * h1) * idet
    v = (g22 * h1 - g12 * h2) * idet
    return jnp.stack([u, v], axis=-1)


def _level_displacement(cfg: FlowConfig, level: int) -> int | None:
    """Sampling displacement bound at a pyramid level: flows at level k are
    the full-resolution flow scaled by pyr_scale**k, so the bound shrinks
    with depth (never below 2 to cover iteration updates)."""
    if cfg.max_displacement is None:
        return None
    d = int(np.ceil(cfg.max_displacement * (cfg.pyr_scale ** level))) + 1
    return max(2, d)


def _iterate_level(r0, r1, flow, cfg: FlowConfig, level: int = 0):
    """Fixed-point iterations at one pyramid level (parallel-equivalent form
    of OpenCV's stripe-interleaved sweep; see module docstring)."""
    d = _level_displacement(cfg, level)
    m = update_matrices(r0, r1, flow, d)
    for i in range(cfg.iterations):
        flow = update_flow(m, cfg.winsize)
        if i < cfg.iterations - 1:
            m = update_matrices(r0, r1, flow, d)
    return flow


def smoothed_level_image(img: jnp.ndarray, level: int, out_hw: tuple[int, int],
                         pyr_scale: float = 0.5) -> jnp.ndarray:
    """Pre-smoothed, resized image for one pyramid level (OpenCV: GaussianBlur
    of the *full-resolution* image with the level's sigma, then INTER_LINEAR
    resize to the level size)."""
    taps = smooth_kernel_for_level(level, pyr_scale)
    sm = _sep_correlate(img, taps, taps, "reflect")
    return resize_linear(sm, out_hw)


def image_pyramid(img: jnp.ndarray, cfg: FlowConfig) -> list[jnp.ndarray]:
    """Per-level smoothed/resized images, index 0 = full resolution."""
    h, w = img.shape[-2], img.shape[-1]
    levels = cfg.clamped_levels(h, w)
    sizes = pyramid_sizes(h, w, levels, cfg.pyr_scale)
    return [smoothed_level_image(img, k, sizes[k], cfg.pyr_scale)
            for k in range(levels + 1)]


def polyexp_pyramid(img: jnp.ndarray, cfg: FlowConfig) -> list[jnp.ndarray]:
    """Per-level polynomial expansions (the cacheable heavy half of the flow
    computation -- the denoising pipeline computes this once per slice and
    reuses it for every tap pair)."""
    return [poly_expand(i, cfg.poly_n, cfg.poly_sigma)
            for i in image_pyramid(img, cfg)]


def flow_from_pyramids(r0_levels: list[jnp.ndarray], r1_levels: list[jnp.ndarray],
                       cfg: FlowConfig, initial_flow: jnp.ndarray | None = None) -> jnp.ndarray:
    """Coarse-to-fine flow from precomputed polynomial-expansion pyramids.

    r*_levels[k]: (..., h_k, w_k, 5); initial_flow: (..., H, W, 2) full-res.
    """
    levels = len(r0_levels) - 1
    flow = None
    for k in range(levels, -1, -1):
        hk, wk = r0_levels[k].shape[-3], r0_levels[k].shape[-2]
        if flow is None:
            if cfg.use_initial_flow and initial_flow is not None:
                scale = cfg.pyr_scale ** k
                f = jnp.moveaxis(initial_flow, -1, -3)
                f = resize_area(f, (hk, wk)) * scale
                flow = jnp.moveaxis(f, -3, -1)
            else:
                flow = jnp.zeros(r0_levels[k].shape[:-1] + (2,), dtype=r0_levels[k].dtype)
        else:
            f = jnp.moveaxis(flow, -1, -3)
            f = resize_linear(f, (hk, wk)) * (1.0 / cfg.pyr_scale)
            flow = jnp.moveaxis(f, -3, -1)
        flow = _iterate_level(r0_levels[k], r1_levels[k], flow, cfg, level=k)
    return flow


def matmul_precision(cfg: FlowConfig):
    """Context manager setting the ambient matmul precision for everything
    traced inside (FlowConfig.precision)."""
    return jax.default_matmul_precision(
        "bfloat16" if cfg.precision == "bfloat16" else "float32")


def farneback_flow(reference: jnp.ndarray, target: jnp.ndarray,
                   cfg: FlowConfig = FlowConfig(),
                   initial_flow: jnp.ndarray | None = None) -> jnp.ndarray:
    """Dense optical flow from ``target`` to ``reference`` (cv2 argument
    order of the reference wrapper: prev=target, next=reference --
    /root/reference/src/flowdenoising.py:69-79).

    reference, target: (..., H, W) float images (batched over leading axes).
    Returns flow (..., H, W, 2), channel 0 = x displacement, such that
    ``warp_slices(reference, flow) ~ target``.
    """
    dtype = jnp.dtype(cfg.dtype)
    with matmul_precision(cfg):
        r0 = polyexp_pyramid(target.astype(dtype), cfg)
        r1 = polyexp_pyramid(reference.astype(dtype), cfg)
        return flow_from_pyramids(r0, r1, cfg, initial_flow)
