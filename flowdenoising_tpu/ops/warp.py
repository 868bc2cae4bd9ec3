"""Batched bilinear slice warping (replaces cv2.remap).

Semantics follow the reference ``warp_slice``
(/root/reference/src/flowdenoising.py:55-63): sampling map is identity plus
flow -- ``out[y, x] = ref(x + flow[y,x,0], y + flow[y,x,1])`` -- bilinear
interpolation, border replicate (coordinates clamped to the valid range,
OFCA_EXTENSION_MODE == cv2.BORDER_REPLICATE).

Parity: with float32 maps (the reference's call shape) cv2.remap interpolates
at full float precision -- no 1/32 INTER_TAB_SIZE quantization on this path
(measured <=5e-5 abs diff vs cv2 5.0 on 100-range data across flow scales;
tests/test_warp.py).  Fixed-point tables only apply to pre-converted integer
maps, which the reference never uses.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _take_rows(flat: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """``flat`` (*B, HW, C) gathered at ``idx`` (*B, N) -> (*B, N, C).

    One XLA gather whose slice is a whole channel row, so a channels-last
    source fetches all its channels with one index."""
    take = lambda s, i: jnp.take(s, i, axis=0, mode="clip")
    for _ in range(idx.ndim - 1):
        take = jax.vmap(take)
    return take(flat, idx)


def displace_sample(src: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray,
                    max_displacement: int | None,
                    channels_last: bool = False) -> jnp.ndarray:
    """Sample ``src`` at per-pixel displacements (u, v) of shape (..., H, W).

    src is (..., H, W), or carries a channel dim sharing the sampling
    weights: (..., C, H, W), or (..., H, W, C) with ``channels_last``.
    Leading dims of src and (u, v) broadcast.

    ``max_displacement`` None samples unbounded.  With a bound D each
    displacement component is clamped to [-D, D] first (identical to the
    unbounded sample whenever |u|, |v| <= D).  Either way the sample is
    four gathers and three lerps per pixel, which XLA fuses with the
    surrounding elementwise work.
    """
    has_channels = src.ndim == u.ndim + 1
    if not has_channels:
        src = src[..., None]
    elif not channels_last:
        src = jnp.moveaxis(src, -3, -1)
    if max_displacement is not None:
        u = jnp.clip(u, -max_displacement, max_displacement)
        v = jnp.clip(v, -max_displacement, max_displacement)
    h, w, c = src.shape[-3:]
    batch = jnp.broadcast_shapes(src.shape[:-3], u.shape[:-2])
    flat = jnp.broadcast_to(src, batch + (h, w, c)).reshape(
        batch + (h * w, c))
    fx = jnp.broadcast_to(u + jnp.arange(w, dtype=u.dtype), batch + (h, w))
    fy = jnp.broadcast_to(v + jnp.arange(h, dtype=v.dtype).reshape(h, 1),
                          batch + (h, w))
    x0 = jnp.floor(fx)
    y0 = jnp.floor(fy)
    tx = (fx - x0)[..., None]
    ty = (fy - y0)[..., None]
    x0 = x0.astype(jnp.int32)
    y0 = y0.astype(jnp.int32)
    xa = jnp.clip(x0, 0, w - 1)
    xb = jnp.clip(x0 + 1, 0, w - 1)
    ya = jnp.clip(y0, 0, h - 1) * w
    yb = jnp.clip(y0 + 1, 0, h - 1) * w
    v00, v01, v10, v11 = (
        _take_rows(flat, i.reshape(batch + (h * w,))).reshape(
            batch + (h, w, c))
        for i in (ya + xa, ya + xb, yb + xa, yb + xb))
    top = v00 + (v01 - v00) * tx
    bot = v10 + (v11 - v10) * tx
    out = top + (bot - top) * ty
    if not has_channels:
        return out[..., 0]
    return out if channels_last else jnp.moveaxis(out, -1, -3)


def warp_slices(ref: jnp.ndarray, flow: jnp.ndarray,
                max_displacement: int | None = None) -> jnp.ndarray:
    """Warp ``ref`` (..., H, W) by ``flow`` (..., H, W, 2); flow channel 0 is
    the X displacement, channel 1 the Y displacement (cv2 convention).

    ``max_displacement`` bounds the per-component displacement (see
    ``displace_sample``); None samples unbounded.
    """
    return displace_sample(ref, flow[..., 0], flow[..., 1],
                           max_displacement)
