"""Separable image resizing as dense matrix products.

The Farneback pyramid in the reference is built by OpenCV's ``resize`` with
INTER_LINEAR (image/flow down- and up-sampling) and INTER_AREA (initial-flow
downsampling) -- see the pyramid driver semantics replaced here
(/root/reference/src/flowdenoising.py:69-79 delegates to cv2's farneback.cpp).

Every resample is two dense matmuls

    out = W_rows @ img @ W_cols^T

with static weight matrices computed on the host in float64 and cast to the
compute dtype.  Resampling matrices are tiny (<= extent x extent); batching
over slices turns the whole pyramid into large batched matmuls.

Weight conventions match OpenCV:
- linear: source coordinate ``s = (d + 0.5) * (in/out) - 0.5``, bilinear taps
  clamped to the valid range (border replicate).
- area: true area overlap weights of the destination pixel's source interval.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np


@functools.lru_cache(maxsize=None)
def linear_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) bilinear resampling weights, OpenCV INTER_LINEAR convention."""
    if n_in == n_out:
        return np.eye(n_out, dtype=np.float64)
    w = np.zeros((n_out, n_in), dtype=np.float64)
    scale = n_in / n_out
    for d in range(n_out):
        s = (d + 0.5) * scale - 0.5
        i0 = int(np.floor(s))
        f = s - i0
        a = np.clip(i0, 0, n_in - 1)
        b = np.clip(i0 + 1, 0, n_in - 1)
        w[d, a] += 1.0 - f
        w[d, b] += f
    return w


@functools.lru_cache(maxsize=None)
def area_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) area-average resampling weights, OpenCV INTER_AREA
    convention for downscaling: destination pixel d covers the source interval
    [d*scale, (d+1)*scale); weights are the fractional overlap, normalized.

    For upscaling OpenCV INTER_AREA degenerates to bilinear; we mirror that.
    """
    if n_in == n_out:
        return np.eye(n_out, dtype=np.float64)
    if n_out > n_in:
        return linear_resize_matrix(n_in, n_out)
    w = np.zeros((n_out, n_in), dtype=np.float64)
    scale = n_in / n_out
    for d in range(n_out):
        lo = d * scale
        hi = (d + 1) * scale
        i0 = int(np.floor(lo))
        i1 = int(np.ceil(hi))
        for i in range(i0, min(i1, n_in)):
            overlap = min(hi, i + 1) - max(lo, i)
            if overlap > 0:
                w[d, i] = overlap
        w[d] /= w[d].sum()
    return w


def _apply_separable(img: jnp.ndarray, wr: np.ndarray, wc: np.ndarray) -> jnp.ndarray:
    """Apply per-axis weight matrices to the trailing two axes of ``img``.

    img: (..., H, W);  wr: (H', H);  wc: (W', W)  ->  (..., H', W')

    Precision is pinned to float32 (HIGHEST) regardless of the ambient
    default_matmul_precision: resize matmuls are a trivial share of the
    FLOPs, and a reduced-precision pass (bf16 or TF32) would put rounding
    error into every pyramid level and flow rescale.
    """
    import jax
    dtype = img.dtype
    wr_j = jnp.asarray(wr, dtype=dtype)
    wc_j = jnp.asarray(wc, dtype=dtype)
    prec = jax.lax.Precision.HIGHEST
    out = jnp.einsum("hH,...HW->...hW", wr_j, img, precision=prec)
    out = jnp.einsum("wW,...hW->...hw", wc_j, out, precision=prec)
    return out


def resize_linear(img: jnp.ndarray, out_hw: tuple[int, int]) -> jnp.ndarray:
    """Bilinear resize of the trailing two axes (OpenCV INTER_LINEAR semantics)."""
    h_in, w_in = img.shape[-2], img.shape[-1]
    h_out, w_out = out_hw
    if (h_in, w_in) == (h_out, w_out):
        return img
    return _apply_separable(img, linear_resize_matrix(h_in, h_out),
                            linear_resize_matrix(w_in, w_out))


def resize_area(img: jnp.ndarray, out_hw: tuple[int, int]) -> jnp.ndarray:
    """Area-average resize of the trailing two axes (OpenCV INTER_AREA)."""
    h_in, w_in = img.shape[-2], img.shape[-1]
    h_out, w_out = out_hw
    if (h_in, w_in) == (h_out, w_out):
        return img
    return _apply_separable(img, area_resize_matrix(h_in, h_out),
                            area_resize_matrix(w_in, w_out))


def cv_round(x: float) -> int:
    """OpenCV cvRound: round half to even."""
    return int(np.rint(x))


def pyramid_sizes(height: int, width: int, levels: int, pyr_scale: float) -> list[tuple[int, int]]:
    """Per-level (h, w), index 0 = full resolution, following OpenCV's
    ``cvRound(size * pyr_scale**k)`` sizing."""
    sizes = []
    for k in range(levels + 1):
        scale = pyr_scale ** k
        sizes.append((cv_round(height * scale), cv_round(width * scale)))
    return sizes
