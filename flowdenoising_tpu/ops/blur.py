"""Separable blurs with OpenCV-compatible kernels and borders.

Replaces the pre-pyramid GaussianBlur and the winsize box aggregation inside
cv2.calcOpticalFlowFarneback (the native C++ engine behind
/root/reference/src/flowdenoising.py:69-79).

Implementation notes:
- Blurs act on the trailing two axes of a batched array (..., H, W).
- Separable correlation is pad + shift-and-add of the 1-D taps along each
  axis; XLA fuses the pad, the shifted reads and the multiply-adds into one
  bandwidth-bound elementwise kernel per axis.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

# OpenCV getGaussianKernel fixed taps for sigma<=0 and ksize in {1,3,5,7}.
_SMALL_GAUSSIAN_TAB = {
    1: np.array([1.0]),
    3: np.array([0.25, 0.5, 0.25]),
    5: np.array([0.0625, 0.25, 0.375, 0.25, 0.0625]),
    7: np.array([0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125]),
}


@functools.lru_cache(maxsize=None)
def opencv_gaussian_taps(ksize: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel semantics (float64, normalized).

    sigma <= 0 uses the fixed small-kernel table for ksize <= 7, else the
    derived sigma ``0.3*((ksize-1)*0.5 - 1) + 0.8``.
    """
    if sigma <= 0 and ksize in _SMALL_GAUSSIAN_TAB:
        return _SMALL_GAUSSIAN_TAB[ksize].copy()
    s = sigma if sigma > 0 else 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(x * x) / (2.0 * s * s))
    return k / k.sum()


def smooth_kernel_for_level(level: int, pyr_scale: float = 0.5) -> np.ndarray:
    """Pre-pyramid smoothing taps used by OpenCV Farneback at a given level:
    sigma = (1/scale - 1) * 0.5, ksize = cvRound(sigma*5) | 1 clamped to >= 3."""
    scale = pyr_scale ** level
    sigma = (1.0 / scale - 1.0) * 0.5
    ksize = int(np.rint(sigma * 5)) | 1
    ksize = max(ksize, 3)
    return opencv_gaussian_taps(ksize, sigma)


def corr1d(img: jnp.ndarray, taps, axis: int, pad_mode: str) -> jnp.ndarray:
    """1-D correlation along ``axis`` as an unrolled shift-and-add.

    For the short taps used here (5..33) XLA fuses the K shifted reads of
    one padded buffer into a single bandwidth-bound elementwise kernel; a
    1-channel spatial convolution has no contraction dim to give a matrix
    unit.
    """
    taps = np.asarray(taps, dtype=np.float64)
    r = len(taps) // 2
    axis = axis % img.ndim
    n = img.shape[axis]
    pad = [(0, 0)] * img.ndim
    pad[axis] = (r, r)
    p = jnp.pad(img, pad, mode=pad_mode)
    dtype = img.dtype
    out = None
    for k in range(len(taps)):
        sl = [slice(None)] * img.ndim
        sl[axis] = slice(k, k + n)
        term = p[tuple(sl)] * jnp.asarray(taps[k], dtype)
        out = term if out is None else out + term
    return out


def _sep_correlate(img: jnp.ndarray, taps_h: np.ndarray, taps_w: np.ndarray,
                   pad_mode: str) -> jnp.ndarray:
    """Separable 2-D correlation on the trailing axes with the given numpy
    pad mode ('reflect' == cv2 BORDER_REFLECT_101, 'edge' == BORDER_REPLICATE).
    """
    return corr1d(corr1d(img, taps_h, -2, pad_mode), taps_w, -1, pad_mode)


def gaussian_blur(img: jnp.ndarray, ksize: int, sigma: float) -> jnp.ndarray:
    """cv2.GaussianBlur(img, (ksize, ksize), sigma) with the default
    BORDER_REFLECT_101 border, batched over leading axes."""
    taps = opencv_gaussian_taps(ksize, sigma)
    return _sep_correlate(img, taps, taps, "reflect")


def box_blur_sum(img: jnp.ndarray, winsize: int) -> jnp.ndarray:
    """Replicate-border box *sum* over a (2*(winsize//2)+1)^2 window.

    Matches the running-sum aggregation of OpenCV FarnebackUpdateFlow_Blur:
    window half-extent m = winsize//2; border pixels replicate; the caller
    scales by 1/winsize**2 exactly as OpenCV does (note: OpenCV divides by
    winsize^2 even though the window has (2m+1)^2 taps; for odd winsize they
    coincide).
    """
    m = winsize // 2
    taps = np.ones(2 * m + 1, dtype=np.float64)
    return _sep_correlate(img, taps, taps, "edge")


def box_blur(img: jnp.ndarray, winsize: int) -> jnp.ndarray:
    """Box mean with OpenCV Farneback's 1/winsize**2 normalization."""
    return box_blur_sum(img, winsize) * (1.0 / float(winsize * winsize))
