"""Reference-semantics pipeline oracle (NumPy + cv2), used for parity tests.

Re-expresses the math of the reference's two denoisers from the SURVEY spec:
- wrap-boundary class pipeline (flowdenoising.py FlowDenoising/GaussianDenoising)
- mean-padded sequential pipeline (flowdenoising_sequential.py OF_filter)

Test-support code; intentionally dependent on cv2 so the JAX build is judged
against the same native kernels the reference uses.
"""

from __future__ import annotations

import cv2
import numpy as np


def warp_slice(reference, flow):
    h, w = flow.shape[:2]
    map_x = np.tile(np.arange(w), (h, 1))
    map_y = np.swapaxes(np.tile(np.arange(h), (w, 1)), 0, 1)
    map_xy = (flow + np.dstack((map_x, map_y))).astype("float32")
    return cv2.remap(reference, map_xy, None, interpolation=cv2.INTER_LINEAR,
                     borderMode=cv2.BORDER_REPLICATE)


def get_flow_seeded(reference, target, l, w, prev_flow):
    return cv2.calcOpticalFlowFarneback(
        prev=target, next=reference, flow=prev_flow, pyr_scale=0.5, levels=l,
        winsize=w, iterations=3, poly_n=5, poly_sigma=1.2,
        flags=cv2.OPTFLOW_USE_INITIAL_FLOW)


def get_flow_fresh(reference, target, l, w, prev_flow=None):
    return cv2.calcOpticalFlowFarneback(
        prev=target, next=reference, flow=None, pyr_scale=0.5, levels=l,
        winsize=w, iterations=3, poly_n=5, poly_sigma=1.2, flags=0)


def _take(vol, axis, idx_list):
    """Gather slices along an axis, returning the stack with that axis first."""
    moved = np.moveaxis(vol, axis, 0)
    return moved, moved.shape[0]


def of_filter_axis_wrap(vol, kernel, axis, l, w, seeded=True):
    """Wrap-boundary OF pass along ``axis`` (FlowDenoising.filter_along_*_slice
    semantics: two outward runs, chained prev_flow, modular indexing)."""
    moved = np.moveaxis(vol, axis, 0)
    n = moved.shape[0]
    ks2 = kernel.size // 2
    out = np.zeros_like(moved, dtype=np.float32)
    get_flow = get_flow_seeded if seeded else get_flow_fresh
    for z in range(n):
        target = moved[z]
        tmp = target.astype(np.float32) * kernel[ks2]
        prev = np.zeros(target.shape + (2,), np.float32)
        for i in range(ks2 - 1, -1, -1):
            nb = moved[(z + i - ks2) % n]
            flow = get_flow(nb, target, l, w, prev)
            prev = flow
            tmp += warp_slice(nb, flow) * kernel[i]
        prev = np.zeros(target.shape + (2,), np.float32)
        for i in range(ks2 + 1, kernel.size):
            nb = moved[(z + i - ks2) % n]
            flow = get_flow(nb, target, l, w, prev)
            prev = flow
            tmp += warp_slice(nb, flow) * kernel[i]
        out[z] = tmp
    return np.moveaxis(out, 0, axis)


def of_filter_axis_meanpad(vol, kernel, axis, l, w, mean, seeded=True):
    """Mean-padded OF pass (sequential OF_filter_along_* semantics)."""
    moved = np.moveaxis(vol, axis, 0)
    n = moved.shape[0]
    ks2 = kernel.size // 2
    padded = np.full((n + kernel.size,) + moved.shape[1:], mean, dtype=moved.dtype)
    padded[ks2:n + ks2] = moved
    out = np.zeros_like(moved, dtype=np.float32)
    get_flow = get_flow_seeded if seeded else get_flow_fresh
    for z in range(n):
        target = moved[z]
        tmp = target.astype(np.float32) * kernel[ks2]
        prev = np.zeros(target.shape + (2,), np.float32)
        for i in range(ks2 - 1, -1, -1):
            nb = padded[z + i]
            flow = get_flow(nb, target, l, w, prev)
            prev = flow
            tmp += warp_slice(nb, flow) * kernel[i]
        prev = np.zeros(target.shape + (2,), np.float32)
        for i in range(ks2 + 1, kernel.size):
            nb = padded[z + i]
            flow = get_flow(nb, target, l, w, prev)
            prev = flow
            tmp += warp_slice(nb, flow) * kernel[i]
        out[z] = tmp
    return np.moveaxis(out, 0, axis)


def gaussian_filter_axis_wrap(vol, kernel, axis):
    moved = np.moveaxis(vol, axis, 0)
    n = moved.shape[0]
    ks2 = kernel.size // 2
    out = np.zeros_like(moved, dtype=np.float32)
    for z in range(n):
        tmp = np.zeros(moved.shape[1:], np.float32)
        for i in range(kernel.size):
            tmp += moved[(z + i - ks2) % n] * kernel[i]
        out[z] = tmp
    return np.moveaxis(out, 0, axis)


def of_denoise_wrap(vol, kernels, l, w, seeded=True):
    """Z -> Y -> X wrap pipeline (main CLI intended semantics)."""
    out = vol.astype(np.float32)
    for axis, k in enumerate(kernels):
        out = of_filter_axis_wrap(out, k, axis, l, w, seeded)
    return out


def of_denoise_meanpad(vol, kernels, l, w, seeded=True):
    """Sequential-variant semantics: single mean from the input volume."""
    mean = vol.mean()
    out = vol.astype(np.float32)
    for axis, k in enumerate(kernels):
        out = of_filter_axis_meanpad(out, k, axis, l, w, mean, seeded)
    return out


def gaussian_denoise_wrap(vol, kernels):
    out = vol.astype(np.float32)
    for axis, k in enumerate(kernels):
        out = gaussian_filter_axis_wrap(out, k, axis)
    return out


def psnr(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return np.inf
    peak = max(a.max() - a.min(), 1e-12)
    return 10 * np.log10(peak * peak / mse)
