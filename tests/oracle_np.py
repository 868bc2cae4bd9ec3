"""Pure-NumPy float64 oracle of the Farneback stages, written from the
published algorithm (Farneback 2003) + OpenCV's documented staging.

Used to localize divergence between the JAX implementation and
cv2.calcOpticalFlowFarneback: the oracle implements the same spec as the JAX
code but in float64 sequential NumPy, so

- oracle == cv2   and   oracle != jax  ->  JAX implementation bug
- oracle == jax   and   oracle != cv2  ->  spec misunderstanding

This module is test-support code, not part of the shipped framework.
"""

from __future__ import annotations

import numpy as np

BORDER_RAMP = np.array([0.14, 0.14, 0.4472, 0.4472, 0.4472])
BORDER = 5


def poly_exp_constants(n, sigma):
    if sigma < 1e-7:
        sigma = n * 0.3
    x = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(x * x) / (2 * sigma * sigma))
    g /= g.sum()
    xg = x * g
    xxg = x * x * g
    G = np.zeros((6, 6))
    s2 = (g * x * x).sum()
    s4 = (g * x ** 4).sum()
    G[0, 0] = 1.0
    G[1, 1] = G[2, 2] = s2
    G[0, 3] = G[0, 4] = G[3, 0] = G[4, 0] = s2
    G[3, 3] = G[4, 4] = s4
    G[5, 5] = G[3, 4] = G[4, 3] = s2 * s2
    invG = np.linalg.inv(G)
    return g, xg, xxg, invG[1, 1], invG[0, 3], invG[3, 3], invG[5, 5]


def _corr1d(img, taps, axis):
    """Correlation with replicate border along an axis."""
    n = len(taps) // 2
    pad = [(0, 0)] * img.ndim
    pad[axis] = (n, n)
    p = np.pad(img, pad, mode="edge")
    out = np.zeros_like(img, dtype=np.float64)
    for k in range(len(taps)):
        sl = [slice(None)] * img.ndim
        sl[axis] = slice(k, k + img.shape[axis])
        out += taps[k] * p[tuple(sl)]
    return out


def poly_expand(img, n=5, sigma=1.2):
    g, xg, xxg, ig11, ig03, ig33, ig55 = poly_exp_constants(n, sigma)
    img = img.astype(np.float64)
    r0 = _corr1d(img, g, 0)
    r1 = _corr1d(img, xg, 0)
    r2 = _corr1d(img, xxg, 0)
    b1 = _corr1d(r0, g, 1)
    b2 = _corr1d(r0, xg, 1)
    b3 = _corr1d(r1, g, 1)
    b4 = _corr1d(r0, xxg, 1)
    b5 = _corr1d(r2, g, 1)
    b6 = _corr1d(r1, xg, 1)
    R = np.stack([
        b3 * ig11,
        b2 * ig11,
        b1 * ig03 + b5 * ig33,
        b1 * ig03 + b4 * ig33,
        b6 * ig55,
    ], axis=-1)
    return R


def update_matrices(R0, R1, flow):
    h, w = flow.shape[:2]
    M = np.zeros((h, w, 5))
    sy = np.ones(h)
    sx = np.ones(w)
    for i in range(min(BORDER, h)):
        sy[i] *= BORDER_RAMP[i]
        sy[h - 1 - i] *= BORDER_RAMP[i]
        sx[i] *= BORDER_RAMP[i]
        sx[w - 1 - i] *= BORDER_RAMP[i]
    for y in range(h):
        for x in range(w):
            dx, dy = flow[y, x]
            fx, fy = x + dx, y + dy
            x1 = int(np.floor(fx))
            y1 = int(np.floor(fy))
            fxf = fx - x1
            fyf = fy - y1
            if 0 <= x1 <= w - 2 and 0 <= y1 <= h - 2:
                a00 = (1 - fxf) * (1 - fyf)
                a01 = fxf * (1 - fyf)
                a10 = (1 - fxf) * fyf
                a11 = fxf * fyf
                s = (a00 * R1[y1, x1] + a01 * R1[y1, x1 + 1]
                     + a10 * R1[y1 + 1, x1] + a11 * R1[y1 + 1, x1 + 1])
                r2, r3 = s[0], s[1]
                r4 = (R0[y, x, 2] + s[2]) * 0.5
                r5 = (R0[y, x, 3] + s[3]) * 0.5
                r6 = (R0[y, x, 4] + s[4]) * 0.25
            else:
                r2 = r3 = 0.0
                r4 = R0[y, x, 2]
                r5 = R0[y, x, 3]
                r6 = R0[y, x, 4] * 0.5
            r2 = (R0[y, x, 0] - r2) * 0.5
            r3 = (R0[y, x, 1] - r3) * 0.5
            r2 += r4 * dy + r6 * dx
            r3 += r6 * dy + r5 * dx
            scale = sy[y] * sx[x]
            r2 *= scale; r3 *= scale; r4 *= scale; r5 *= scale; r6 *= scale
            M[y, x] = [r4 * r4 + r6 * r6, (r4 + r5) * r6, r5 * r5 + r6 * r6,
                       r4 * r2 + r6 * r3, r6 * r2 + r5 * r3]
    return M


def box_blur(M, winsize):
    m = winsize // 2
    taps = np.ones(2 * m + 1)
    out = _corr1d(_corr1d(M, taps, 0), taps, 1)
    return out / (winsize * winsize)


def update_flow(M, winsize):
    ms = box_blur(M, winsize)
    g11, g12, g22, h1, h2 = [ms[..., i] for i in range(5)]
    idet = 1.0 / (g11 * g22 - g12 * g12 + 1e-3)
    u = (g11 * h2 - g12 * h1) * idet
    v = (g22 * h1 - g12 * h2) * idet
    return np.stack([u, v], axis=-1)


SMALL_GAUSSIAN = {1: [1.0], 3: [0.25, 0.5, 0.25],
                  5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
                  7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125]}


def gaussian_taps(ksize, sigma):
    if sigma <= 0 and ksize in SMALL_GAUSSIAN:
        return np.array(SMALL_GAUSSIAN[ksize])
    s = sigma if sigma > 0 else 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize) - (ksize - 1) * 0.5
    k = np.exp(-(x * x) / (2 * s * s))
    return k / k.sum()


def smooth(img, ksize, sigma):
    """GaussianBlur with BORDER_REFLECT_101."""
    taps = gaussian_taps(ksize, sigma)
    n = len(taps) // 2
    p = np.pad(img.astype(np.float64), n, mode="reflect")
    out = np.zeros_like(img, dtype=np.float64)
    tmp = np.zeros((img.shape[0], p.shape[1]))
    for k in range(len(taps)):
        tmp += taps[k] * p[k:k + img.shape[0]]
    for k in range(len(taps)):
        out += taps[k] * tmp[:, k:k + img.shape[1]]
    return out


def farneback_level0(img_prev, img_next, winsize=5, iterations=3,
                     poly_n=5, poly_sigma=1.2, flow0=None):
    """Single-level (levels=0) Farneback, float64."""
    I0 = smooth(img_prev, 3, 0.0)
    I1 = smooth(img_next, 3, 0.0)
    R0 = poly_expand(I0, poly_n, poly_sigma)
    R1 = poly_expand(I1, poly_n, poly_sigma)
    flow = np.zeros(img_prev.shape + (2,)) if flow0 is None else flow0.astype(np.float64)
    M = update_matrices(R0, R1, flow)
    for i in range(iterations):
        flow = update_flow(M, winsize)
        if i < iterations - 1:
            M = update_matrices(R0, R1, flow)
    return flow


def bilinear_sample(img, fx, fy):
    """Bilinear sample of img (..., H, W) at float64 coords (fx, fy) of
    shape (..., H', W') with the same leading dims, replicate borders
    (cv2.BORDER_REPLICATE)."""
    fx = np.asarray(fx, np.float64)
    fy = np.asarray(fy, np.float64)
    h, w = img.shape[-2:]
    imgs = np.asarray(img, np.float64).reshape((-1, h, w))
    fxs = fx.reshape((imgs.shape[0],) + fx.shape[-2:])
    fys = fy.reshape(fxs.shape)
    x0 = np.floor(fxs)
    y0 = np.floor(fys)
    tx = fxs - x0
    ty = fys - y0
    xa, xb = (np.clip(x, 0, w - 1).astype(np.int64) for x in (x0, x0 + 1))
    ya, yb = (np.clip(y, 0, h - 1).astype(np.int64) for y in (y0, y0 + 1))
    b = np.arange(imgs.shape[0]).reshape(-1, 1, 1)
    top = imgs[b, ya, xa] * (1 - tx) + imgs[b, ya, xb] * tx
    bot = imgs[b, yb, xa] * (1 - tx) + imgs[b, yb, xb] * tx
    return (top * (1 - ty) + bot * ty).reshape(fx.shape)
