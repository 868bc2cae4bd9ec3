"""Bounded-displacement sampling against the unbounded gather and the
NumPy float64 bilinear reference (tests/oracle_np.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import oracle_np as O
from conftest import make_blob_image
from flowdenoising_tpu.config import SAMPLERS, FlowConfig
from flowdenoising_tpu.ops.warp import displace_sample


def _case(shape, d, seed, scale=1.0):
    """Blob-field source of ``shape`` (B, H, W) and flows in [-scale*D,
    scale*D]."""
    b, h, w = shape
    rng = np.random.default_rng(seed)
    src = np.stack([make_blob_image(h, w, seed=seed + i)[:h, :w]
                    for i in range(b)]).astype(np.float32)
    u = rng.uniform(-scale * d, scale * d, size=shape).astype(np.float32)
    v = rng.uniform(-scale * d, scale * d, size=shape).astype(np.float32)
    return src, u, v


def _reference(src, u, v):
    """float64 bilinear sample of src (B, [C,] H, W) at identity + (u, v)."""
    h, w = u.shape[-2:]
    gy, gx = np.mgrid[0:h, 0:w].astype(np.float64)
    fx = gx + u.astype(np.float64)
    fy = gy + v.astype(np.float64)
    if src.ndim == u.ndim:
        return O.bilinear_sample(src, fx, fy)
    return np.stack([O.bilinear_sample(src[:, c], fx, fy)
                     for c in range(src.shape[1])], axis=1)


def _sample(src, u, v, d, channels_last=False):
    return np.asarray(jax.jit(
        lambda s, a, b: displace_sample(s, a, b, d,
                                        channels_last=channels_last))(
        jnp.asarray(src), jnp.asarray(u), jnp.asarray(v)))


@pytest.mark.parametrize("shape", [(2, 17, 23), (1, 32, 48)])
@pytest.mark.parametrize("channels", [None, "first", "last"])
@pytest.mark.parametrize("d", [2, 4, 8])
def test_bounded_matches_exact_gather_within_bound(shape, channels, d):
    """|flow| <= D: the bounded sample equals the unbounded gather and the
    float64 reference, with and without a channel dim (channel-first and
    channels-last), on odd and non-square planes."""
    src, u, v = _case(shape, d, seed=d + shape[1])
    span = float(src.max() - src.min())
    if channels is not None:
        src = np.stack([src, 0.5 * src, -src], axis=1)   # (B, 3, H, W)
    want = _reference(src, u, v)
    exact = _sample(src, u, v, None)
    np.testing.assert_allclose(exact, want, atol=1e-5 * span)
    if channels == "last":
        got = np.moveaxis(_sample(np.moveaxis(src, 1, -1), u, v, d,
                                  channels_last=True), -1, 1)
    else:
        got = _sample(src, u, v, d)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5 * span)
    np.testing.assert_allclose(got, exact, atol=1e-5 * span)


@pytest.mark.parametrize("channels", [False, True])
@pytest.mark.parametrize("d", [2, 4])
def test_saturates_beyond_bound(channels, d):
    """Displacements beyond D clamp per component to [-D, D]."""
    src, u, v = _case((2, 24, 20), d, seed=40 + d, scale=3.0)
    span = float(src.max() - src.min())
    if channels:
        src = np.stack([src, -src], axis=1)
    got = _sample(src, u, v, d)
    want = _reference(src, np.clip(u, -d, d), np.clip(v, -d, d))
    np.testing.assert_allclose(got, want, atol=1e-5 * span)
    # ... and differs from the unclamped exact gather where it clamped
    exact = _sample(src, u, v, None)
    assert np.abs(got - exact).max() > 1e-2 * span


@pytest.mark.parametrize("d", [4, None])
@pytest.mark.parametrize("corner", [(-1, -1), (1, 1)])
def test_replicate_borders(d, corner):
    """Samples pushed out of the frame read the edge (cv2
    BORDER_REPLICATE), bounded or not: a constant shift past a corner
    replicates that corner's row/column into the border band."""
    src, _, _ = _case((1, 16, 20), 4, seed=7)
    u = np.full(src.shape, corner[1] * 4, np.float32)
    v = np.full(src.shape, corner[0] * 4, np.float32)
    got = _sample(src, u, v, d)
    want = _reference(src, u, v)
    np.testing.assert_allclose(got, want, atol=1e-4)
    if corner == (-1, -1):
        np.testing.assert_allclose(got[0, 0, 0], src[0, 0, 0], atol=1e-4)
    else:
        np.testing.assert_allclose(got[0, -1, -1], src[0, -1, -1],
                                   atol=1e-4)


@pytest.mark.parametrize("name", ["pallas", "pallas_xwin", "windowed", "xla",
                                  "", "Gather"])
def test_flowconfig_rejects_unknown_sampler(name):
    with pytest.raises(ValueError, match="sampler"):
        FlowConfig(sampler=name)
    with pytest.raises(ValueError, match="sampler"):
        dataclasses.replace(FlowConfig(), sampler=name)


@pytest.mark.parametrize("name", SAMPLERS)
def test_flowconfig_accepts_remaining_samplers(name):
    assert FlowConfig(sampler=name).sampler == name
