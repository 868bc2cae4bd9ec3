"""Axis-pass and pipeline parity vs the reference-semantics cv2 oracle
(tests/ref_pipeline.py).

Volumes are small (levels clamp to 0 below 32px per OpenCV's min_size, which
both sides honor) and sigma=0.5 keeps the kernel at 5 taps so the cv2 oracle
stays fast on this 1-core machine.
"""

import numpy as np
import jax.numpy as jnp
import pytest

import ref_pipeline as R
from conftest import make_blob_volume
from flowdenoising_tpu.config import Boundary, FilterConfig, FlowConfig
from flowdenoising_tpu.core.axis_filter import gaussian_pass, of_pass
from flowdenoising_tpu.core.pipeline import denoise, gaussian_denoise
from flowdenoising_tpu.kernels import get_gaussian_kernel, get_gaussian_kernels

SIGMA = 0.5
L = 3
W = 5
# cv2.remap quantizes coords to 1/32; with slice gradients up to ~40/px the
# per-tap warp can differ by ~0.6 in the worst voxel.  Mean stays far tighter.
TOL_MAX = 1.0
TOL_MEAN = 0.02


def _vol():
    return make_blob_volume(12, 36, 40, seed=1)


def test_gaussian_pass_wrap_matches_reference_math():
    vol = _vol()
    k = get_gaussian_kernel(2.0)
    ours = np.asarray(gaussian_pass(jnp.asarray(vol), k, Boundary.WRAP))
    ref = R.gaussian_filter_axis_wrap(vol, k, 0)
    np.testing.assert_allclose(ours, ref, atol=2e-3)


def test_gaussian_denoise_wrap_full():
    vol = _vol()
    ks = get_gaussian_kernels((1.0, 1.0, 1.0))
    ours = np.asarray(gaussian_denoise(vol, (1.0, 1.0, 1.0)))
    ref = R.gaussian_denoise_wrap(vol, ks)
    np.testing.assert_allclose(ours, ref, atol=5e-3)


@pytest.mark.parametrize("seeded", [True, pytest.param(False, marks=pytest.mark.slow)])
def test_of_pass_wrap_matches_reference(seeded):
    vol = _vol()
    k = get_gaussian_kernel(SIGMA)
    cfg = FlowConfig(levels=L, winsize=W, use_initial_flow=seeded)
    ours = np.asarray(of_pass(jnp.asarray(vol), k, cfg, Boundary.WRAP))
    ref = R.of_filter_axis_wrap(vol, k, 0, L, W, seeded=seeded)
    err = np.abs(ours - ref)
    assert err.max() < TOL_MAX, err.max()
    assert err.mean() < TOL_MEAN, err.mean()


@pytest.mark.slow
def test_of_pass_meanpad_matches_sequential():
    vol = _vol()
    k = get_gaussian_kernel(SIGMA)
    mean = vol.mean()
    cfg = FlowConfig(levels=L, winsize=W, use_initial_flow=True)
    ours = np.asarray(of_pass(jnp.asarray(vol), k, cfg, Boundary.MEAN, mean_val=mean))
    ref = R.of_filter_axis_meanpad(vol, k, 0, L, W, mean, seeded=True)
    err = np.abs(ours - ref)
    assert err.max() < TOL_MAX
    assert err.mean() < TOL_MEAN


@pytest.mark.slow
def test_full_denoise_wrap_matches_reference_exact():
    # max_displacement=None: exact gather sampling, strict parity (wrap
    # boundary pairs unrelated far-apart slices, so flows exceed any bound)
    vol = make_blob_volume(10, 32, 36, seed=2)
    ks = get_gaussian_kernels((SIGMA,) * 3)
    cfg = FilterConfig(sigma=(SIGMA,) * 3, boundary=Boundary.WRAP,
                       flow=FlowConfig(levels=L, winsize=W, max_displacement=None))
    ours = np.asarray(denoise(vol, cfg))
    ref = R.of_denoise_wrap(vol, ks, L, W, seeded=True)
    assert R.psnr(ours, ref) > 55, R.psnr(ours, ref)
    assert np.abs(ours - ref).mean() < 0.05


@pytest.mark.slow
def test_full_denoise_wrap_windowed_default_close():
    # Default bounded sampling (max_displacement=8): identical except where
    # wrap-boundary flows exceed the bound; quality-level agreement required.
    vol = make_blob_volume(10, 32, 36, seed=2)
    ks = get_gaussian_kernels((SIGMA,) * 3)
    cfg = FilterConfig(sigma=(SIGMA,) * 3, boundary=Boundary.WRAP,
                       flow=FlowConfig(levels=L, winsize=W))
    ours = np.asarray(denoise(vol, cfg))
    ref = R.of_denoise_wrap(vol, ks, L, W, seeded=True)
    assert R.psnr(ours, ref) > 50, R.psnr(ours, ref)


@pytest.mark.slow
def test_full_denoise_meanpad_matches_sequential():
    vol = make_blob_volume(10, 32, 36, seed=3)
    ks = get_gaussian_kernels((SIGMA,) * 3)
    cfg = FilterConfig(sigma=(SIGMA,) * 3, boundary=Boundary.MEAN,
                       flow=FlowConfig(levels=L, winsize=W))
    ours = np.asarray(denoise(vol, cfg))
    ref = R.of_denoise_meanpad(vol, ks, L, W, seeded=True)
    assert R.psnr(ours, ref) > 55, R.psnr(ours, ref)


@pytest.mark.slow
def test_anisotropic_sigma_matches_reference():
    # BASELINE.json config 3: sigma_z != sigma_y != sigma_x -- per-axis tap
    # counts differ (0.5 -> 5 taps, 1.0 -> 9) and each pass must pick ITS
    # axis's kernel.
    vol = make_blob_volume(10, 32, 36, seed=7)
    sigma = (0.5, 1.0, 0.75)
    ks = get_gaussian_kernels(sigma)
    assert len({len(k) for k in ks}) > 1
    cfg = FilterConfig(sigma=sigma, boundary=Boundary.WRAP,
                       flow=FlowConfig(levels=L, winsize=W,
                                       max_displacement=None))
    ours = np.asarray(denoise(vol, cfg))
    ref = R.of_denoise_wrap(vol, ks, L, W, seeded=True)
    assert R.psnr(ours, ref) > 55, R.psnr(ours, ref)


def test_anisotropic_sigma_gaussian_matches_reference():
    vol = make_blob_volume(10, 32, 36, seed=8)
    sigma = (0.5, 2.0, 1.0)
    ks = get_gaussian_kernels(sigma)
    ours = np.asarray(gaussian_denoise(vol, sigma, Boundary.WRAP))
    ref = R.gaussian_denoise_wrap(vol, ks)
    np.testing.assert_allclose(ours, ref, atol=5e-3)


@pytest.mark.slow
def test_slab_mode_identical():
    vol = make_blob_volume(12, 32, 32, seed=4)
    cfg_full = FilterConfig(sigma=(SIGMA,) * 3, flow=FlowConfig(levels=0, winsize=W))
    import dataclasses
    cfg_slab = dataclasses.replace(cfg_full, slab_size=5)
    a = np.asarray(denoise(vol, cfg_full))
    b = np.asarray(denoise(vol, cfg_slab))
    np.testing.assert_allclose(a, b, atol=1e-5)


def test_replicate_boundary_runs():
    vol = make_blob_volume(8, 32, 32, seed=5)
    cfg = FilterConfig(sigma=(SIGMA,) * 3, boundary=Boundary.REPLICATE,
                       flow=FlowConfig(levels=0, winsize=W))
    out = np.asarray(denoise(vol, cfg))
    assert out.shape == vol.shape
    assert np.isfinite(out).all()


def test_donated_pass_preserves_caller_array():
    # Pass buffers are donated (pipeline.py::_cached_pass, donate_argnums=0);
    # a caller-held device array must be copied, not invalidated, and calling
    # twice must give identical results (regression for the round-2 donation
    # that makes solve mode fit HBM at 1024x1024x512).
    import jax.numpy as jnp
    vol = make_blob_volume(10, 32, 32, seed=6)
    cfg = FilterConfig(sigma=(SIGMA,) * 3, flow=FlowConfig(levels=0, winsize=W))
    dev = jnp.asarray(vol)
    a = np.asarray(denoise(dev, cfg))
    # caller's array is still alive and unchanged
    np.testing.assert_allclose(np.asarray(dev), vol, atol=0)
    b = np.asarray(denoise(dev, cfg))
    np.testing.assert_array_equal(a, b)


@pytest.mark.slow
def test_donated_slab_solve_pipeline_large_ci():
    # Largest CI-able donated slab run in solve mode with a real pyramid:
    # exercises the exact per-pass program shape (padded stack build ->
    # slabbed scan -> donation) that the 1024x1024x512 headline uses.
    vol = make_blob_volume(24, 48, 40, seed=7)
    import dataclasses
    cfg = FilterConfig(sigma=(SIGMA,) * 3,
                       flow=FlowConfig(levels=2, winsize=W, min_size=8))
    a = np.asarray(denoise(vol, cfg))
    b = np.asarray(denoise(vol, dataclasses.replace(cfg, slab_size=7)))
    np.testing.assert_allclose(a, b, atol=1e-5)
    assert np.isfinite(a).all()


def test_tiny_axis_wrap_kernel_longer_than_axis():
    # Z=4 slices at sigma=2 (17 taps, ks2=8 > Z): the reference's modular
    # indexing (flowdenoising.py:137) wraps multiple times around the axis;
    # pad_stack must materialize the same context rather than silently
    # under-padding (vol[-8:] of a 4-slice stack is only 4 slices).
    vol = make_blob_volume(4, 36, 40, seed=3)
    k = get_gaussian_kernel(2.0)
    ours = np.asarray(gaussian_pass(jnp.asarray(vol), k, Boundary.WRAP))
    ref = R.gaussian_filter_axis_wrap(vol, k, 0)
    np.testing.assert_allclose(ours, ref, atol=2e-3)


@pytest.mark.slow
def test_tiny_axis_of_wrap_kernel_longer_than_axis():
    vol = make_blob_volume(4, 36, 40, seed=4)
    k = get_gaussian_kernel(2.0)
    cfg = FlowConfig(levels=0, winsize=W, use_initial_flow=True)
    ours = np.asarray(of_pass(jnp.asarray(vol), k, cfg, Boundary.WRAP))
    ref = R.of_filter_axis_wrap(vol, k, 0, 0, W, seeded=True)
    err = np.abs(ours - ref)
    assert err.max() < TOL_MAX, err.max()
    assert err.mean() < TOL_MEAN, err.mean()


@pytest.mark.slow
def test_presmooth_zero_is_noop():
    # presmooth=0 must take the exact reference-operand path (same program)
    vol = make_blob_volume(8, 24, 24, seed=31) + \
        np.random.default_rng(0).normal(scale=10, size=(8, 24, 24)).astype(np.float32)
    cfg0 = FilterConfig(sigma=(0.5, 0.5, 0.5),
                        flow=FlowConfig(levels=0, winsize=5))
    import dataclasses
    cfgp = dataclasses.replace(
        cfg0, flow=dataclasses.replace(cfg0.flow, presmooth=0.0))
    a = np.asarray(denoise(vol, cfg0))
    b = np.asarray(denoise(vol, cfgp))
    np.testing.assert_array_equal(a, b)


@pytest.mark.slow
def test_presmooth_estimation_only():
    """Flows from pre-smoothed operands, warps from the raw volume: the
    output stays close to the exact-operand pipeline on noisy data (flow
    noise suppression must not blur signal into the output)."""
    rng = np.random.default_rng(7)
    vol = make_blob_volume(10, 32, 32, seed=33) * 4.0
    noisy = vol + rng.normal(scale=12, size=vol.shape).astype(np.float32)
    cfg = FilterConfig(sigma=(1.0, 0.5, 0.5),
                       flow=FlowConfig(levels=1, winsize=5))
    import dataclasses
    cfgp = dataclasses.replace(
        cfg, flow=dataclasses.replace(cfg.flow, presmooth=1.5))
    base = np.asarray(denoise(noisy, cfg))
    ps = np.asarray(denoise(noisy, cfgp))
    assert not np.array_equal(base, ps)  # the estimation stack did change
    # outputs agree closely (flow differences only move sub-pixel samples)
    rms = float(np.sqrt(np.mean((base - ps) ** 2)))
    peak = float(base.max() - base.min())
    assert rms < 0.05 * peak, (rms, peak)


def test_estimation_stack_kernel_size():
    from flowdenoising_tpu.core.axis_filter import _estimation_stack
    v = jnp.asarray(np.random.default_rng(1).normal(
        size=(4, 16, 16)).astype(np.float32))
    cfg = FlowConfig(presmooth=0.0)
    assert _estimation_stack(v, cfg) is v
    import dataclasses
    out = _estimation_stack(v, dataclasses.replace(cfg, presmooth=1.0))
    assert out.shape == v.shape
    assert float(jnp.std(out)) < float(jnp.std(v))  # actually smoothed
