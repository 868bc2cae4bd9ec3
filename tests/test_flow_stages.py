"""Farneback stages (XLA) against the float64 NumPy oracle
(tests/oracle_np.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import oracle_np as O
from conftest import make_blob_image
from flowdenoising_tpu.ops.farneback import (
    poly_expand, update_flow, update_matrices)

H, W = 27, 34  # odd, non-square


def _expansions(seed=0, shift=(1, -2)):
    img = make_blob_image(H, W, seed=seed)[:H, :W].astype(np.float64)
    ref = np.roll(img, shift, axis=(0, 1))
    return O.poly_expand(img), O.poly_expand(ref)


def _flow(seed, amp=2.0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-amp, amp, size=(H, W, 2))


def test_poly_expand_matches_oracle():
    img = make_blob_image(H, W, seed=3)[:H, :W].astype(np.float32)
    got = np.asarray(poly_expand(jnp.asarray(img)))
    want = O.poly_expand(img.astype(np.float64))
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("d", [None, 3, 8])
def test_update_matrices_matches_oracle(d):
    """Within the displacement bound (|flow| <= 2 here) the bounded sample
    gives the oracle's unbounded normal-equation entries; None is the
    unbounded gather."""
    r0, r1 = _expansions(seed=1)
    flow = _flow(seed=2)
    got = np.asarray(jax.jit(lambda a, b, f: update_matrices(a, b, f, d))(
        jnp.asarray(r0, jnp.float32), jnp.asarray(r1, jnp.float32),
        jnp.asarray(flow, jnp.float32)))
    want = O.update_matrices(r0, r1, flow)
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("winsize", [5, 7, 15])
def test_update_flow_matches_oracle(winsize):
    r0, r1 = _expansions(seed=4)
    m = O.update_matrices(r0, r1, _flow(seed=5))
    got = np.asarray(jax.jit(lambda mm: update_flow(mm, winsize))(
        jnp.asarray(m, jnp.float32)))
    want = O.update_flow(m, winsize)
    np.testing.assert_allclose(got, want, atol=1e-3 * np.abs(want).max())


@pytest.mark.parametrize("winsize", [5, 7, 15])
def test_iteration_matches_oracle(winsize):
    """One split iteration (update_matrices then update_flow) against the
    oracle's, from a seeded flow within the bound."""
    r0, r1 = _expansions(seed=6, shift=(2, 1))
    flow = _flow(seed=7, amp=1.5)
    got = np.asarray(jax.jit(lambda a, b, f: update_flow(
        update_matrices(a, b, f, 4), winsize))(
        jnp.asarray(r0, jnp.float32), jnp.asarray(r1, jnp.float32),
        jnp.asarray(flow, jnp.float32)))
    want = O.update_flow(O.update_matrices(r0, r1, flow), winsize)
    np.testing.assert_allclose(got, want, atol=1e-3 * np.abs(want).max())
