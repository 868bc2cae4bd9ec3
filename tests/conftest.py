"""Test configuration: an 8-device virtual CPU mesh, so sharding tests run
without accelerators (SURVEY.md section 4 test strategy)."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import sys
sys.path.insert(0, os.path.dirname(__file__))

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)


def make_blob_image(h, w, n_blobs=12, seed=0, pad=8):
    """Smooth random blob field; the standard OF test pattern here."""
    r = np.random.default_rng(seed)
    base = np.zeros((h + 2 * pad, w + 2 * pad), np.float32)
    yy, xx = np.mgrid[0:h + 2 * pad, 0:w + 2 * pad]
    for _ in range(n_blobs):
        cy = r.uniform(pad, h + pad)
        cx = r.uniform(pad, w + pad)
        rad = r.uniform(3, 9)
        amp = r.uniform(50, 200)
        base += amp * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * rad * rad))
    return base


def make_blob_volume(n, h, w, seed=0, drift=0.7):
    """Volume whose slices are a blob field drifting smoothly with Z --
    structure the OF compensation can follow."""
    r = np.random.default_rng(seed)
    pad = 16
    base = make_blob_image(h, w, n_blobs=20, seed=seed, pad=pad)
    vol = np.zeros((n, h, w), np.float32)
    oy = ox = float(pad)
    for z in range(n):
        iy, ix = int(round(oy)), int(round(ox))
        vol[z] = base[iy:iy + h, ix:ix + w]
        oy += r.uniform(-drift, drift)
        ox += r.uniform(-drift, drift)
        oy = min(max(oy, 0), 2 * pad - 1)
        ox = min(max(ox, 0), 2 * pad - 1)
    return vol
