"""Throughput mode: batched multi-volume denoise equals per-volume calls."""

import numpy as np
import pytest

from conftest import make_blob_volume
from flowdenoising_tpu.config import Boundary, FilterConfig, FlowConfig
from flowdenoising_tpu.core.pipeline import denoise, denoise_many


@pytest.mark.slow
def test_denoise_many_matches_singles():
    cfg = FilterConfig(sigma=(0.5, 0.5, 0.5), boundary=Boundary.WRAP,
                       flow=FlowConfig(levels=0, winsize=5))
    vols = [make_blob_volume(6, 24, 24, seed=s) for s in (31, 32, 33)]
    batch = denoise_many(vols, cfg)
    for v, out in zip(vols, batch):
        single = np.asarray(denoise(v, cfg))
        np.testing.assert_allclose(np.asarray(out), single, atol=1e-5)


@pytest.mark.slow
def test_denoise_many_streams_generator():
    """Lazy iterable input: volumes are staged as consumed, not upfront,
    and the pre-staged (owned, donated) path matches per-volume calls."""
    cfg = FilterConfig(sigma=(0.5, 0.5, 0.5), boundary=Boundary.WRAP,
                       flow=FlowConfig(levels=0, winsize=5))
    seeds = (41, 42, 43, 44)
    vols = [make_blob_volume(5, 24, 24, seed=s) for s in seeds]
    staged_order = []

    def gen():
        for i, v in enumerate(vols):
            staged_order.append(i)
            yield v.copy()

    batch = denoise_many(gen(), cfg, window=2)
    assert len(batch) == len(vols)
    assert staged_order == list(range(len(vols)))
    for v, out in zip(vols, batch):
        single = np.asarray(denoise(v, cfg))
        np.testing.assert_allclose(np.asarray(out), single, atol=1e-5)


def test_denoise_many_does_not_clobber_device_inputs():
    """Caller-held float32 device arrays must survive (denoise copies them
    instead of donating the caller's buffer)."""
    import jax.numpy as jnp
    cfg = FilterConfig(sigma=(0.5, 0.5, 0.5), boundary=Boundary.WRAP,
                       flow=FlowConfig(levels=0, winsize=5))
    host = make_blob_volume(5, 24, 24, seed=7)
    dev = jnp.asarray(host)
    denoise_many([dev], cfg)
    np.testing.assert_array_equal(np.asarray(dev), host)


def test_denoise_many_backpressure_bounds_in_flight(monkeypatch):
    """The in-flight window must actually SYNC: every volume past the
    window is dispatched only after the volume leaving the window completed
    (sync event observed) in pipeline._sync_result -- if the window stops
    syncing, the regression only reappears on hardware as device-memory
    exhaustion, so this asserts the ordering structurally."""
    from flowdenoising_tpu.core import pipeline

    events = []
    real_sync = pipeline._sync_result
    real_denoise = pipeline.denoise
    tagged = {}

    def spy_denoise(v, cfg, **kw):
        out = real_denoise(v, cfg, **kw)
        events.append(("dispatch", len([e for e in events
                                        if e[0] == "dispatch"])))
        tagged[id(out)] = events[-1][1]
        return out

    def spy_sync(x):
        if id(x) in tagged:
            events.append(("sync", tagged[id(x)]))
        real_sync(x)

    monkeypatch.setattr(pipeline, "denoise", spy_denoise)
    monkeypatch.setattr(pipeline, "_sync_result", spy_sync)

    cfg = FilterConfig(sigma=(0.5, 0.5, 0.5), boundary=Boundary.WRAP,
                       flow=FlowConfig(levels=0, winsize=5))
    window = 2
    vols = [make_blob_volume(5, 24, 24, seed=60 + s) for s in range(6)]
    pipeline.denoise_many(vols, cfg, window=window)

    # Reconstruct the in-flight count over the event stream: dispatched
    # volumes not yet synced.  The window invariant allows window+1 (the
    # volume being dispatched plus `window` in flight) -- more means the
    # sync stopped gating dispatch.
    in_flight = 0
    max_in_flight = 0
    synced = set()
    for kind, i in events:
        if kind == "dispatch":
            in_flight += 1
            max_in_flight = max(max_in_flight, in_flight)
        elif i not in synced:
            synced.add(i)
            in_flight -= 1
    assert max_in_flight <= window + 1, (
        f"backpressure broken: {max_in_flight} volumes in flight "
        f"(window={window}); events={events}")
    # every volume must eventually sync (the drain loop)
    assert synced == set(range(len(vols)))


def test_denoise_many_to_host():
    """Sustained-service mode: results come back as host arrays (device
    buffers freed as they leave the window) and match per-volume calls."""
    cfg = FilterConfig(sigma=(0.5, 0.5, 0.5), boundary=Boundary.WRAP,
                       flow=FlowConfig(levels=0, winsize=5))
    vols = [make_blob_volume(5, 24, 24, seed=s) for s in (51, 52, 53, 54)]
    batch = denoise_many(vols, cfg, window=2, to_host=True)
    assert all(isinstance(o, np.ndarray) for o in batch)
    for v, out in zip(vols, batch):
        single = np.asarray(denoise(v, cfg))
        np.testing.assert_allclose(out, single, atol=1e-5)
