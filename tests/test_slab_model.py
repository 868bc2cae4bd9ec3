"""Auto slab sizing: budget from the device's memory limit, fixed on CPU."""

import pytest

import flowdenoising_tpu.core.pipeline as pl
from flowdenoising_tpu.config import FilterConfig, FlowConfig


class _Device:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("limit", [16 * 2**30, int(0.75 * 80e9)])
def test_budget_is_a_share_of_bytes_limit(limit):
    budget = pl.slab_budget(_Device({"bytes_limit": limit,
                                     "bytes_in_use": 123}))
    assert budget == int(pl._DEVICE_BUDGET_FRACTION * limit)
    assert 0 < budget < limit


@pytest.mark.parametrize("stats", [None, {}, {"bytes_in_use": 5}])
def test_cpu_backend_keeps_fixed_budget(stats):
    """A backend that reports no limit (the CPU) gets the fixed budget."""
    assert pl.slab_budget(_Device(stats)) == pl._CPU_SLAB_BUDGET


def test_default_device_on_cpu_uses_fixed_budget():
    assert pl.slab_budget() == pl._CPU_SLAB_BUDGET


def test_auto_slab_whole_axis_when_it_fits_and_bounded_when_not(monkeypatch):
    per_slice = 64 * 64 * pl._BYTES_PER_VOXEL
    monkeypatch.setattr(pl, "_CPU_SLAB_BUDGET", int((100 + 16) * per_slice))
    assert pl._auto_slab(100, 64, 64, 8, True, "solve") is None
    tight = int(40 * per_slice)
    monkeypatch.setattr(pl, "_CPU_SLAB_BUDGET", tight)
    slab = pl._auto_slab(100, 64, 64, 8, True, "solve")
    assert slab is not None and (slab + 16) * per_slice <= tight
    # compose holds two more adjacent-flow stacks: never a larger slab
    assert pl._auto_slab(100, 64, 64, 8, True, "compose") <= slab
    monkeypatch.setattr(pl, "_CPU_SLAB_BUDGET", 1)
    assert pl._auto_slab(100, 64, 64, 8, False) is None


def test_slab_follows_stubbed_device_limit(monkeypatch):
    """pass_slab sizes from the device's limit: a bigger card, a bigger
    (or no) slab."""
    cfg = FilterConfig(flow=FlowConfig())
    shape = (512, 1024, 1024)
    slabs = []
    for limit in (8 * 2**30, 60 * 2**30):
        monkeypatch.setattr(pl, "slab_budget",
                            lambda device=None, lim=limit:
                            int(pl._DEVICE_BUDGET_FRACTION * lim))
        slabs.append(pl.pass_slab(cfg, shape[0], shape[1], shape[2], 8))
    assert slabs[0] is not None
    assert slabs[1] is None or slabs[1] > slabs[0]


def test_predicted_peak_covers_pass_window_and_volume_buffers():
    cfg = FilterConfig(flow=FlowConfig())
    shape = (40, 48, 56)
    pred = pl.predicted_peak_bytes(cfg, shape)
    vol = 4 * 40 * 48 * 56
    window = (40 + 16) * 48 * 56 * pl._BYTES_PER_VOXEL
    assert pred >= window + 3 * vol
    assert pl.predicted_peak_bytes(
        FilterConfig(flow=FlowConfig(tap_mode="compose")), shape) > pred
    assert pl.predicted_peak_bytes(FilterConfig(use_flow=False), shape) < pred
