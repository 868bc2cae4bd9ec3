"""Auto max_displacement probing (core/autodisp.py).

The probe must pick a small bound on calm data (speed) and a large enough
bound on fast-drifting data (quality: QUALITY.md membranes tier showed the
fixed D=8 default clamping real motions the cv2 reference follows,
/root/reference/src/flowdenoising.py:69-79).
"""

import numpy as np
import pytest

from conftest import make_blob_image, make_blob_volume
from flowdenoising_tpu.config import FilterConfig
from flowdenoising_tpu.core.autodisp import (
    probe_displacement, resolve_auto_displacement)


def make_shift_volume(n, h, w, px_per_slice, seed=3):
    """Slices translate uniformly by px_per_slice along x per step."""
    pad = int(np.ceil(px_per_slice * n)) + 4
    base = make_blob_image(h, w + 2 * pad, n_blobs=30, seed=seed, pad=8)
    vol = np.zeros((n, h, w), np.float32)
    for z in range(n):
        off = int(round(z * px_per_slice))
        vol[z] = base[:h, off:off + w]
    return vol


def test_calm_volume_picks_small_bound():
    vol = make_blob_volume(24, 96, 96, seed=1, drift=0.3)
    cfg = FilterConfig(sigma=(2.0, 2.0, 2.0))
    max_d, adj_d = probe_displacement(vol, cfg)
    assert max_d <= 8
    assert adj_d <= 4
    assert adj_d <= max_d


def test_fast_drift_raises_bound():
    # 2 px/slice along x: at tap distance ks2=8 the displacement is ~16 px,
    # beyond the default D=8 clamp.
    vol = make_shift_volume(24, 96, 96, px_per_slice=2.0)
    cfg = FilterConfig(sigma=(2.0, 2.0, 2.0))
    max_d, adj_d = probe_displacement(vol, cfg)
    assert max_d >= 12
    assert adj_d <= 6  # adjacent motion is still only ~2 px


def test_expected_probe_shapes():
    """Header-shape -> probe-program-shape prediction must match what the
    probe actually runs: cubic volumes batch all 6 groups in the square
    bucket; flat tomogram stacks (Z << Y = X, the reference's real-data
    geometry) split 2 square + 4 one-to-four groups."""
    from flowdenoising_tpu.core.autodisp import expected_probe_shapes

    assert expected_probe_shapes((128, 128, 128)) == [(6, (128, 128))]
    assert sorted(expected_probe_shapes((160, 512, 512))) == [
        (2, (128, 128)), (4, (64, 256))]


def test_untrackable_large_drift_floors_at_default():
    """Large labeled drift whose CONTENT decorrelates slice-to-slice
    (independent noise textures): no coherent match exists, the probe flow
    cannot beat the identity warp, and the pick must FLOOR at the fixed
    default instead of trusting an uninformative clamp-cost curve (the
    autodisp floor path, core/autodisp.py untrackable escalation)."""
    rng = np.random.default_rng(21)
    # real 3 px/slice drift buried under per-slice noise at ~6x the
    # structure amplitude: the motion is large AND untrackable
    vol = make_shift_volume(24, 96, 96, px_per_slice=3.0)
    vol += rng.normal(size=vol.shape).astype(np.float32) * 6 * vol.std()
    cfg = FilterConfig(sigma=(2.0, 2.0, 2.0))
    max_d, adj_d = probe_displacement(vol, cfg)
    assert max_d >= 8, max_d   # floored at the fixed default, never tighter
    assert adj_d >= 4, adj_d


def test_resolve_fills_config():
    vol = make_blob_volume(16, 64, 64, seed=2)
    cfg = FilterConfig(sigma=(1.5, 1.5, 1.5))
    out = resolve_auto_displacement(vol, cfg)
    assert isinstance(out.flow.max_displacement, int)
    assert isinstance(out.flow.adjacent_displacement, int)
    assert out.flow.adjacent_displacement <= out.flow.max_displacement
    # everything else unchanged
    assert out.sigma == cfg.sigma
    assert out.flow.levels == cfg.flow.levels


def test_cli_accepts_auto_and_rejects_garbage(tmp_path):
    from flowdenoising_tpu.cli import build_parser, main

    args = build_parser().parse_args(["--max_displacement", "auto"])
    assert args.max_displacement == "auto"

    with pytest.raises(SystemExit):
        main(["-i", str(tmp_path / "x.mrc"), "-o", str(tmp_path / "y.mrc"),
              "--max_displacement", "bogus"])


@pytest.mark.slow
def test_cli_auto_end_to_end(tmp_path):
    from flowdenoising_tpu.cli import main
    from flowdenoising_tpu.io.volume import read_volume, write_volume

    vol = make_blob_volume(10, 48, 48, seed=4)
    src, dst = tmp_path / "in.mrc", tmp_path / "out.mrc"
    write_volume(str(src), vol)
    assert main(["-i", str(src), "-o", str(dst), "-s", "1.0", "1.0", "1.0",
                 "--max_displacement", "auto"]) == 0
    out = read_volume(str(dst))
    assert out.shape == vol.shape
    assert np.all(np.isfinite(out))


def test_pick_bound_normalizes_by_tracking_benefit():
    """The round-3 regression this guards: a clamp cost that is tiny
    relative to the noise-floored BASE error but large relative to the
    tracking BENEFIT must push the pick up the ladder (membranes tiers:
    base ~23, benefit ~8, clamp cost at D=12 ~1.6 -- 7% of base passed the
    old base-relative 5% rule; 19% of benefit fails the 2% benefit rule)."""
    import flowdenoising_tpu.core.autodisp as A

    ladder = A._D_LADDER
    base, ident = 23.0, 31.0  # benefit = 8
    # clamp costs shaped like the measured membranes ax1/far curve
    curve = [base + c for c in (4.3, 3.4, 2.5, 1.6, 1.1, 0.4, 0.09, 0.0)]
    d = A._pick_bound([curve], [(base, ident)], ladder, "max_displacement")
    assert d >= 32, d
    # calm axis: flat curve accepts the smallest D
    flat = [base] * len(ladder)
    assert A._pick_bound([flat], [(base, ident)], ladder, "x") == ladder[0]
    # untracked axis (no benefit): any non-degrading clamp is acceptable
    assert A._pick_bound([[5.0] * len(ladder)], [(5.0, 5.0)], ladder,
                         "x") == ladder[0]


def test_adjacent_floor_independent_of_far(monkeypatch):
    """An uninformative ADJACENT probe must floor the adjacent pick even
    when the far curve is informative (and vice versa)."""
    import flowdenoising_tpu.core.autodisp as A
    from flowdenoising_tpu.config import FilterConfig

    def fake_run_probe(resized, ladders, flow_cfg):
        out = []
        for lad in ladders:
            if tuple(lad) == A._D_LADDER:
                # trackable far curve whose smallest lossless pick is D=8
                out.append(([2.0, 2.0] + [1.0] * (len(lad) - 2), 1.0, 10.0))
            else:
                # adjacent: flow barely beats identity -> untrackable
                out.append(([9.6] * len(lad), 9.6, 10.0))
        return out

    monkeypatch.setattr(A, "_run_probe", fake_run_probe)
    vol = make_blob_volume(12, 32, 32, seed=44)
    max_d, adj_d = A.probe_displacement(vol, FilterConfig())
    assert max_d == 8
    assert adj_d == 4  # floored at min(max_d, default 4), not the ladder min 2
