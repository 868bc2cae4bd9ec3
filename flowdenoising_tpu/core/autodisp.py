"""Automatic ``max_displacement`` selection from the volume's real motion.

The flow samplers bound per-tap displacements to
``FlowConfig.max_displacement`` (D); motions beyond D are clamped during
sampling.  The default D=8 covers FIB-SEM-style sub-pixel drift with room to
spare, but on data with large inter-slice motion it costs quality (QUALITY.md
membranes tier: parity mode lands 0.6-0.8 dB below the cv2 reference because
cv2's ``calcOpticalFlowFarneback`` follows displacements unboundedly,
/root/reference/src/flowdenoising.py:69-79).  Conversely, on calm data a
smaller D loses nothing.

``--max_displacement auto`` picks the bound by measuring what clamping
actually costs, not by raw flow magnitude: optical flow between distant
cross-sections routinely reports large displacements where structure appears
or deforms (no coherent match exists), and clamping those is harmless.  The
probe therefore

- takes a few evenly spaced slice pairs per pass axis at the LARGEST tap
  distance the filter uses (ks2 = kernel_len // 2; per-tap flow grows with
  tap distance, so distance-ks2 pairs bound every tap) and at distance 1
  (bounding the compose modes' ``adjacent_displacement``),
- resizes the planes (INTER_AREA) to a FIXED aspect-bucket shape (square /
  1:4 / 4:1 at ``probe_extent`` area) -- the probe costs ~nothing, plane
  noise is averaged down, large motions shrink into the pyramid's capture
  range, and every volume/axis maps onto a handful of compiled probe
  programs (per-axis scale factors map ladder bounds in full-res pixels
  onto probe-res flow components; buckets bound anisotropic distortion to
  2x),
- solves unbounded Farneback (exact-gather path, ``max_displacement=None``)
  at probe scale, and
- picks the smallest ladder D whose component-clamped flow keeps the warp
  error within ``_BENEFIT_TOL`` of the unbounded flow's TRACKING BENEFIT
  (identity-warp error minus unbounded-warp error) -- i.e. the smallest
  bound that does not lose motions the estimator can genuinely track.

The probe runs on the host CPU backend (:func:`_probe_device`).
"""

from __future__ import annotations

import dataclasses
import functools
import logging

import numpy as np

from flowdenoising_tpu.config import FilterConfig, FlowConfig
from flowdenoising_tpu.kernels import get_gaussian_kernels

# Displacement ladders: small enough steps that the chosen bound stays
# close to the need, few enough that compile variants stay bounded.
_D_LADDER = (4, 6, 8, 12, 16, 24, 32, 48)
_ADJ_LADDER = (2, 3, 4, 6, 8, 12, 16, 24)
# Accepted clamp cost as a fraction of the flow's TRACKING BENEFIT
# (identity-warp error minus unbounded-warp error).  Normalizing by the
# benefit, not the base error, is what makes the probe sensitive: the base
# error is dominated by the noise/resampling floor, so localized clamping
# loss (a few fast filaments) vanishes inside a base-relative tolerance --
# that mis-sizing cost 0.4-0.6 dB on the round-3 membranes tiers
# (scripts/disp_decompose.py: D=8 -0.64 dB vs cv2, D=32 -0.04 dB,
# unbounded 0.00 dB -- the whole parity gap was clamping).  2% of the
# benefit picks D=24-32 there while calm axes still accept the smallest D.
_BENEFIT_TOL = 0.02
_N_PAIRS = 4   # probed slice pairs per axis per distance
# The probe's flow is "tracking" only when its warp error clearly beats the
# identity warp; above this fraction the clamp-cost curve is uninformative
# (see curves_at in probe_displacement).
_UNTRACKED_FRAC = 0.9


def expected_probe_shapes(vol_shape) -> list:
    """(group count, plane shape) of each probe program a volume shape
    needs: per axis, the far+adj group pair buckets by its plane geometry
    (groups sharing a bucket run as one batched program).  Lets the CLI
    warm exactly the right programs from the header alone."""
    by: dict = {}
    for axis in range(3):
        plane = tuple(s for i, s in enumerate(vol_shape) if i != axis)
        b = _bucket_shape(plane[0], plane[1], 128)
        by[b] = by.get(b, 0) + 2  # far + adj group
    return [(n, s) for s, n in by.items()]


def _probe_device():
    """The device the probe programs run on: the host CPU backend.

    Measured on an H100 (CHANGES.md, PR 1): the probe program's XLA
    compile takes ~40 s for the GPU against ~9 s for the CPU, and warm
    (persistent cache) runs tie at ~5-6 s, so the CPU is the faster home
    for this once-per-run program."""
    import jax
    return jax.local_devices(backend="cpu")[0]


def warm_probe_programs_async(flow_cfg: FlowConfig, vol_shape):
    """Start loading/compiling the probe programs a volume of ``vol_shape``
    needs (``expected_probe_shapes``; the CLI reads the shape from the file
    header) in a background thread, so the probe's cold cost overlaps the
    volume read.  Join the returned thread before probing."""
    import threading

    mains = expected_probe_shapes(vol_shape)

    def work():
        import jax

        with jax.default_device(_probe_device()):
            for g, shape in mains:
                prog = _probe_program(flow_cfg, g, _N_PAIRS, shape,
                                      len(_D_LADDER))
                t = np.zeros((g * _N_PAIRS,) + shape, np.float32)
                b = np.full((g, len(_D_LADDER), 2), 4.0, np.float32)
                jax.block_until_ready(prog(t, t, b))

    th = threading.Thread(target=work, name="fdtpu-probe-warm")
    th.start()
    return th


def _probe_pairs(vol: np.ndarray, distance: int, n_pairs: int):
    """(targets, references) stacks of EXACTLY ``n_pairs`` plane pairs at
    the given slice distance along axis 0, evenly spaced (duplicates kept on
    tiny axes so every probe group has the same leading dim -- one compiled
    probe shape serves all volumes)."""
    n = vol.shape[0]
    distance = min(distance, n - 1)
    starts = np.linspace(0, n - 1 - distance, n_pairs).astype(int)
    tgt = np.stack([np.asarray(vol[z], dtype=np.float32) for z in starts])
    ref = np.stack([np.asarray(vol[z + distance], dtype=np.float32)
                    for z in starts])
    return tgt, ref


def _probe_cfg(flow_cfg: FlowConfig) -> FlowConfig:
    # max_displacement=None: the probe samples with the exact, unbounded
    # gather -- it measures what clamping costs.
    return dataclasses.replace(
        flow_cfg, max_displacement=None, precision="float32",
        dtype="float32", tap_mode="solve", use_initial_flow=False)


def _bucket_shape(h: int, w: int, e: int) -> tuple[int, int]:
    """Fixed probe shape for a plane geometry.

    Planes that fit the ``e x e`` square (upscale-only regime) keep the
    square: that is the geometry the benefit-tolerance was calibrated
    against (the quality-tier picks D=24-32 that reach cv2 parity,
    QUALITY.md), and measured A/B showed the aspect-matched bucket UNDER-
    picks there (D=16 where the quality ladder needs 24-32 -- magnifying
    small-axis motion is what keeps the clamp-cost signal resolvable).

    Planes that need DOWNSCALING pick the closest-aspect of three equal-
    area buckets (square, 1:4 wide, 4:1 tall): squashing a 512x2048 side
    plane to a square compresses x 16x but y only 4x, and Farneback's
    isotropic windows then aggregate over 4x-different physical extents per
    axis -- the buckets bound that distortion to 2x.  Each shape persists
    in the compile cache."""
    if h <= e and w <= e:
        return (e, e)
    import math
    cands = ((e, e), (e // 2, 2 * e), (2 * e, e // 2))
    want = math.log(h / w)
    return min(cands, key=lambda s: abs(want - math.log(s[0] / s[1])))


def _resize_group(tgt: np.ndarray, ref: np.ndarray, probe_extent: int):
    """Resize one probe group's plane stacks to the fixed aspect-bucket
    probe shape -- on the HOST (two tiny matmuls with the OpenCV-convention
    area weights; no per-geometry XLA compile).  Returns (t, r, su, sv)
    with the per-axis full-res-px / probe-px scale factors.  Small axes are
    upscaled (area weights degenerate to bilinear); every volume and axis
    thus maps onto one of a handful of probe geometries."""
    from flowdenoising_tpu.ops.resize import area_resize_matrix

    h, w = tgt.shape[-2:]
    eh, ew = _bucket_shape(h, w, probe_extent)
    wr = area_resize_matrix(h, eh)
    wc = area_resize_matrix(w, ew)

    def rs(x):
        return np.einsum("eh,nhw,fw->nef", wr,
                         np.asarray(x, np.float64), wc,
                         optimize=True).astype(np.float32)

    return rs(tgt), rs(ref), w / ew, h / eh


@functools.lru_cache(maxsize=16)
def _probe_program(flow_cfg: FlowConfig, n_groups: int, n_pairs: int,
                   shape: tuple[int, int], n_ladder: int):
    """ONE jitted program computing the whole probe for a fixed geometry:
    batched unbounded Farneback solve over all groups' plane pairs, then
    per-group mean-abs warp error at every ladder bound, the unbounded
    flow's error, and the identity-warp error.

    A single program means a single XLA compile that the persistent
    compilation cache stores (CPU-backend executables persist too).  A
    probe built from dozens of sub-0.5 s eager ops per plane geometry
    would fall below the cache's persistence threshold and re-pay every
    compile in every process.
    """
    import jax
    import jax.numpy as jnp
    from flowdenoising_tpu.ops.farneback import farneback_flow
    from flowdenoising_tpu.ops.warp import warp_slices

    pcfg = _probe_cfg(flow_cfg)

    def group_mean(x):
        return jnp.mean(jnp.abs(x).reshape(n_groups, -1), axis=1)

    @jax.jit
    def run(t, r, bounds):
        # t, r: (n_groups*n_pairs, *shape) float32
        # bounds: (n_groups, n_ladder, 2) clamp bounds in PROBE-res pixels
        flow = farneback_flow(r, t, pcfg)

        def one_level(bl):  # bl: (n_groups, 2) -> per-group errors
            b = jnp.repeat(bl, n_pairs, axis=0)[:, None, None, :]
            return group_mean(warp_slices(r, jnp.clip(flow, -b, b)) - t)

        errs = jax.lax.map(one_level, jnp.moveaxis(bounds, 1, 0))  # (L, G)
        base = group_mean(warp_slices(r, flow) - t)
        ident = group_mean(r - t)
        return errs.T, base, ident

    return run


def _run_probe(groups_resized, ladders, flow_cfg: FlowConfig):
    """Execute the fixed-shape probe programs over the resized groups.

    groups_resized: list of (t, r, su, sv); ladders: per-group D tuples
    (full-res pixels).  Groups sharing an aspect-bucket shape run as ONE
    batched program call; results come back in input order.  Returns
    per-group (curve, base, ident) floats."""
    n_pairs = groups_resized[0][0].shape[0]
    n_ladder = len(ladders[0])
    out = [None] * len(groups_resized)
    by_shape: dict = {}
    for i, (t, _, _, _) in enumerate(groups_resized):
        by_shape.setdefault(tuple(t.shape[-2:]), []).append(i)
    for shape, idxs in by_shape.items():
        t_all = np.concatenate([groups_resized[i][0] for i in idxs])
        r_all = np.concatenate([groups_resized[i][1] for i in idxs])
        # D is in full-res pixels; flow components are in probe-res pixels.
        bounds = np.asarray(
            [[[d / groups_resized[i][2], d / groups_resized[i][3]]
              for d in ladders[i]] for i in idxs], np.float32)
        prog = _probe_program(flow_cfg, len(idxs), n_pairs, shape, n_ladder)
        errs, base, ident = (np.asarray(x) for x in prog(t_all, r_all, bounds))
        for j, i in enumerate(idxs):
            out[i] = (errs[j].tolist(), float(base[j]), float(ident[j]))
    return out


def _pick_bound(costs_by_axis, stats_by_axis, ladder, label) -> int:
    """Smallest ladder D acceptable on EVERY probed axis: clamp cost
    (curve - base) within ``_BENEFIT_TOL`` of that axis's tracking benefit
    (ident - base).  Axes whose flow does not beat the identity warp have
    ~zero benefit; they accept any D whose clamp does not add error (and
    are floored separately via the untrackable list)."""
    for i, d in enumerate(ladder):
        if all(c[i] - b <= _BENEFIT_TOL * max(ident - b, 0.0) + 1e-6
               for c, (b, ident) in zip(costs_by_axis, stats_by_axis)):
            return d
    logging.warning(
        f"auto {label}: even D={ladder[-1]} clamps motion the flow tracks "
        f"(the sampling kernels bound displacements; residual clamping "
        f"matches the fixed-D behavior)")
    return ladder[-1]


def probe_displacement(vol: np.ndarray, cfg: FilterConfig,
                       probe_extent: int = 128) -> tuple[int, int]:
    """Measure the volume's motion scale and return
    ``(max_displacement, adjacent_displacement)`` from the ladders.

    ``vol`` may be any array-like with numpy slicing (ndarray or np.memmap
    in stored dtype); only ~``3 axes * 2 * _N_PAIRS`` planes are touched.
    For memory-mapped input the axis-1/2 planes are strided reads that
    fault in pages across the file -- bounded by a few file-scans' worth,
    small next to the 3 passes' own volume-sized I/O.

    Cost shape: all probe groups (axis x tap-distance) are resized to ONE
    fixed (probe_extent^2) geometry and solved in ONE batched Farneback
    call, so the first-call cost is a single compile of a single program
    shape shared by every volume -- not one compile per plane geometry
    (round-3 QUALITY.md measured an 18 s first probe from exactly those
    per-shape compiles).  The 2x escalation re-solves one group at a time
    at a second fixed shape.
    """
    import jax

    kernels = get_gaussian_kernels(cfg.sigma)
    far_costs, far_stats, adj_costs, adj_stats = [], [], [], []
    untrackable = []

    # Collect every probe group first (host-side slicing only).
    groups = []  # (label, ladder, tgt_planes, ref_planes)
    for axis in range(3):
        ks2 = len(kernels[axis]) // 2
        if ks2 == 0 or vol.shape[axis] < 2:
            continue
        v = np.moveaxis(np.asarray(vol), axis, 0) if axis else vol
        dist_far = min(ks2, vol.shape[axis] - 1)
        tgt, ref = _probe_pairs(v, dist_far, _N_PAIRS)
        groups.append((f"axis{axis}/far", _D_LADDER, tgt, ref))
        if dist_far > 1:
            tgt, ref = _probe_pairs(v, 1, _N_PAIRS)
        groups.append((f"axis{axis}/adj", _ADJ_LADDER, tgt, ref))

    def run():
        resized = [_resize_group(tgt, ref, probe_extent)
                   for _, _, tgt, ref in groups]
        results = _run_probe(resized, [lad for _, lad, _, _ in groups],
                             cfg.flow)
        for (label, ladder, tgt, ref), (curve, base, ident) in zip(groups,
                                                                   results):
            if base > _UNTRACKED_FRAC * ident:
                # Escalation: the downsampled probe's pyramid is clamped to
                # ~2 levels, so motion it cannot track leaves the unbounded
                # warp error ~at the identity-warp error -- a small-D pick
                # from such a curve would be unfounded.  Re-probe this group
                # at 2x extent (its own fixed single-group shape); if the
                # flow still barely beats the identity warp, flag the axis
                # so the pick is floored at the fixed default.
                (curve, base, ident), = _run_probe(
                    [_resize_group(tgt, ref, 2 * probe_extent)], [ladder],
                    cfg.flow)
                if base > _UNTRACKED_FRAC * ident:
                    untrackable.append(label)
            if label.endswith("/far"):
                far_costs.append(curve)
                far_stats.append((base, ident))
            else:
                adj_costs.append(curve)
                adj_stats.append((base, ident))

    if groups:
        with jax.default_device(_probe_device()):
            run()

    if not far_costs:
        return (cfg.flow.max_displacement or _D_LADDER[1],
                cfg.flow.adjacent_displacement or _ADJ_LADDER[2])
    max_d = _pick_bound(far_costs, far_stats, _D_LADDER, "max_displacement")
    adj_d = min(max_d, _pick_bound(adj_costs, adj_stats, _ADJ_LADDER,
                                   "adjacent_displacement"))
    if untrackable:
        # Probe could not distinguish bounds on these curves; never pick a
        # bound TIGHTER than the fixed defaults there.  Far and adjacent
        # curves floor independently: an informative far curve must not
        # launder an uninformative adjacent pick (or vice versa).
        far_unt = [u for u in untrackable if u.endswith("/far")]
        adj_unt = [u for u in untrackable if u.endswith("/adj")]
        floor_d = cfg.flow.max_displacement or 8
        floor_adj = cfg.flow.adjacent_displacement or _ADJ_LADDER[2]
        if far_unt and max_d < floor_d:
            logging.warning(
                f"auto max_displacement: probe flow barely beats the "
                f"identity warp on {far_unt} (motion the probe scale "
                f"cannot track?); flooring pick {max_d} at the fixed "
                f"default {floor_d}")
            max_d = floor_d
        if adj_unt and adj_d < min(max_d, floor_adj):
            logging.warning(
                f"auto adjacent_displacement: uninformative adjacent probe "
                f"on {adj_unt}; flooring pick {adj_d} at the fixed "
                f"default {min(max_d, floor_adj)}")
            adj_d = min(max_d, floor_adj)
    logging.info(f"auto max_displacement: probed clamp-cost curves -> "
                 f"max_displacement={max_d}, adjacent_displacement={adj_d}")
    return max_d, adj_d


def resolve_auto_displacement(vol: np.ndarray,
                              cfg: FilterConfig) -> FilterConfig:
    """Return ``cfg`` with probed displacement bounds filled in."""
    max_d, adj_d = probe_displacement(vol, cfg)
    return dataclasses.replace(
        cfg, flow=dataclasses.replace(cfg.flow, max_displacement=max_d,
                                      adjacent_displacement=adj_d))
