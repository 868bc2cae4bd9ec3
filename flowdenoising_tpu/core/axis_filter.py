"""Per-axis filtering passes (the reference's L2 "filtering core").

Two pass kinds, both operating along axis 0 of a (N, H, W) stack (the
pipeline transposes the volume so the filtered axis is always leading and the
in-plane dims stay contiguous/minor):

- ``gaussian_pass``: plain separable Gaussian correlation along the axis;
  replaces GaussianDenoising.filter_along_*_slice
  (/root/reference/src/flowdenoising.py:133-158).
- ``of_pass``: optical-flow-compensated accumulation; replaces
  FlowDenoising.filter_along_*_slice (/root/reference/src/flowdenoising.py:306-373).
  Per output slice, each kernel tap estimates Farneback flow from the target
  slice to the tap's neighbor slice, warps the neighbor onto the target, and
  accumulates with the tap weight.  Flow is chained tap-to-tap outward from
  the center in two runs (center-1 .. 0 and center+1 .. end), seeded through
  OPTFLOW_USE_INITIAL_FLOW semantics, exactly like the reference.

Design notes:
- All output slices of a pass are processed as one batch; the tap loop is a
  short static unroll (kernel support <= ~33).
- The Gaussian image pyramid and polynomial expansion of every slice are
  computed ONCE per pass and shared by all (target, neighbor) pairs.  The
  reference recomputes them inside cv2 for each of the K-1 tap pairs per
  output slice, i.e. ~2*(K-1) redundant expansions per slice; caching them is
  the single biggest algorithmic win of the rebuild.
- Boundary handling is materialized by padding the stack with ks2 slices per
  side (wrap / mean / replicate; see config.Boundary).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from flowdenoising_tpu.config import Boundary, FlowConfig
from flowdenoising_tpu.ops.farneback import (
    polyexp_pyramid, flow_from_pyramids, matmul_precision)
from flowdenoising_tpu.ops.warp import warp_slices, displace_sample


def pad_stack(vol: jnp.ndarray, pad: int, boundary: Boundary,
              mean_val: jnp.ndarray | float | None = None) -> jnp.ndarray:
    """Pad axis 0 of (N, H, W) by ``pad`` slices per side.

    WRAP matches the reference main CLI's modular indexing
    (flowdenoising.py:137); MEAN matches the sequential variant's
    ``np.full(fill_value=mean)`` padding (flowdenoising_sequential.py:88-89).
    """
    if pad == 0:
        return vol
    n = vol.shape[0]
    if boundary is Boundary.WRAP:
        if pad <= n:
            return jnp.concatenate([vol[-pad:], vol, vol[:pad]], axis=0)
        # Kernel support exceeds the axis (e.g. Z=4 at sigma=2 -> pad=8):
        # slicing would silently under-pad; materialize the reference's
        # modular indexing (flowdenoising.py:137) with a static gather.
        idx = np.arange(-pad, n + pad) % n
        return jnp.take(vol, jnp.asarray(idx), axis=0)
    if boundary is Boundary.REPLICATE:
        return jnp.pad(vol, ((pad, pad), (0, 0), (0, 0)), mode="edge")
    if boundary is Boundary.MEAN:
        if mean_val is None:
            mean_val = jnp.mean(vol)
        fill = jnp.broadcast_to(jnp.asarray(mean_val, vol.dtype), (pad,) + vol.shape[1:])
        return jnp.concatenate([fill, vol, fill], axis=0)
    raise ValueError(f"unknown boundary {boundary}")


def gaussian_pass_padded(padded: jnp.ndarray, taps: np.ndarray) -> jnp.ndarray:
    """Separable Gaussian correlation along axis 0 of a pre-padded stack.

    padded: (N + 2*ks2, H, W) with boundary context already materialized;
    returns the N interior output slices.
    """
    taps = np.asarray(taps, dtype=np.float64)
    ks2 = len(taps) // 2
    padded = padded.astype(jnp.float32)
    n = padded.shape[0] - 2 * ks2
    # Shift-and-add over the pre-padded stack: K fused reads, bandwidth-bound.
    out = None
    for k in range(len(taps)):
        term = padded[k:k + n] * jnp.float32(taps[k])
        out = term if out is None else out + term
    return out


def gaussian_pass(vol: jnp.ndarray, taps: np.ndarray, boundary: Boundary = Boundary.WRAP,
                  mean_val=None) -> jnp.ndarray:
    """Separable Gaussian correlation along axis 0 of (N, H, W)."""
    ks2 = len(taps) // 2
    return gaussian_pass_padded(pad_stack(vol.astype(jnp.float32), ks2, boundary, mean_val), taps)


def _estimation_stack(padded: jnp.ndarray, flow_cfg: FlowConfig) -> jnp.ndarray:
    """The stack flows are ESTIMATED from: the raw padded stack, or a
    lightly in-plane-blurred copy when ``flow_cfg.presmooth`` is set.

    Pre-smoothing only the estimation operands (polyexp pyramids, iteration
    sampling) suppresses per-pixel flow noise -- the driver of the sampling
    kernels' trip counts on noisy inputs -- while every tap warp still
    samples the raw volume, so no signal is blurred into the output.
    """
    if not flow_cfg.presmooth or flow_cfg.presmooth <= 0:
        return padded
    from flowdenoising_tpu.ops.blur import gaussian_blur
    ks = max(3, int(round(flow_cfg.presmooth * 4.0)) | 1)
    return gaussian_blur(padded, ks, flow_cfg.presmooth)


def of_pass_padded(padded: jnp.ndarray, taps: np.ndarray, flow_cfg: FlowConfig) -> jnp.ndarray:
    """OF-compensated Gaussian pass along axis 0 of a pre-padded stack.

    padded: (N + 2*ks2, H, W) with boundary context already materialized;
    returns the N interior output slices.

    Equivalent math to FlowDenoising.filter_along_Z_slice applied to every z
    at once (flowdenoising.py:306-327): two outward tap runs with chained
    prev_flow, center tap unwarped.
    """
    if flow_cfg.tap_mode != "solve":
        return _of_pass_composed(padded, taps, flow_cfg)
    taps = np.asarray(taps, dtype=np.float64)
    ksize = len(taps)
    assert ksize % 2 == 1, "kernel size must be odd"
    ks2 = ksize // 2
    dtype = jnp.dtype(flow_cfg.dtype)
    padded = padded.astype(dtype)
    n = padded.shape[0] - 2 * ks2
    h, w = padded.shape[1], padded.shape[2]
    vol = padded[ks2:ks2 + n]

    with matmul_precision(flow_cfg):
        acc0 = vol * jnp.asarray(taps[ks2], dtype)

        # Pyramid + polynomial expansion of every (padded) slice, computed
        # once.
        r_levels = polyexp_pyramid(_estimation_stack(padded, flow_cfg),
                                   flow_cfg)
        r0_levels = [r[ks2:ks2 + n] for r in r_levels]

        # Tap loop as lax.scan: the pyramid solver is traced/compiled once
        # instead of 2*ks2 times (compile-time critical at sigma=2 -> 17 taps).
        # The chained prev_flow is the scan carry (reference semantics:
        # flowdenoising.py:310-324), channels-last (n, h, w, 2).
        def body(carry, xs):
            prev_flow, acc = carry
            start, weight = xs
            r1_levels = [
                jax.lax.dynamic_slice_in_dim(r, start, n, axis=0)
                for r in r_levels
            ]
            flow = flow_from_pyramids(
                r0_levels, r1_levels, flow_cfg,
                prev_flow if flow_cfg.use_initial_flow else None)
            # pin the scan carry type to the compute dtype
            flow = flow.astype(dtype)
            u, v = flow[..., 0], flow[..., 1]
            neighbor = jax.lax.dynamic_slice_in_dim(padded, start, n, axis=0)
            warped = displace_sample(neighbor, u, v,
                                     flow_cfg.max_displacement)
            acc = acc + (warped * weight).astype(dtype)
            return (flow, acc), None

        def run(offsets, weights, acc):
            # Zero initial flow, derived from the (possibly shard_map-varying)
            # volume so the scan carry has consistent varying-manual-axes
            # typing inside shard_map.
            prev_flow = (jnp.zeros((n, h, w, 2), dtype=dtype)
                         + vol[..., None] * 0)
            xs = (jnp.asarray([ks2 + o for o in offsets], jnp.int32),
                  jnp.asarray(weights, dtype))
            (_, acc), _ = jax.lax.scan(body, (prev_flow, acc), xs)
            return acc

        # Backward run: i = ks2-1 .. 0  <=> offsets -1 .. -ks2, weights taps[i].
        acc = run([-j for j in range(1, ks2 + 1)],
                  [taps[ks2 - j] for j in range(1, ks2 + 1)], acc0)
        # Forward run: i = ks2+1 .. K-1 <=> offsets +1 .. +ks2.
        acc = run([+j for j in range(1, ks2 + 1)],
                  [taps[ks2 + j] for j in range(1, ks2 + 1)], acc)
    return acc.astype(jnp.float32)


def compose_tap_step(link, flow, neighbor, acc, weight, d):
    """One tap of the composed-flow scan: extend the carried flow by the
    chain link sampled at it (F_j = F_{j-1} + warp(link, F_{j-1})), warp
    the neighbor slice by F_j and accumulate it with the tap weight.

    link, flow: (n, h, w, 2); neighbor, acc: (n, h, w).  Returns the new
    (flow, acc) carry in the carry's dtype."""
    dtype = flow.dtype
    warped_link = displace_sample(link, flow[..., 0], flow[..., 1], d,
                                  channels_last=True)
    flow = (flow + warped_link).astype(dtype)
    warped = warp_slices(neighbor, flow, d)
    return flow, acc + (warped * weight).astype(acc.dtype)


def _of_pass_composed(padded: jnp.ndarray, taps: np.ndarray,
                      flow_cfg: FlowConfig) -> jnp.ndarray:
    """Composed-flow OF pass (FlowConfig.tap_mode "compose").

    Redesign of the tap loop: instead of one seeded pyramid solve
    per (target, neighbor) pair (2*ks2 solves per output slice,
    flowdenoising.py:310-324), Farneback runs once per DIRECTION on all
    adjacent slice pairs of the stack, and the flow to a tap at distance j
    is built by composing the chain of adjacent fields:

        F_1 = a_z;   F_j = F_{j-1} + warp(a_{z+j-1}, F_{j-1})

    (same outward two-run structure, composition replaces the solve).  The
    adjacent-tap flows are exactly the solve-mode flows; farther taps are
    approximations (quality measured per tier in QUALITY.md).  Beyond the
    ~8x solve-count reduction this drops the pyramid expansions from the
    tap scan's live set, shrinking the pass working set.
    """
    taps = np.asarray(taps, dtype=np.float64)
    ksize = len(taps)
    assert ksize % 2 == 1, "kernel size must be odd"
    ks2 = ksize // 2
    dtype = jnp.dtype(flow_cfg.dtype)
    padded = padded.astype(dtype)
    n = padded.shape[0] - 2 * ks2
    h, w = padded.shape[1], padded.shape[2]
    vol = padded[ks2:ks2 + n]
    d = flow_cfg.max_displacement

    # Adjacent-pair solves use a tightened displacement bound (adjacent
    # motion is sub-pixel drift; the composed/tap warps keep the full one).
    adj_cfg = flow_cfg
    if (flow_cfg.adjacent_displacement is not None
            and flow_cfg.max_displacement is not None):
        import dataclasses
        adj_cfg = dataclasses.replace(
            flow_cfg, max_displacement=min(flow_cfg.max_displacement,
                                           flow_cfg.adjacent_displacement))

    with matmul_precision(flow_cfg):
        r_levels = polyexp_pyramid(_estimation_stack(padded, flow_cfg),
                                   flow_cfg)
        lo = [r[:-1] for r in r_levels]
        hi = [r[1:] for r in r_levels]
        # a[k]: flow target slice k -> reference k+1 (forward chain link);
        # b[k]: flow target slice k+1 -> reference k (backward chain link).
        adj_fwd = flow_from_pyramids(lo, hi, adj_cfg, None).astype(dtype)
        if flow_cfg.symmetric_adjacent:
            # First-order inverse of the forward field (small-motion regime).
            adj_bwd = -adj_fwd
        else:
            adj_bwd = flow_from_pyramids(hi, lo, adj_cfg, None).astype(dtype)
        acc0 = vol * jnp.asarray(taps[ks2], dtype)

        def body_of(adj, adj_shift):
            def body(carry, xs):
                flow, acc = carry
                start, weight = xs
                link = jax.lax.dynamic_slice_in_dim(
                    adj, start + adj_shift, n, axis=0)
                neighbor = jax.lax.dynamic_slice_in_dim(padded, start, n, axis=0)
                return compose_tap_step(link, flow, neighbor, acc, weight,
                                        d), None
            return body

        def run(offsets, weights, acc, adj, adj_shift):
            flow0 = jnp.zeros((n, h, w, 2), dtype=dtype) + vol[..., None] * 0
            xs = (jnp.asarray([ks2 + o for o in offsets], jnp.int32),
                  jnp.asarray(weights, dtype))
            (_, acc), _ = jax.lax.scan(body_of(adj, adj_shift), (flow0, acc), xs)
            return acc

        # Backward run (offsets -1..-ks2): link for distance j is
        # b_{z-j+1} = adj_bwd[z-j] -> padded index start (= ks2+i-j).
        acc = run([-j for j in range(1, ks2 + 1)],
                  [taps[ks2 - j] for j in range(1, ks2 + 1)], acc0,
                  adj_bwd, 0)
        # Forward run (offsets +1..+ks2): link a_{z+j-1} -> index start-1.
        acc = run([+j for j in range(1, ks2 + 1)],
                  [taps[ks2 + j] for j in range(1, ks2 + 1)], acc,
                  adj_fwd, -1)
    return acc.astype(jnp.float32)


def of_pass(vol: jnp.ndarray, taps: np.ndarray, flow_cfg: FlowConfig,
            boundary: Boundary = Boundary.WRAP, mean_val=None) -> jnp.ndarray:
    """OF-compensated Gaussian pass along axis 0 of (N, H, W)."""
    ks2 = len(taps) // 2
    dtype = jnp.dtype(flow_cfg.dtype)
    padded = pad_stack(vol.astype(dtype), ks2, boundary, mean_val)
    return of_pass_padded(padded, taps, flow_cfg)
