"""Configuration dataclasses for the denoising pipeline.

Defaults mirror the reference CLI constants at
/root/reference/src/flowdenoising.py:47-53 (OF_LEVELS=3, OF_WINDOW_SIZE=5,
OF_ITERS=3, OF_POLY_N=5, OF_POLY_SIGMA=1.2, SIGMA=2.0) and its boundary
semantics (wrap-around modular indexing, flowdenoising.py:137; the sequential
variant mean-pads instead, flowdenoising_sequential.py:88-89 -- both are
selectable here, plus a `replicate` mode).
"""

from __future__ import annotations

import dataclasses
import enum


# Displacement sampler forms ``FlowConfig.sampler`` accepts.  One form
# remains: bilinear sampling by gathers at the clamped displacement
# (ops/warp.py), which "auto" names too.
SAMPLERS = ("auto", "gather")


class Boundary(str, enum.Enum):
    """Boundary handling for the filtered axis.

    WRAP      -- modular indexing, matches the reference main CLI
                 (flowdenoising.py:137: ``vol[(z + i - ks2) % Z]``).
    MEAN      -- pad with the volume mean, matches the sequential variant
                 (flowdenoising_sequential.py:88-89).
    REPLICATE -- clamp to the edge slice (new, often the best choice for
                 tomography stacks).
    """

    WRAP = "wrap"
    MEAN = "mean"
    REPLICATE = "replicate"


@dataclasses.dataclass(frozen=True)
class FlowConfig:
    """Farneback optical-flow estimator parameters.

    Field-for-field equivalent of the cv2.calcOpticalFlowFarneback call at
    /root/reference/src/flowdenoising.py:69-79.
    """

    levels: int = 3          # -l / --levels (pyramid levels above full res)
    winsize: int = 5         # -w / --winsize (box aggregation window)
    iterations: int = 3      # OF_ITERS
    poly_n: int = 5          # OF_POLY_N (polynomial expansion half-window)
    poly_sigma: float = 1.2  # OF_POLY_SIGMA
    pyr_scale: float = 0.5   # fixed in the reference
    use_initial_flow: bool = True  # OPTFLOW_USE_INITIAL_FLOW seeding; False
                                   # reproduces --recompute_flow
    # Minimum pyramid image extent; levels are clamped so the coarsest image
    # is at least this wide/tall (OpenCV farneback.cpp min_size).
    min_size: int = 32
    # Compute dtype for flow internals.  float32 matches the reference.
    dtype: str = "float32"
    # Ambient matmul precision of the flow computation ("float32" or
    # "bfloat16"), set with jax.default_matmul_precision around it.  Every
    # matmul on the path (the pyramid resizes, ops/resize.py) pins HIGHEST
    # and the blurs are shift-and-add, so at present "bfloat16" does not
    # change the arithmetic.  Output accumulation is float32 either way.
    precision: str = "float32"
    # Displacement bound (pixels) of the flow samplers: per-component
    # displacements are clamped to [-D, D] (identical to unbounded sampling
    # whenever |flow| <= D).  None samples unbounded.
    max_displacement: int | None = 8
    # Displacement sampler form, one of SAMPLERS.  Unknown names raise
    # ValueError.
    sampler: str = "auto"
    # How per-tap flows are obtained (the reference solves Farneback anew
    # for every (target, neighbor) tap pair, flowdenoising.py:310-324):
    #   "solve"          -- reference-parity: one seeded pyramid solve per tap.
    #   "compose"        -- fast mode: solve only ADJACENT slice pairs (one
    #                       batched solve per direction per pass), then chain
    #                       tap flows by composing flow fields:
    #                       F_{z->z+j} = F_{z->z+j-1} + warp(a_{z+j-1}, F_{z->z+j-1}).
    #                       ~8x fewer pyramid solves; identical for the
    #                       adjacent taps, approximate beyond them.
    # (A third mode, "compose_refine" -- one full-resolution re-anchor
    # iteration per composed tap -- was REMOVED in v0.5.0: a measured
    # trust-region ladder (clip 0/0.5/0.75/1.5 px, 1-2 iterations, all
    # QUALITY tiers) found no setting reaching >= plain compose everywhere;
    # the level-0 re-solve's correction direction is noise-driven.  Best
    # case was +0.1 dB, worst -0.24 dB, at ~2x compose's cost.)
    tap_mode: str = "solve"
    # Displacement bound for the ADJACENT-pair solves of the compose modes.
    # Adjacent-slice motion is sub-pixel drift in FIB-SEM stacks, so a much
    # tighter window than max_displacement (which must cover whole-tap
    # displacements) applies; smaller bounds shrink the sampling halo and
    # shift window of every solve iteration.  None reuses max_displacement.
    adjacent_displacement: int | None = 4
    # Compose modes only: derive the backward chain links as the negated
    # forward fields (b_k ~ -a_k) instead of solving the reverse direction,
    # halving the solve iterations.  First-order exact for small adjacent
    # motion (error O(|a|^2 * flow gradient)); quality impact measured in
    # QUALITY.md.
    symmetric_adjacent: bool = False
    # Estimate flows from a lightly Gaussian-pre-smoothed copy of the
    # operands (sigma in pixels, in-plane); the tap WARPS still sample the
    # raw volume.  On noisy inputs the per-pixel flow NOISE (std ~1.4 px on
    # the bench volume) degrades the estimated flows, and pre-smoothing the
    # ESTIMATION operands collapses it.  0 disables (exact reference
    # operand semantics); quality impact measured in QUALITY.md.
    presmooth: float = 0.0

    def __post_init__(self):
        if self.sampler not in SAMPLERS:
            raise ValueError(f"unknown sampler {self.sampler!r}: expected "
                             f"one of {SAMPLERS}")
        if self.tap_mode not in ("solve", "compose"):
            raise ValueError(
                f"unknown tap_mode {self.tap_mode!r}: expected 'solve' or "
                "'compose' ('compose_refine' was removed in v0.5.0 -- it "
                "measured at or below plain 'compose' on every quality tier "
                "at ~2x the cost; use 'compose')")

    def clamped_levels(self, height: int, width: int) -> int:
        """Number of pyramid levels actually used for an image size.

        Reproduces OpenCV's clamping loop: stop before a level whose scaled
        extent would drop below ``min_size``.
        """
        k = 0
        scale = 1.0
        while k < self.levels:
            scale *= self.pyr_scale
            if width * scale < self.min_size or height * scale < self.min_size:
                break
            k += 1
        return k


@dataclasses.dataclass(frozen=True)
class FilterConfig:
    """Separable OF-compensated Gaussian filter parameters."""

    sigma: tuple[float, float, float] = (2.0, 2.0, 2.0)  # (Z, Y, X)
    boundary: Boundary = Boundary.WRAP
    use_flow: bool = True     # False == -n / --no_OF
    flow: FlowConfig = dataclasses.field(default_factory=FlowConfig)
    # Output slices are processed in slabs of this many slices to bound the
    # device-memory footprint; None = sized by the pipeline's slab model.
    slab_size: int | None = None
