"""Three-pass Z -> Y -> X denoising pipeline (the reference's L3 driver).

Replaces GaussianDenoising.filter / FlowDenoising.filter and the chunked
thread/process schedulers (/root/reference/src/flowdenoising.py:160-295): on
the device the per-slice fan-out collapses into batched passes, and the
ping-pong buffer swap becomes functional dataflow between three jit-fused
passes.

Axis handling: each pass filters along axis 0 of a transposed view so the
in-plane dims stay contiguous:
- Z pass: (Z, Y, X) as-is; OF planes are (Y, X).
- Y pass: transpose to (Y, Z, X); OF planes are (Z, X)  [matches
  reference slices vol[:, y, :]].
- X pass: transpose to (X, Z, Y); OF planes are (Z, Y)  [matches
  vol[:, :, x]].

The volume mean used for MEAN-boundary padding is computed once from the
input volume and reused for all three passes, matching OF_filter
(flowdenoising_sequential.py:419-424).

Slab mode: when ``slab_size`` is set, each pass processes the output axis in
slabs of that many slices (with kernel-support halo recomputed per slab) to
bound the device-memory footprint for large volumes; results are bitwise
identical to the whole-axis pass.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from flowdenoising_tpu.config import Boundary, FilterConfig, FlowConfig
from flowdenoising_tpu.core.axis_filter import (
    gaussian_pass_padded, of_pass_padded, pad_stack)
from flowdenoising_tpu.kernels import get_gaussian_kernels


def slabbed_padded_pass(padded_pass_fn, padded, taps, n, slab_size):
    """Run a pass over axis-0 slabs of an ALREADY-padded stack.

    ``padded`` holds ``n + 2*ks2`` slices (boundary/halo context included),
    so slab results match the whole-window pass exactly.  The slab loop is a
    lax.scan: slabs are strictly sequential, so XLA keeps ONE slab's working
    set live (a Python loop lets the scheduler overlap independent slabs and
    balloon device memory at limit sizes) and compiles one slab body.
    Shared by the in-memory pipeline and the shard_map path (each shard's
    halo-exchanged window is exactly such a padded stack).
    """
    ks2 = len(taps) // 2
    if slab_size is None or slab_size >= n:
        return padded_pass_fn(padded, taps)

    n_slabs = -(-n // slab_size)
    slab = -(-n // n_slabs)
    extra = n_slabs * slab - n
    if extra:
        tail = jnp.broadcast_to(padded[-1:], (extra,) + padded.shape[1:])
        padded = jnp.concatenate([padded, tail], axis=0)

    def body(out, s):
        window = jax.lax.dynamic_slice_in_dim(padded, s, slab + 2 * ks2, axis=0)
        y = padded_pass_fn(window, taps)
        return jax.lax.dynamic_update_slice_in_dim(out, y, s, axis=0), None

    out0 = jnp.zeros((n_slabs * slab,) + padded.shape[1:], jnp.float32)
    starts = jnp.arange(n_slabs, dtype=jnp.int32) * slab
    out, _ = jax.lax.scan(body, out0, starts)
    return out[:n]


def _slabbed_pass(padded_pass_fn, vol, taps, boundary, mean_val, slab_size):
    """Boundary-pad ``vol`` and run the pass over axis-0 slabs with halo."""
    ks2 = len(taps) // 2
    padded = pad_stack(vol, ks2, boundary, mean_val)
    return slabbed_padded_pass(padded_pass_fn, padded, taps, vol.shape[0],
                               slab_size)


def _axis_views():
    """(forward transpose, inverse transpose) per pass in Z, Y, X order."""
    return [
        ((0, 1, 2), (0, 1, 2)),   # Z: identity
        ((1, 0, 2), (1, 0, 2)),   # Y: (Y, Z, X); inverse is itself
        ((2, 0, 1), (1, 2, 0)),   # X: (X, Z, Y)
    ]


# Working-set model for auto slab sizing, in bytes per voxel of a pass
# window (its padded slices x the plane), float32: the polynomial-expansion
# pyramids of the window (5 ch x ~1.4 for the coarser levels), the per-tap
# reference slice of them (the same again), the iteration's M and sampled
# reference (2 x 5 ch), and the flow carries, accumulator, estimation copy
# and the stack itself (~8 ch-equivalents).
_BYTES_PER_VOXEL = 4 * (2 * 5 * 1.4 + 2 * 5 + 8)
# Compose tap mode additionally holds two adjacent-flow stacks (2 ch x 2
# directions) across the tap scan.
_BYTES_PER_VOXEL_COMPOSE = _BYTES_PER_VOXEL + 4 * 4
# Share of the device's memory limit (memory_stats()["bytes_limit"]) a pass
# window may take; the rest holds the volume, its transposed copy, the
# output and XLA's scratch.
_DEVICE_BUDGET_FRACTION = 0.5
# The CPU backend reports no memory limit: a fixed budget keeps slabbing
# testable there.
_CPU_SLAB_BUDGET = int(2.6 * 1024 ** 3)
# Smallest auto slab: below this the halo recompute fraction dominates.
_SLAB_FLOOR = 8


@functools.lru_cache(maxsize=512)
def _cached_pass(taps_key: tuple, boundary: Boundary, flow_key, slab):
    """Jitted axis-0 pass, cached so repeated denoise() calls don't retrace.

    The axis transposes live OUTSIDE this function so that all three passes
    of a cubic volume share one compiled executable (the per-pass programs
    are the dominant compile cost).  flow_key is a FlowConfig for the OF
    pass or None for the plain Gaussian pass; taps enter as a hashable
    tuple.

    The stack argument is DONATED: each pass's input buffer is dead the
    moment the padded stack is built, and returning it to the allocator
    mid-pass is what lets the solve-mode working set fit device memory at
    the 1024x1024x512 headline size (the pipeline only passes buffers it owns).
    """
    taps = np.asarray(taps_key, dtype=np.float64)

    def one_pass(t, mv):
        if flow_key is None:
            def padded_pass(window, tp):
                return gaussian_pass_padded(window, tp)
        else:
            def padded_pass(window, tp):
                return of_pass_padded(window, tp, flow_key)
        return _slabbed_pass(padded_pass, t, taps, boundary, mv, slab)

    return jax.jit(one_pass, donate_argnums=0)


def slab_budget(device=None) -> int:
    """Bytes a pass window may take on ``device`` (default: the first).

    A stated share of the device's memory limit; the fixed CPU budget when
    the backend reports none."""
    if device is None:
        device = jax.devices()[0]
    stats = device.memory_stats() or {}
    if "bytes_limit" in stats:
        return int(_DEVICE_BUDGET_FRACTION * stats["bytes_limit"])
    return _CPU_SLAB_BUDGET


def _bytes_per_voxel(tap_mode: str) -> float:
    if tap_mode == "solve":
        return _BYTES_PER_VOXEL
    return _BYTES_PER_VOXEL_COMPOSE


def _auto_slab(n: int, h: int, w: int, ks2: int, use_flow: bool,
               tap_mode: str = "solve") -> int | None:
    """Pick a slab size so a pass's working set stays within budget.

    The slab must come from the model, never rounded UP past it: a
    too-large slab is a hard runtime OOM, a too-small one only costs halo
    recompute.
    """
    if not use_flow:
        return None
    budget = slab_budget()
    per_slice = h * w * _bytes_per_voxel(tap_mode)
    if (n + 2 * ks2) * per_slice <= budget:
        return None
    slab = int(budget / per_slice) - 2 * ks2
    slab = max(_SLAB_FLOOR, slab)
    # balance slab sizes without exceeding the model's bound
    n_slabs = -(-n // slab)
    return min(slab, -(-n // n_slabs))


def pass_slab(cfg: FilterConfig, n: int, h: int, w: int,
              ks2: int) -> int | None:
    """Slab size for one pass under ``cfg`` (None = whole axis).

    The single point of truth for device-memory slab bounding: the
    in-memory, streamed, and sharded pipelines all size their per-pass
    windows here.
    """
    if cfg.slab_size is not None:
        return cfg.slab_size
    return _auto_slab(n, h, w, ks2, cfg.use_flow, cfg.flow.tap_mode)


def predicted_peak_bytes(cfg: FilterConfig, vol_shape, kernels=None) -> int:
    """The slab model's device working set for a single-device ``denoise``
    of ``vol_shape``: the largest pass window (at the slab ``pass_slab``
    picks) plus the volume-sized buffers around the passes (input, its
    transposed copy, the output)."""
    kernels = get_gaussian_kernels(cfg.sigma) if kernels is None else kernels
    vol_bytes = 4 * int(np.prod(vol_shape))
    worst = 0
    for i, taps in enumerate(kernels):
        n = vol_shape[i]
        h, w = (s for j, s in enumerate(vol_shape) if j != i)
        ks2 = len(taps) // 2
        if cfg.use_flow:
            slab = pass_slab(cfg, n, h, w, ks2) or n
            window = min(slab, n) + 2 * ks2
            worst = max(worst, int(window * h * w
                                   * _bytes_per_voxel(cfg.flow.tap_mode)))
        else:
            worst = max(worst, 4 * (n + 2 * ks2) * h * w)
    return worst + 3 * vol_bytes


def _owned_f32(vol) -> jnp.ndarray:
    """Float32 device array the pipeline OWNS (safe to donate to a pass).

    NumPy inputs and dtype conversions already produce fresh buffers; a
    concrete float32 jax.Array passed by the caller is copied so donation
    never invalidates a caller-held array.  Under tracing (outer jit) the
    copy is a no-op for XLA's buffer analysis.
    """
    if isinstance(vol, jax.Array) and not isinstance(
            vol, jax.core.Tracer) and vol.dtype == jnp.float32:
        return jnp.array(vol, copy=True)
    return jnp.asarray(vol, dtype=jnp.float32)


def gaussian_denoise(vol: jnp.ndarray, sigma=(2.0, 2.0, 2.0),
                     boundary: Boundary = Boundary.WRAP,
                     slab_size: int | None = None,
                     kernels=None, start_pass: int = 0, mean_val=None,
                     on_pass=None) -> jnp.ndarray:
    """No-OF separable 3-D Gaussian denoise (reference ``-n`` path)."""
    kernels = get_gaussian_kernels(sigma) if kernels is None else kernels
    vol = _owned_f32(vol)
    if mean_val is None and boundary is Boundary.MEAN:
        mean_val = jnp.mean(vol)
    out = vol
    for i, ((fwd, inv), taps) in enumerate(zip(_axis_views(), kernels)):
        if i < start_pass:
            continue

        pass_fn = _cached_pass(tuple(np.asarray(taps, np.float64)), boundary,
                               None, slab_size)
        t = jnp.transpose(out, fwd)
        t = pass_fn(t, jnp.asarray(0.0 if mean_val is None else mean_val,
                                   jnp.float32))
        out = jnp.transpose(t, inv)
        if on_pass is not None:
            on_pass(i, out)
    return out


def _sync_result(x):
    """Wait for ``x``: :func:`denoise_many`'s in-flight window syncs here
    (module-level so tests can observe the backpressure)."""
    jax.block_until_ready(x)


def denoise_many(vols, cfg: FilterConfig = FilterConfig(), kernels=None,
                 window: int = 2, to_host: bool = False):
    """Throughput mode: denoise a stream of equally-shaped volumes.

    True double-buffered streaming (the reference has no analogue; this is
    BASELINE.json config 5): host volumes are staged onto the device by a
    BACKGROUND thread (dtype conversion + ``jax.device_put``) while the
    main thread dispatches compute, so the host-side staging cost and the
    H2D transfer of volume i+1 overlap compute of volume i by construction
    -- not just by dispatch-queue luck.  Staged buffers are handed to
    :func:`denoise` as ``owned``, so the first pass donates them with no
    defensive on-device copy.

    ``window`` bounds how many volumes are staged + in flight at once so
    the working sets cannot exhaust device memory at large volume sizes;
    window=2 is
    classic double buffering.  ``vols`` may be any iterable (lazily
    consumed, so a generator reading volumes from disk streams end to end).
    Returns a list of on-device results, or host arrays with
    ``to_host=True``.

    ``to_host`` is the SUSTAINED-service mode: each result is fetched to
    host memory (overlapping the next volume's compute) and its device
    buffer freed as soon as it leaves the in-flight window, so repeated
    batch calls cannot accumulate multi-GB result buffers on the device.
    """
    import collections
    import concurrent.futures
    import itertools

    _sync = _sync_result
    it = iter(vols)
    staged = collections.deque()

    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        def _put(v):
            return jax.device_put(np.asarray(v, dtype=np.float32)), True

        def stage(v):
            if isinstance(v, jax.Array) and v.dtype == jnp.float32:
                # caller-held device array: denoise copies it (not donated)
                done = concurrent.futures.Future()
                done.set_result((v, False))
                staged.append(done)
            else:
                staged.append(pool.submit(_put, v))

        for v in itertools.islice(it, max(1, window)):
            stage(v)

        outs = []
        while staged:
            v, owned = staged.popleft().result()
            outs.append(denoise(v, cfg, kernels=kernels, owned=owned))
            del v
            # Stage the next volume NOW: its host copy + H2D run on the
            # staging thread while the volume just dispatched computes.
            nxt = next(it, None)
            if nxt is not None:
                stage(nxt)
            if len(outs) > window:
                i = len(outs) - window - 1
                if to_host:
                    # fetch + free the device buffer the moment the result
                    # leaves the in-flight window (compute of the current
                    # volume is already dispatched and overlaps the D2H)
                    outs[i] = np.asarray(outs[i])
                else:
                    _sync(outs[i])
        for i, o in enumerate(outs):
            if to_host:
                if not isinstance(o, np.ndarray):
                    outs[i] = np.asarray(o)
            else:
                _sync(o)
    return outs


# pass-program keys already submitted for ahead-of-use compilation.  Keyed
# by VALUE (config + shape), not by the jitted-function object: holding fn
# references here would pin executables past _cached_pass's lru eviction,
# and replacement wrappers after eviction would defeat the dedup.
_warmed: set = set()
_WARMED_CAP = 4096


def _compile_ahead(plan) -> None:
    """Warm the compilation cache for later passes WHILE an earlier pass
    executes (background thread; XLA compiles on host cores while the
    device runs the first pass).  First runs at a new shape otherwise pay
    each distinct pass program's compile serially; with the persistent
    compile cache enabled the main thread's later dispatch becomes a fast
    cache hit.  Best-effort: any failure just means the normal compile
    path.
    """
    import threading

    def run():
        for pass_fn, aval, mv_aval in plan:
            try:
                pass_fn.lower(aval, mv_aval).compile()
            except Exception:
                return

    threading.Thread(target=run, daemon=True).start()


def denoise(vol: jnp.ndarray, cfg: FilterConfig = FilterConfig(),
            kernels=None, start_pass: int = 0, mean_val=None,
            on_pass=None, owned: bool = False) -> jnp.ndarray:
    """Full OF-compensated denoise: Z, Y, X passes with Farneback-compensated
    Gaussian accumulation (or the plain Gaussian when cfg.use_flow=False).

    ``start_pass``/``mean_val``/``on_pass`` support pass-boundary
    checkpoint/resume: when resuming at pass i, pass the checkpointed volume
    as ``vol`` and the ORIGINAL input's mean as ``mean_val`` (the reference
    sequential pipeline reuses the input mean for all passes,
    flowdenoising_sequential.py:419-424).  ``on_pass(i, volume)`` is invoked
    after each completed pass.  ``owned`` asserts the caller hands over the
    buffer: the pipeline may donate it without a defensive copy
    (denoise_many's pre-staged volumes use this).
    """
    if not cfg.use_flow:
        return gaussian_denoise(vol, cfg.sigma, cfg.boundary, cfg.slab_size, kernels,
                                start_pass=start_pass, mean_val=mean_val,
                                on_pass=on_pass)
    kernels = get_gaussian_kernels(cfg.sigma) if kernels is None else kernels
    if not (owned and isinstance(vol, jax.Array) and vol.dtype == jnp.float32):
        vol = _owned_f32(vol)
    vol_shape = vol.shape
    if mean_val is None and cfg.boundary is Boundary.MEAN:
        mean_val = jnp.mean(vol)

    # Composed transposes: the volume stays in each pass's layout and moves
    # directly to the next pass's layout (one materialized permutation per
    # boundary instead of inverse+forward -- a full volume copy saved, which
    # matters at HBM-limit sizes).  `layout` tracks canonical axes by
    # position; pass i wants canonical axis i first.
    targets = [(0, 1, 2), (1, 0, 2), (2, 0, 1)]
    out = vol
    del vol  # the pipeline owns the buffer now; keep no extra reference
    layout = (0, 1, 2)

    # Background-compile the LATER passes' programs while the first pass
    # runs (eager path only -- inside an outer jit everything is one trace).
    if (not isinstance(out, jax.core.Tracer)
            and os.environ.get("FDTPU_COMPILE_AHEAD", "1") != "0"):
        plan = []
        for j in range(max(start_pass, 0) + 1, len(kernels)):
            tgt = targets[j]
            pj = [vol_shape[ax] for ax in tgt[1:]]
            taps_j = kernels[j]
            slab_j = pass_slab(cfg, vol_shape[tgt[0]], pj[0], pj[1],
                               len(taps_j) // 2)
            taps_key = tuple(np.asarray(taps_j, np.float64))
            fn_j = _cached_pass(taps_key, cfg.boundary, cfg.flow, slab_j)
            shape = (vol_shape[tgt[0]], pj[0], pj[1])
            key = (taps_key, cfg.boundary, cfg.flow, slab_j, shape)
            if key in _warmed:
                continue
            if len(_warmed) >= _WARMED_CAP:
                _warmed.clear()
            _warmed.add(key)
            plan.append((fn_j, jax.ShapeDtypeStruct(shape, jnp.float32),
                         jax.ShapeDtypeStruct((), jnp.float32)))
        if plan:
            _compile_ahead(plan)
    for i, taps in enumerate(kernels):
        if i < start_pass:
            continue
        target = targets[i]
        perm = tuple(layout.index(ax) for ax in target)
        if perm != (0, 1, 2):
            out = jnp.transpose(out, perm)
        layout = target

        plane = [vol_shape[ax] for ax in target[1:]]
        slab = pass_slab(cfg, vol_shape[target[0]], plane[0], plane[1],
                         len(taps) // 2)

        # jit per pass: keeps the CLI path compiled while still allowing
        # host callbacks (checkpointing) between passes.  Inside an outer
        # jit this inlines.
        pass_fn = _cached_pass(tuple(np.asarray(taps, np.float64)), cfg.boundary,
                               cfg.flow, slab)
        out = pass_fn(out, jnp.asarray(0.0 if mean_val is None else mean_val,
                                       jnp.float32))
        if on_pass is not None:
            inv = tuple(target.index(ax) for ax in (0, 1, 2))
            on_pass(i, jnp.transpose(out, inv))
    # restore canonical (Z, Y, X)
    inv = tuple(layout.index(ax) for ax in (0, 1, 2))
    if inv != (0, 1, 2):
        out = jnp.transpose(out, inv)
    return out
