"""Disk-streamed denoise for volumes larger than host RAM / HBM.

The reference's only extent-scaling device is ``-m`` memory-mapped MRC
reading in the sequential variant (/root/reference/src/flowdenoising_sequential.py:510-515),
which still materializes every padded pass array in RAM.  This module
re-designs that idea for the device: the volume lives ON DISK for the whole run
and each of the three passes streams axis slabs through the device --

    input memmap -> [gather slab + kernel halo along the pass axis,
                     boundary context materialized host-side]
                 -> H2D -> jitted padded pass (of_pass_padded /
                     gaussian_pass_padded, the same programs the in-memory
                     pipeline runs) -> D2H -> output memmap

Host RAM is bounded by ONE slab window (+ OS page cache); device HBM by the
same auto-slab model as the in-memory pipeline.  Two float32 scratch
memmaps ping-pong between passes (like the reference's vol/filtered_vol
buffer swap, flowdenoising.py:285-290, but file-backed).

Per-output-slice results depend only on that slice's own tap chain, so any
slab decomposition is bitwise-identical to the in-memory pipeline
(tests/test_stream.py asserts exact equality, including the shifted tail
slab that keeps every window the same compiled shape).
"""

from __future__ import annotations

import functools
import logging
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np

from flowdenoising_tpu.config import Boundary, FilterConfig
from flowdenoising_tpu.core.axis_filter import (
    gaussian_pass_padded, of_pass_padded)
from flowdenoising_tpu.core.pipeline import pass_slab
from flowdenoising_tpu.kernels import get_gaussian_kernels

# pass i filters along canonical axis i; windows are gathered in the same
# layouts the in-memory pipeline transposes into (core/pipeline.py targets)
_TARGETS = [(0, 1, 2), (1, 0, 2), (2, 0, 1)]


@functools.lru_cache(maxsize=64)
def _cached_padded_pass(taps_key: tuple, flow_key):
    """Jitted pass over a PRE-PADDED window (boundary context gathered on
    the host), input donated -- the window buffer dies with the pass."""
    taps = np.asarray(taps_key, dtype=np.float64)

    def run(window):
        if flow_key is None:
            return gaussian_pass_padded(window, taps)
        return of_pass_padded(window, taps, flow_key)

    return jax.jit(run, donate_argnums=0)


def _boundary_window(src: np.ndarray, axis: int, lo: int, hi: int,
                     boundary: Boundary, mean_val: float) -> np.ndarray:
    """Slices [lo, hi) along ``axis`` of ``src`` with out-of-range indices
    materialized per the boundary mode (wrap / replicate / mean fill),
    gathered as a float32 array in pass layout (axis moved to 0).

    Contiguous in-range runs are read as plain slices (no fancy indexing),
    so the memmap reads stay sequential along the axis.
    """
    n = src.shape[axis]
    parts = []
    i = lo
    while i < hi:
        if i < 0:
            j = min(hi, 0)
            if boundary is Boundary.WRAP:
                parts.append(np.take(src, np.arange(i, j) % n, axis=axis))
            elif boundary is Boundary.REPLICATE:
                rep = np.take(src, [0], axis=axis)
                parts.append(np.repeat(rep, j - i, axis=axis))
            else:  # MEAN
                shape = list(src.shape)
                shape[axis] = j - i
                parts.append(np.full(shape, mean_val, np.float32))
        elif i >= n:
            j = hi
            if boundary is Boundary.WRAP:
                parts.append(np.take(src, np.arange(i, j) % n, axis=axis))
            elif boundary is Boundary.REPLICATE:
                rep = np.take(src, [n - 1], axis=axis)
                parts.append(np.repeat(rep, j - i, axis=axis))
            else:
                shape = list(src.shape)
                shape[axis] = j - i
                parts.append(np.full(shape, mean_val, np.float32))
        else:
            j = min(hi, n)
            sl = [slice(None)] * src.ndim
            sl[axis] = slice(i, j)
            parts.append(np.asarray(src[tuple(sl)]))
        i = j
    win = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=axis)
    win = np.moveaxis(win, axis, 0)
    return np.ascontiguousarray(win, dtype=np.float32)


def _streamed_mean(src: np.ndarray, chunk: int = 8) -> float:
    """Mean of the volume, streamed in Z chunks (float64 accumulation,
    matching np.float32.mean()'s pairwise result closely; the in-memory
    pipeline's jnp.mean is reproduced exactly by computing on-device when
    shapes allow -- for >RAM volumes the float64 stream is the defined
    semantics)."""
    total = 0.0
    n = src.shape[0]
    for a in range(0, n, chunk):
        total += float(np.sum(src[a:a + chunk], dtype=np.float64))
    return total / src.size


def denoise_streamed(src: np.ndarray, cfg: FilterConfig = FilterConfig(),
                     kernels=None, *, tmp_dir: str | None = None,
                     out: np.ndarray | None = None, slab_size: int | None = None,
                     on_pass=None, progress=None, mesh=None,
                     n_devices: int | None = None) -> np.ndarray:
    """Three-pass OF-compensated (or plain Gaussian) denoise of a volume
    that never has to fit in host RAM.

    src: (Z, Y, X) array-like -- typically a memory-mapped MRC
    (``read_volume(path, memory_map=True)``).  Any dtype; converted to
    float32 per window.
    out: optional preallocated float32 (Z, Y, X) array (e.g. a memmap of
    the output file's data region) the final pass writes into; a scratch
    memmap is created when omitted.
    mesh / n_devices: run each slab's pass sharded over a device mesh
    (``parallel.mesh.sharded_window_pass``), so a >host-RAM volume on one
    multi-chip host uses every chip: slabs stream from disk, each window
    is ring-halo sharded along the pass axis, outputs stream back to the
    scratch memmaps.  Bitwise-identical to the single-device stream.  The
    auto slab grows by the device count (per-device HBM bounding happens
    inside the sharded pass).
    Returns the output array (the ``out`` argument when given).

    Intermediate passes ping-pong through two float32 scratch memmaps in
    ``tmp_dir`` (default: system temp).  ``progress(done, total)`` is called
    after every slab with output-slice counts (reference 1-Hz reporter
    compatible); ``on_pass(i, path_or_array)`` after each pass.
    """
    shape = tuple(src.shape)
    assert len(shape) == 3, "volume must be (Z, Y, X)"
    if mesh is None and n_devices is not None and n_devices > 1:
        from flowdenoising_tpu.parallel.mesh import make_mesh
        mesh = make_mesh(n_devices)
    n_dev = int(mesh.devices.size) if mesh is not None else 1
    kernels = get_gaussian_kernels(cfg.sigma) if kernels is None else kernels
    mean_val = 0.0
    if cfg.boundary is Boundary.MEAN:
        mean_val = _streamed_mean(src)

    tdir = tempfile.mkdtemp(prefix="fdtpu_stream_", dir=tmp_dir)
    scratch = []
    for k in range(2):
        path = os.path.join(tdir, f"pass{k}.f32")
        scratch.append(np.memmap(path, dtype=np.float32, mode="w+",
                                 shape=shape))

    total = sum(shape)
    done = 0
    cur = src
    for i, taps in enumerate(kernels):
        taps64 = np.asarray(taps, np.float64)
        ks2 = len(taps64) // 2
        axis = i
        n = shape[axis]
        tgt = _TARGETS[i]
        plane = [shape[ax] for ax in tgt[1:]]
        dst = scratch[i % 2] if i < 2 else (
            out if out is not None else scratch[i % 2])

        slab = slab_size
        if slab is None:
            # shared model with the in-memory pipeline (incl. the eo solve
            # operand growth -- the >host-RAM regime --stream exists for is
            # exactly where an under-modeled slab would OOM).  On a mesh the
            # window grows by the device count: each device's share of it is
            # what the model bounds (the sharded pass re-slabs per shard).
            base = pass_slab(cfg, n, plane[0], plane[1], ks2)
            slab = n if base is None else min(n, base * n_dev)
        slab = min(slab, n)
        n_slabs = -(-n // slab)
        if n_dev > 1:
            from flowdenoising_tpu.parallel.mesh import sharded_window_pass
            pass_fn = (lambda window, _taps=taps64, _slab=slab:
                       sharded_window_pass(window, _taps, cfg, mesh, _slab))
        else:
            cached = _cached_padded_pass(
                tuple(taps64), cfg.flow if cfg.use_flow else None)
            pass_fn = cached

        logging.info(f"streamed pass {i}: axis={axis} n={n} slab={slab} "
                     f"({n_slabs} slabs)")
        for k in range(n_slabs):
            a = k * slab
            # shifted tail: the last slab anchors at n-slab so every window
            # has the SAME compiled shape; already-written rows are simply
            # recomputed (bitwise-equal) and overwritten
            a_eff = min(a, n - slab)
            win_np = _boundary_window(cur, axis, a_eff - ks2,
                                      a_eff + slab + ks2, cfg.boundary,
                                      mean_val)
            # window layout after moveaxis(axis -> 0) is exactly the
            # in-memory pipeline's pass layout (targets (0,1,2)/(1,0,2)/
            # (2,0,1)): the remaining axes keep canonical order
            out_dev = pass_fn(jnp.asarray(win_np))
            out_np = np.asarray(out_dev)
            del out_dev
            sl = [slice(None)] * 3
            sl[axis] = slice(a_eff, a_eff + slab)
            dst[tuple(sl)] = np.moveaxis(out_np, 0, axis)
            done += slab if a == a_eff else n - a
            if progress is not None:
                progress(min(done, total), total)
        if isinstance(dst, np.memmap):
            dst.flush()
        if on_pass is not None:
            on_pass(i, dst)
        cur = dst
    return cur
