"""Multi-process (multi-host) distributed denoising: file -> shards -> file.

Completes the >single-host-RAM story (SURVEY.md section 5.7): the reference
reads the whole volume into one process's RAM
(/root/reference/src/flowdenoising.py:466-475); on a multi-host cluster the
volume lives on shared storage and no host can (or should) materialize all
of it.  This module runs the slice-sharded pipeline across
``jax.distributed`` processes so that each host only ever touches its own
Z-range:

- ingest: ``parallel.ingest.load_sharded`` memory-maps the input MRC and
  reads ONLY the local devices' Z rows (untouched slices are never paged
  in); the global jax.Array is assembled with
  ``make_array_from_process_local_data``.
- compute: ``parallel.mesh.denoise_sharded`` over the GLOBAL mesh --
  cross-process halo exchange and transpose resharding ride the
  platform collectives (NCCL between GPUs; gloo in the CPU test tier).
- output: ``write_mrc_sharded`` -- process 0 sizes the file and writes the
  header (with globally-reduced statistics); every process then writes only
  its addressable shards at their byte offsets into the shared file.

CLI entry: ``flowdenoising_tpu --coordinator host:port --num_hosts N
--host_id I ...`` (tests/test_multihost.py runs the 2-process gloo tier).
"""

from __future__ import annotations

import logging
import os

import numpy as np


def init_distributed(coordinator: str, num_hosts: int, host_id: int) -> None:
    """Initialize the jax.distributed runtime (call before any jax use)."""
    import jax

    if "cpu" in os.environ.get("JAX_PLATFORMS", "").lower():
        # CPU tier (tests / virtual meshes): gloo carries the collectives
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_hosts, process_id=host_id)


def sharded_stats(arr):
    """Globally-reduced (min, max, mean, rms) of a sharded f32 array."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def stats(a):
        a = a.astype(jnp.float32)
        return jnp.min(a), jnp.max(a), jnp.mean(a), jnp.std(a)

    return tuple(float(x) for x in stats(arr))


def write_mrc_sharded(path, arr, voxel_size=None) -> None:
    """Write a sharded global f32 array as one MRC file on SHARED storage.

    Process 0 writes the header (global statistics via jitted reductions)
    and sizes the file; every process then writes its addressable shards
    (deduplicated by replica_id) at their numpy-index offsets through a
    memmap view.  Z-sharded layouts produce contiguous per-shard writes;
    other layouts degrade to strided writes but stay correct.
    """
    import jax
    from jax.experimental import multihost_utils

    from flowdenoising_tpu.io.mrc import _HEADER_BYTES, build_mrc_header

    nz, ny, nx = arr.shape
    dmin, dmax, dmean, rms = sharded_stats(arr)
    if jax.process_index() == 0:
        hdr = build_mrc_header(nx, ny, nz, 2, dmin, dmax, dmean, rms,
                               voxel_size)
        with open(path, "wb") as f:
            f.write(hdr)
            f.truncate(_HEADER_BYTES + arr.size * 4)
    if jax.process_count() > 1:
        multihost_utils.sync_global_devices("fdtpu_mrc_header")
    mm = np.memmap(path, dtype="<f4", mode="r+", offset=_HEADER_BYTES,
                   shape=arr.shape)
    for sh in arr.addressable_shards:
        if sh.replica_id != 0:
            continue
        mm[sh.index] = np.asarray(sh.data, dtype=np.float32)
    mm.flush()
    del mm
    if jax.process_count() > 1:
        multihost_utils.sync_global_devices("fdtpu_mrc_data")


def run_distributed(input_path, output_path, cfg, kernels=None,
                    on_pass=None):
    """File-to-file distributed denoise over all global devices.

    Each process memory-map-reads only its Z shard, the sharded pipeline
    runs on the global mesh, and the output is written shard-wise into one
    shared file.  Returns the (still sharded) output array.
    """
    import jax

    from flowdenoising_tpu.kernels import get_gaussian_kernels
    from flowdenoising_tpu.parallel.ingest import load_sharded
    from flowdenoising_tpu.parallel.mesh import (
        denoise_sharded, make_mesh, usable_device_count)

    kernels = get_gaussian_kernels(cfg.sigma) if kernels is None else kernels
    max_halo = max(len(k) // 2 for k in kernels)

    probe = make_mesh(len(jax.devices()))
    garr = load_sharded(input_path, probe)
    usable = usable_device_count(garr.shape, max_halo, len(jax.devices()))
    if usable != len(jax.devices()):
        # shards must stay at least one halo wide; denoise_sharded would
        # shrink the mesh, but in multi-process mode every process's
        # devices must participate in the collectives -- refuse instead.
        raise ValueError(
            f"volume {garr.shape} too small for {len(jax.devices())} "
            f"devices at halo {max_halo} (usable: {usable})")
    logging.info(
        f"distributed: process {jax.process_index()}/{jax.process_count()}, "
        f"{len(jax.devices())} global devices, volume {garr.shape}")

    out = denoise_sharded(garr, cfg, kernels=kernels, mesh=probe,
                          on_pass=on_pass)
    # preserve the input's pixel calibration (CELLA) in the shared output
    from flowdenoising_tpu.io.mrc import read_mrc_header
    write_mrc_sharded(output_path, out,
                      read_mrc_header(input_path).voxel_size)
    return out
