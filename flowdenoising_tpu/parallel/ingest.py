"""Multi-host sharded volume ingest (SURVEY.md section 7.6).

The reference reads the whole volume into one process's RAM
(/root/reference/src/flowdenoising.py:466-475).  On a multi-host cluster
the volume may exceed host RAM and the input file lives on shared storage,
so each host should read ONLY the Z-range its local devices own and the
global jax.Array is assembled from per-process shards
(``jax.make_array_from_process_local_data``) -- the interconnect never
carries the bulk ingest, just the metadata.

Degenerate single-process case (this test environment) reduces to a
memory-mapped partial read + device_put, which is what the tests cover;
the process-spanning path uses the same code.
"""

from __future__ import annotations

import math

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from flowdenoising_tpu.io.volume import read_volume
from flowdenoising_tpu.parallel.mesh import AXIS


def local_z_range(n_z: int, mesh: Mesh) -> tuple[int, int]:
    """[start, stop) of the Z-slices owned by this process's devices under a
    Z-sharded ``P(AXIS, None, None)`` layout.  Contiguity holds because mesh
    device order is Z-major for a 1-D mesh."""
    n_dev = mesh.devices.size
    per = -(-n_z // n_dev)
    local = [d for d in mesh.devices.flat if d.process_index == jax.process_index()]
    ids = sorted(np.flatnonzero(np.isin(mesh.devices.reshape(-1), local)))
    lo = min(ids) * per
    hi = min(n_z, (max(ids) + 1) * per)
    return lo, hi


def load_sharded(path, mesh: Mesh, memory_map: bool = True) -> jax.Array:
    """Read only this host's Z-range of the volume at ``path`` and assemble
    the global Z-sharded ``jax.Array`` across processes.

    The local read uses the memory-mapped reader so untouched Z-slices are
    never paged in.  Axes that do not divide the mesh are padded by the
    caller (``denoise_sharded`` handles uneven axes internally), so this
    loader requires divisibility only of the padded global shape it is
    given -- for odd shapes, fall back to a full read + device_put.
    """
    vol = read_volume(path, memory_map=memory_map)
    n_z = vol.shape[0]
    n_dev = mesh.devices.size
    if n_z % n_dev != 0:
        # uneven Z: full read, replicated; denoise_sharded re-shards
        # internally.  make_array_from_process_local_data is the
        # multi-controller-safe assembly (device_put cannot target
        # non-addressable devices).
        full = np.asarray(vol, dtype=np.float32)
        return jax.make_array_from_process_local_data(
            NamedSharding(mesh, P()), full, full.shape)
    lo, hi = local_z_range(n_z, mesh)
    local = np.asarray(vol[lo:hi], dtype=np.float32)
    sharding = NamedSharding(mesh, P(AXIS, None, None))
    return jax.make_array_from_process_local_data(
        sharding, local, (n_z,) + vol.shape[1:])
