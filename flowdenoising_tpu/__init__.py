"""FlowDenoising-TPU: optical-flow-compensated Gaussian denoising in JAX.

A ground-up JAX/XLA rebuild of the FlowDenoising volumetric denoiser
(structure-preserving Gaussian denoising of FIB-SEM volumes, Gonzalez-Ruiz et
al., Ultramicroscopy 2023).  The reference implementation delegates its heavy
numerics to OpenCV C++/CUDA (Farneback dense optical flow, bilinear remap) and
SciPy C (Gaussian taps); this package re-implements the full pipeline as
batched, jit-compiled XLA programs for the GPU:

- ``flowdenoising_tpu.kernels``   -- Gaussian tap builder (reference parity:
  /root/reference/src/flowdenoising.py:34-45).
- ``flowdenoising_tpu.ops``       -- warp, resize, blur, Farneback optical flow
  (replaces cv2.calcOpticalFlowFarneback + cv2.remap).
- ``flowdenoising_tpu.core``      -- per-axis OF-compensated filtering passes
  and the Z->Y->X pipeline (replaces the chunked thread/process schedulers).
- ``flowdenoising_tpu.parallel``  -- jax.sharding Mesh / shard_map slice
  sharding with ICI halo exchange (replaces /dev/shm + fork).
- ``flowdenoising_tpu.io``        -- MRC2014 + TIFF volume I/O.
- ``flowdenoising_tpu.cli``       -- argparse surface compatible with the
  reference ``flowdenoising.py`` CLI.
"""

from flowdenoising_tpu.version import __version__
from flowdenoising_tpu.kernels import get_gaussian_kernel
from flowdenoising_tpu.config import FlowConfig, FilterConfig, Boundary
from flowdenoising_tpu.ops.warp import warp_slices
from flowdenoising_tpu.ops.farneback import farneback_flow
from flowdenoising_tpu.core.pipeline import (denoise, denoise_many,
                                             gaussian_denoise)
from flowdenoising_tpu.core.autodisp import resolve_auto_displacement
from flowdenoising_tpu.core.noise import estimate_noise, resolve_auto_presmooth

__all__ = [
    "__version__",
    "get_gaussian_kernel",
    "FlowConfig",
    "FilterConfig",
    "Boundary",
    "warp_slices",
    "farneback_flow",
    "denoise",
    "denoise_many",
    "gaussian_denoise",
    "resolve_auto_displacement",
    "estimate_noise",
    "resolve_auto_presmooth",
]
