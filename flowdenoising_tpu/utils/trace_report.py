"""MEASURED per-stage device-time attribution from a jax.profiler trace.

The reference's accumulators time the actual run
(/root/reference/src/flowdenoising_GPU.py:47-53,760-766).  Here a whole
pass is one compiled program, so in-line accumulation is impossible -- but
the profiler's trace carries the device duration of every kernel the REAL
program launched.  This module wraps a run in ``start_trace`` /
``stop_trace``, reads the trace's XSpace (``*.xplane.pb``, through
``jax.profiler.ProfileData``) and sums the events of the GPU streams by the
kind XLA names each kernel after (its fusion kind and root op; under CUDA
graphs the ``hlo_op`` stat only says "command_buffer", so the kernel name
is the label):

- ``elementwise``   -- loop fusions: the polynomial expansion, blurs,
                       update matrices/flow (with their fused bilinear
                       gathers), the tap-weighted accumulate
- ``data_movement`` -- concatenate/transpose/copy/slice/pad kernels
- ``matmul``        -- GEMMs (the pyramid resizes)
- ``gather``        -- fusions XLA names after a root gather
- ``reduction``     -- reduce fusions
- ``memcpy``        -- memcpy/memset kernels and copies

Used by the CLI at verbosity >= 2.
"""

from __future__ import annotations

import contextlib
import glob
import logging
import os
import tempfile

STAGES = ("elementwise", "data_movement", "matmul", "gather", "reduction",
          "memcpy")


@contextlib.contextmanager
def traced_run(log_dir: str | None = None):
    """Trace the enclosed block; yields ``{"log_dir": ...}`` for
    measured_stage_report."""
    import jax
    state = {"log_dir": log_dir or tempfile.mkdtemp(prefix="fdtpu_trace_")}
    jax.profiler.start_trace(state["log_dir"])
    try:
        yield state
    finally:
        jax.profiler.stop_trace()


def classify(name: str) -> str:
    """Stage of one GPU kernel, from the name XLA gave it."""
    n = name.lower()
    if "memcpy" in n or "memset" in n:
        return "memcpy"
    if any(k in n for k in ("gemm", "xmma", "cublas", "cutlass", "matmul")):
        return "matmul"
    if "gather" in n:
        return "gather"
    if "reduce" in n:
        return "reduction"
    if any(k in n for k in ("concatenate", "transpose", "copy", "slice",
                            "pad", "dynamic_update")):
        return "data_movement"
    return "elementwise"


def _busy_seconds(intervals) -> float:
    """Length of the union of (start, end) ns intervals, in seconds."""
    busy, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e9


def gpu_stage_times(xplane_path: str) -> dict | None:
    """Per-stage device seconds of the GPU stream events in one XSpace
    file, plus ``busy`` (union over streams) and ``window`` (first start to
    last end); None when the trace holds no GPU kernel."""
    import jax

    data = jax.profiler.ProfileData.from_file(xplane_path)
    totals = dict.fromkeys(STAGES, 0.0)
    spans = []
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU:"):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                start = int(ev.start_ns)
                end = start + int(ev.duration_ns)
                totals[classify(ev.name)] += (end - start) / 1e9
                spans.append((start, end))
    if not spans:
        return None
    totals["busy"] = _busy_seconds(spans)
    totals["window"] = (max(e for _, e in spans)
                        - min(s for s, _ in spans)) / 1e9
    return totals


def measured_stage_report(log_dir: str) -> dict[str, float] | None:
    """Aggregate the trace's GPU kernel durations by stage; logs a table.

    Returns the dict of :func:`gpu_stage_times` for the newest trace under
    ``log_dir``, or None when there is no trace or it holds no GPU kernel
    (a run on another backend).
    """
    paths = sorted(glob.glob(os.path.join(
        log_dir, "plugins", "profile", "*", "*.xplane.pb")))
    if not paths:
        return None
    totals = gpu_stage_times(paths[-1])
    if totals is None:
        logging.info("[stages] the trace holds no GPU kernels: no measured "
                     "stage report on this backend")
        return None
    busy = totals["busy"]
    logging.info("[stages] MEASURED GPU time by kernel class "
                 "(jax.profiler trace of the actual run):")
    for name in sorted(STAGES, key=lambda k: -totals[k]):
        pct = 100.0 * totals[name] / busy if busy else 0.0
        logging.info(f"[stages]   {name:13s} {totals[name]:10.4f}s "
                     f"({pct:5.1f}% of busy)")
    logging.info(f"[stages]   {'device busy':13s} {busy:10.4f}s of a "
                 f"{totals['window']:.4f}s window (streams overlap, so the "
                 "classes can sum past busy)")
    return totals
