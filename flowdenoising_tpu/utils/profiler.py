"""Per-phase wall-clock profiler.

Successor of the reference's shared-memory accumulators
OFE_time / warping_time / convolution_time / transference_time
(/root/reference/src/flowdenoising_GPU.py:47-53,760-766).  Phases here are
the pipeline stages that still exist on the device: host I/O, host<->device
transfer, per-axis pass compute, and compilation.
"""

from __future__ import annotations

import collections
import contextlib
import logging
import time


class PhaseProfiler:
    def __init__(self):
        self.totals: dict[str, float] = collections.defaultdict(float)
        self.counts: dict[str, int] = collections.defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self, log=True) -> dict[str, float]:
        out = dict(self.totals)
        if log:
            for name, total in sorted(out.items(), key=lambda kv: -kv[1]):
                logging.info(f"[profile] {name}: {total:.3f}s over {self.counts[name]} calls")
        return out
