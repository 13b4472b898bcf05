"""Profiling and performance accounting.

Replaces the reference's wall-clock-only Timer instrumentation (SURVEY §5):

* ``trace(...)`` — context manager around ``jax.profiler`` producing a
  TensorBoard-loadable trace directory.
* ``SpeedOfLight`` — roofline model against a MEASURED peak (e.g. a
  triad over the same bytes in the same run): given a kernel's bytes,
  report the achieved fraction.  There is no table of nominal peaks; a
  missing peak is an error, never a default.
* ``measure(fn, *args)`` — robust wall-clock of a jitted callable with
  block_until_ready, warmup, and min-over-repeats.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Optional

import jax


@dataclasses.dataclass
class SpeedOfLight:
    """Roofline accounting for one kernel invocation.

    ``peak_gbps``: a measured bandwidth peak in GB/s (1e9 bytes/s).  The
    methods that need it raise when it was not given.
    """

    bytes_moved: float
    flops: float = 0.0
    peak_gbps: Optional[float] = None

    def _peak(self) -> float:
        if not self.peak_gbps or self.peak_gbps <= 0:
            raise ValueError("SpeedOfLight needs a measured peak_gbps "
                             "(e.g. a triad over the same bytes)")
        return self.peak_gbps

    def sol_seconds(self) -> float:
        return self.bytes_moved / (self._peak() * 1e9)

    def achieved_gbps(self, measured_s: float) -> float:
        return self.bytes_moved / measured_s / 1e9

    def achieved_fraction(self, measured_s: float) -> float:
        return self.sol_seconds() / measured_s if measured_s > 0 else 0.0


def measure(fn: Callable, *args, warmup: int = 2, repeats: int = 20,
            inner: int = 5) -> float:
    """Best-of wall-clock seconds per call of a jitted fn."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(inner):
            out = fn(*args)
        jax.block_until_ready(out)
        best = min(best, (time.perf_counter() - t0) / inner)
    return best


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace context (open in TensorBoard / xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def spmv_sol(nnz: int, n: int, fmt: str, dtype_bytes: int = 4,
             n_diags: int = 0, peak_gbps: Optional[float] = None
             ) -> SpeedOfLight:
    """Stream-model bytes of one SpMV by storage format: every stored
    value once, every index once, x and y once each."""
    if fmt == "dia":
        bytes_moved = (n_diags * n + 2 * n) * dtype_bytes
    elif fmt == "ell":
        bytes_moved = nnz * (dtype_bytes + 4) + 2 * n * dtype_bytes
    else:  # csr
        bytes_moved = nnz * (dtype_bytes + 4) + (3 * n) * dtype_bytes
    return SpeedOfLight(bytes_moved=float(bytes_moved), flops=2.0 * nnz,
                        peak_gbps=peak_gbps)
