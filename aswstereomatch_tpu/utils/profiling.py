"""Tracing / profiling helpers (SURVEY.md section 5).

The reference has no observability beyond printf timing; the JAX
equivalents are jax.profiler traces (XProf/Perfetto-compatible) plus named
scopes per pipeline stage, and a small timing helper that waits for the
device with ``jax.block_until_ready``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Optional

import jax
import numpy as np


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """jax.profiler trace context; no-op when log_dir is None."""
    if log_dir is None:
        yield
        return
    with jax.profiler.trace(log_dir):
        yield


def stage(name: str):
    """Named scope for a pipeline stage (shows up in profiler traces)."""
    return jax.named_scope(name)


def time_fn(fn: Callable, *args, iters: int = 5, warmup: int = 2):
    """(best_s, mean_s, times) for fn(*args) with real device sync."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return min(times), float(np.mean(times)), times
