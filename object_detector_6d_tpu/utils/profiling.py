"""Tracing / profiling utilities (SURVEY.md section 5).

The reference relies on OpenCV's built-in region tracing
(CV_TRACE_FUNCTION via OPENCV_TRACE=1) and TickMeter timing; the
JAX equivalents:

* ``scope(name)`` — ``jax.named_scope`` context so stages show up by
  name in xprof/perfetto traces (``jax.profiler.trace`` captures).
* ``trace_to(dir)`` — wrap a block in a jax profiler trace dump.
* ``DeviceTimer`` — steady-state wall timing that waits for the device
  (``block_until_ready``) before reading the clock.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Iterator, Optional

import jax


def scope(name: str):
    """Named profiler scope: ``with scope("match/coarse"): ...``."""
    return jax.named_scope(name)


@contextlib.contextmanager
def trace_to(log_dir: str) -> Iterator[None]:
    """Capture a profiler trace (open with xprof/tensorboard/perfetto)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def _sync(x) -> None:
    jax.block_until_ready(x)


class DeviceTimer:
    """Measure steady-state latency/throughput of a device callable."""

    def __init__(self, fn: Callable, warmup: int = 1):
        self.fn = fn
        self.warmup = warmup

    def measure(self, *args, iters: int = 10, batch: int = 1) -> dict:
        for _ in range(self.warmup):
            _sync(self.fn(*args))
        t0 = time.time()
        for _ in range(iters):
            out = self.fn(*args)
        _sync(out)
        dt = time.time() - t0
        per_call = dt / iters
        return {
            "ms_per_call": per_call * 1e3,
            "ms_per_item": per_call / batch * 1e3,
            "items_per_sec": batch * iters / dt,
        }
