"""Tracing and per-step timing (port of
`blindshadowremoval_tpu/utils/profiling.py`).

  * `StepTimer` - streaming percentiles of per-step wall time and the
    derived throughput (faces/s);
  * `trace` - a context manager around `torch.profiler`, writing a trace
    that TensorBoard's profiler plugin and Perfetto read;
  * `device_time` - seconds of device work per call, by CUDA events.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Optional

import numpy as np
import torch

from blindshadowremoval_tpu_torch.config import resolve_device


class StepTimer:
    """Streaming wall-time stats for training/eval steps."""

    def __init__(self, window: int = 200):
        self.window = window
        self._times: list[float] = []
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._times.append(time.perf_counter() - self._t0)
        if len(self._times) > self.window:
            self._times.pop(0)
        return False

    def stats(self, items_per_step: int = 1) -> dict:
        if not self._times:
            return {}
        arr = np.asarray(self._times)
        return {
            "mean_ms": float(arr.mean() * 1e3),
            "p50_ms": float(np.percentile(arr, 50) * 1e3),
            "p95_ms": float(np.percentile(arr, 95) * 1e3),
            "items_per_sec": float(items_per_step / arr.mean()),
        }


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler over the host and, where there is one, the CUDA
    device; on exit it writes `<logdir>/<host>_<pid>.<time>.pt.trace.json`
    (the Chrome trace format).  Yields the profiler, whose
    `key_averages()` sum the device time by kernel."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                logdir)) as prof:
        yield prof


def device_time(fn: Callable, *args, iters: int = 10, device=None) -> float:
    """Seconds per call of `fn(*args)` on `device` (CUDA unless the caller
    passes "cpu"): CUDA events around `iters` calls after one warm-up call,
    synchronized at the end.  Only on the CPU, when asked for, does it read
    the host clock."""
    dev = resolve_device(device)
    fn(*args)   # warm-up: builds, caches, allocator
    if dev.type == "cpu":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        return (time.perf_counter() - t0) / iters
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / 1e3 / iters
