"""Spans recorded from the benchmark's side, around the calls into each
layer of the program: in the traced run, and the open loop's host clock
(harness/clock.py) in every run.

`Spans.wrap(owner, attr, name)` replaces `owner.attr` (a bound method of
an instance, or a function of a module) by a wrapper that records the
host-clock interval of each call and, with `ranges`, opens a
`torch.profiler` `record_function(name)` range around it, so the device's
kernels launched inside can be attributed.  A target that is not there
raises: a span never reads 0 because its layer moved.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time

import torch


class MissingSpanTarget(RuntimeError):
    """The program no longer has the method or function a span wraps."""


class Spans:
    def __init__(self, ranges: bool = True):
        self.records: list[tuple[str, int, int]] = []   # (name, t0, t1) ns
        self._range = (torch.profiler.record_function if ranges
                       else lambda name: contextlib.nullcontext())
        self._undo: list = []
        self._lock = threading.Lock()

    def wrap(self, owner, attr: str, name: str) -> None:
        original = getattr(owner, attr, None)
        if not callable(original):
            raise MissingSpanTarget(
                f"span {name!r}: {getattr(owner, '__name__', type(owner))}"
                f".{attr} is gone")
        had_own = attr in getattr(owner, "__dict__", {})

        @functools.wraps(original)
        def wrapped(*args, **kwargs):
            with self._range(name):
                t0 = time.perf_counter_ns()
                try:
                    return original(*args, **kwargs)
                finally:
                    t1 = time.perf_counter_ns()
                    with self._lock:
                        self.records.append((name, t0, t1))

        setattr(owner, attr, wrapped)
        self._undo.append((owner, attr, original, had_own))

    def restore(self) -> None:
        for owner, attr, original, had_own in reversed(self._undo):
            if had_own:
                setattr(owner, attr, original)
            else:
                delattr(owner, attr)
        self._undo.clear()

    def clear(self) -> None:
        with self._lock:
            self.records.clear()

    def durations_ms(self, name: str) -> list[float]:
        return [(t1 - t0) / 1e6 for n, t0, t1 in self.records if n == name]
