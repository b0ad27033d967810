"""What the traced run reads from a `torch.profiler` Chrome trace: the
device's intervals, the host ranges the harness opened, the launches that
tie a kernel to the range it was launched in, and the shapes of the
attention ops.

Only device activity counts as busy (kernels, copies, sets); ATen ops on
the host nest and are not summed.  The idle share is the window less the
union of the device intervals, never their sum, since streams overlap.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
from collections import defaultdict

# (kind, substrings of a kernel's name), the first match wins; K1 and K2
# are the program's hand-written attention kernels
KERNEL_KINDS = (
    ("K1", ("attn_fwd", "fwd_combine")),
    ("K2", ("bwd_hopper", "bwd_prep", "bwd_dq", "bwd_f32")),
    ("layout transposes", ("nchwToNhwc", "nhwcToNchw")),
    ("FFT", ("fft",)),
    ("convolutions", ("conv", "fprop", "dgrad", "wgrad", "implicit")),
    ("matrix products", ("gemm", "Kernel2")),
    ("reductions", ("reduce_kernel",)),
    ("gathers and scatters", ("gather", "scatter", "index")),
    ("copies and casts", ("copy", "Memcpy", "Memset")),
    ("other elementwise", ("elementwise",)),
)
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_RANGE = "user_annotation"


def kernel_kind(name: str) -> str:
    for kind, keys in KERNEL_KINDS:
        if any(k in name for k in keys):
            return kind
    return "other"


@dataclasses.dataclass
class Trace:
    """The traced window, in the profiler's nanoseconds."""

    window_s: float
    device: list          # (name, start, end, correlation id), by start
    launches: dict        # correlation id -> host start of its launch
    ranges: dict          # harness range name -> [(start, end)]
    ops: list             # (op name, input shapes, input dtypes) of bsr ops

    # ------------------------------------------------------------ device
    def busy_intervals(self) -> list[tuple[int, int]]:
        merged: list[list[int]] = []
        for _, s, e, _ in self.device:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [tuple(m) for m in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s() / self.window_s)

    def kernel_seconds(self, patterns) -> float:
        return sum(e - s for n, s, e, _ in self.device
                   if any(p in n for p in patterns)) / 1e9

    def seconds_under(self, range_name: str) -> float:
        """Device seconds of the work launched while the host was inside
        the harness range `range_name`."""
        spans = sorted(self.ranges.get(range_name, ()))
        starts = [s for s, _ in spans]
        total = 0
        for _, s, e, corr in self.device:
            t = self.launches.get(corr)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans[i][1]:
                total += e - s
        return total / 1e9

    def calls(self, range_name: str) -> int:
        return len(self.ranges.get(range_name, ()))

    # --------------------------------------------------------- breakdown
    def device_ops(self, top: int = 10) -> list:
        """[[kind, seconds]] of the device's time by kernel kind."""
        by: dict = defaultdict(int)
        for n, s, e, _ in self.device:
            by[kernel_kind(n)] += e - s
        return [[k, v / 1e9] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """[[host range, seconds]]: the device's idle gaps summed by the
        innermost harness range open on the host at each gap's middle
        ("outside" when none is)."""
        opened = sorted((s, e, n) for n, lst in self.ranges.items()
                        for s, e in lst)
        starts = [s for s, _, _ in opened]
        by: dict = defaultdict(int)
        busy = self.busy_intervals()
        for (_, e0), (s1, _) in zip(busy, busy[1:]):
            inner, mid = "outside", (e0 + s1) // 2
            # the latest-opened range that still holds mid is the innermost
            for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
                if opened[i][1] >= mid:
                    inner = opened[i][2]
                    break
            by[inner] += s1 - e0
        return [[k, v / 1e9] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def collect(prof, window_s: float, path) -> Trace:
    """A `Trace` of a finished `torch.profiler.profile` (CPU and CUDA,
    `record_shapes=True`) over a window of `window_s` seconds, read from
    its Chrome trace, exported to `path`.  Raises when the device lane is
    empty: the device time is then unknown, not 0."""
    prof.export_chrome_trace(str(path))
    with open(path) as fh:
        events = json.load(fh).get("traceEvents", [])
    device, launches, ranges, ops = [], {}, defaultdict(list), []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, args = ev.get("cat"), ev.get("args", {})
        start = int(round(float(ev["ts"]) * 1e3))
        end = start + int(round(float(ev.get("dur", 0.0)) * 1e3))
        if cat in DEVICE_ACTIVITIES:
            device.append((ev["name"], start, end, args.get("correlation")))
        elif cat in ("cuda_runtime", "cuda_driver"):
            launches[args.get("correlation")] = start
        elif cat == HOST_RANGE:
            ranges[ev["name"]].append((start, end))
        elif cat == "cpu_op" and ev["name"].startswith("bsr::"):
            ops.append((ev["name"], args.get("Input Dims", []),
                        args.get("Input type", [])))
    if not device:
        raise RuntimeError("the profiler recorded no device activity: "
                           "refusing to report device time as 0")
    device.sort(key=lambda d: d[1])
    return Trace(window_s, device, launches, dict(ranges), ops)
