"""The harness the port's tools share (counterpart of `bench.py:101-147`,
`timed_scan_fn` and `timed_scan`, and of `tools/trace_utils.py` in the JAX
package).

  * `timed_fn`: best seconds of `iters` chained calls of a step whose
    input is perturbed on the device at every call, by CUDA events after a
    warm-up, with the summed result fetched once a trial and required to
    change between trials (a step that ignores its inputs, or a replayed
    result, raises `StaleResultError`).  Below a batch of QUEUED_BELOW
    the stream is held behind a spin kernel while the host enqueues a
    call, one call at a time and their device times summed: there a K1
    call is shorter than its launch through the ctypes wrapper, and
    events around calls launched as they come read the launch rate.  A
    step that waits on the device cannot be queued, and raises
    `HostSyncError`.
  * `count_work`: the FLOPs (`torch.utils.flop_counter.FlopCounterMode`)
    and the bytes a call moves, eager and unfused: each op's inputs read
    and outputs written once.  The NonLocal attention is one op a call
    (`ops/nonlocal_attn.py`), counted by its own FLOP formula whatever
    runs inside it (K1 and K2 through ctypes, which no dispatch mode sees,
    or the plain version), so the count is the same on both routes.
  * `parse_trace`: a torch.profiler Chrome trace summed by name over the
    device's kernel events only (`kernel`, `gpu_memcpy`, `gpu_memset`), or
    on the CPU over the outermost `cpu_op` events of each thread; ATen ops
    nest (and `gpu_user_annotation` ranges enclose kernels), so summing
    every event double-counts, the trap `trace_utils.py` guards against
    for XLA's lanes.  It raises rather than report 0.
  * The H100's published peaks, here once (`chip_smoke.py` imports them).

    python -m blindshadowremoval_tpu_torch.tools._timing TRACE.json [--top N]

prints the top kernels of a trace that `torch.profiler` exported.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import time
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from blindshadowremoval_tpu_torch.config import resolve_device
# defines the attention's ops, torch.ops.bsr.*
from blindshadowremoval_tpu_torch.ops import nonlocal_attn  # noqa: F401

# H100 SXM published dense peaks (NVIDIA H100 datasheet), at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12      # the CUDA cores
PEAK_TF32_FLOPS = 495e12    # the tensor cores on TF32 operands
PEAK_BYTES = 3.35e12

ITERS = 40            # bench.py:54
QUEUED_BELOW = 16     # batches below this are timed with the calls queued
STEP_EPS = 1e-6       # the per-call perturbation (bench.py:125)
TRIAL_EPS = 1e-5      # the per-trial one (bench.py:134)

# (kind, substrings of a kernel's name), the first match wins; K1 and K2
# are the port's hand-written kernels (csrc/nonlocal_attn*.cu)
_KERNEL_KINDS = (
    ("K1", ("attn_fwd",)),
    ("K2", ("bwd_hopper", "bwd_prep", "bwd_dq", "bwd_f32")),
    ("layout transposes (cuDNN NCHW <-> NHWC)", ("nchwToNhwc", "nhwcToNchw")),
    ("FFT (disc blurs)", ("fft",)),
    ("convolutions", ("conv", "fprop", "dgrad", "wgrad", "implicit")),
    ("matrix products", ("gemm", "Kernel2")),
    ("reductions", ("reduce_kernel",)),
    ("copies and casts", ("copy",)),
    ("other elementwise", ("elementwise",)),
)
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


SPIN_CYCLES = 50_000_000   # ~25 ms at 1.98 GHz: a B=2 forward's enqueueing
QUEUE_TRIES = 5            # spins of 50e6 to 800e6 cycles before giving up


class StaleResultError(RuntimeError):
    """A timed step's result did not change although its input did."""


class HostSyncError(RuntimeError):
    """Calls could not be queued behind the spin kernel, so the spin ended
    before they were: they wait on the device (a host fetch, or a copy of
    a fresh host tensor to the card, synchronizes the stream), or they
    hold more launches than the device's queue of pending launches (about
    a thousand on an H100; a B=2 generator forward is 277, FAN-4's
    forward more than the queue holds), and then the host waits for room
    and the device idles while the host catches up."""


def kernel_kind(name: str) -> str:
    for kind, keys in _KERNEL_KINDS:
        if any(k in name for k in keys):
            return kind
    return "other"


def add_device_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where the tool measures: the CUDA card "
                             "(default; raises without one), or the CPU "
                             "with the kernels' plain PyTorch versions")


def device_label(device) -> str:
    """The card's name and power limit as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` gives them, or
    "cpu"."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return "cpu"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return f"{torch.cuda.get_device_name(index)}, power limit not read"
    return out.splitlines()[0]


def synchronize(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_span(enqueue, dev: torch.device, queued: bool = False):
    """(seconds, result) of `enqueue()`: on the card the device time
    between CUDA events recorded before and after it (with `queued`, the
    stream held behind a spin kernel until the host has enqueued all of
    it; from SPIN_CYCLES the spin doubles until it outlasts the
    enqueueing, QUEUE_TRIES times at most, then HostSyncError),
    synchronized; on the CPU the host clock."""
    if dev.type == "cpu":
        t0 = time.perf_counter()
        out = enqueue()
        return time.perf_counter() - t0, out
    cycles = SPIN_CYCLES
    for _ in range(QUEUE_TRIES if queued else 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(cycles)
        start.record()
        out = enqueue()
        end.record()
        in_time = not (queued and start.query())
        torch.cuda.synchronize(dev)
        if in_time:
            return start.elapsed_time(end) / 1e3, out
        cycles *= 2
    raise HostSyncError(f"the calls outlasted a spin of {cycles // 2} "
                        "cycles: they wait on the device, or hold more "
                        "launches than its queue")


def device_ms(fn, iters: int = 100) -> float:
    """Mean milliseconds of device work per call of `fn` on the card, with
    the calls queued ahead (`device_span(..., queued=True)`).
    (torch.profiler's traces of 50 such calls held only 0-47 of them late
    in a long process: do not divide a trace's device time by the calls
    made.)"""
    fn()
    torch.cuda.synchronize()
    seconds, _ = device_span(lambda: [fn() for _ in range(iters)],
                             torch.device("cuda"), queued=True)
    return 1e3 * seconds / iters


def timing_mode(dev: torch.device, batch: int) -> str:
    """How `timed_fn` times a step of `batch`: "host" (the host clock, on
    the CPU), "queued" (the calls queued behind a spin kernel) or
    "events" (CUDA events around calls launched as they come)."""
    if dev.type == "cpu":
        return "host"
    return "queued" if batch < QUEUED_BELOW else "events"


def timed_fn(step, x: torch.Tensor, *rest, iters: int = ITERS,
             trials: int = 3) -> float:
    """Best seconds for `iters` chained calls of `step(x', *rest) -> 0-d
    tensor`, x' = x + t * STEP_EPS + trial * TRIAL_EPS added on the device
    at call t of a trial (bench.py's per-scan-step and per-trial
    perturbations), the results summed on the device in f64 and fetched
    once a trial.  One chain warms up first (kernel builds, cuDNN's algorithm
    search, the allocator).  Timed as `timing_mode` says for x's first
    dimension: by events around the chain, or queued a call at a time (the
    device holds a bounded queue of pending launches, which a chain of
    forwards overflows), the calls' device times summed; a call that
    cannot be queued raises HostSyncError.  Raises StaleResultError when a
    trial's sum equals the one before it or is not finite."""
    dev = x.device
    queued = timing_mode(dev, x.shape[0]) == "queued"

    def call(acc: torch.Tensor, t: int, trial: int) -> torch.Tensor:
        # summed in f64: a small term's change must survive a large one
        return acc + step(x + (t * STEP_EPS + trial * TRIAL_EPS),
                          *rest).double()

    def chain(trial: int) -> torch.Tensor:
        acc = torch.zeros((), dtype=torch.float64, device=dev)
        for t in range(iters):
            acc = call(acc, t, trial)
        return acc

    def timed_chain(trial: int):
        """(seconds, summed results) of a trial's calls."""
        if not queued:
            return device_span(lambda: chain(trial), dev)
        seconds = 0.0
        acc = torch.zeros((), dtype=torch.float64, device=dev)
        for t in range(iters):
            span, acc = device_span(lambda: call(acc, t, trial), dev, True)
            seconds += span
        return seconds, acc

    prev = float(chain(0))
    best = float("inf")
    for trial in range(1, trials + 1):
        seconds, acc = timed_chain(trial)
        val = float(acc)
        if not math.isfinite(val) or val == prev:
            raise StaleResultError(
                f"benchmark result did not change between trials ({prev!r} "
                f"then {val!r}): a step that ignores its input, or a stale "
                "replay")
        prev = val
        best = min(best, seconds)
    return best


# ---------------------------------------------------------------------------
# FLOPs and bytes
# ---------------------------------------------------------------------------

def _tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


_NO_TRAFFIC = ("detach", "empty", "empty_strided", "empty_like",
               "lift_fresh", "alias", "_local_scalar_dense")


_ATTENTION_OPS = {torch.ops.bsr.nonlocal_attn: "fwd",
                  torch.ops.bsr.nonlocal_attn_lse: "fwd",
                  torch.ops.bsr.nonlocal_attn_bwd: "bwd"}


class Work(TorchDispatchMode):
    """FLOPs and bytes of what runs under `count_work`, and the attention's
    calls (`attention_calls`: (B, N, D, "fwd" | "bwd")).  As a dispatch
    mode it sums each op's tensor inputs and outputs, once each, in bytes:
    eager PyTorch does not fuse, so this is the traffic of the unfused
    program (views and allocations move nothing)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.attention_calls: list[tuple] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        kind = _ATTENTION_OPS.get(func.overloadpacket)
        if kind is not None:
            self.attention_calls.append((*args[0].shape, kind))
        if not func.is_view and func.overloadpacket.__name__ not in _NO_TRAFFIC:
            self.bytes += sum(_tensor_bytes(t)
                              for t in tree_leaves((args, kwargs, out))
                              if isinstance(t, torch.Tensor))
        return out


@contextlib.contextmanager
def count_work():
    """Counts FLOPs and bytes of what runs inside (module docstring);
    yields a `Work`, complete when the block exits."""
    work, flops = Work(), FlopCounterMode(display=False)
    with flops, work:
        yield work
    work.flops = flops.get_total_flops()


# ---------------------------------------------------------------------------
# torch.profiler traces
# ---------------------------------------------------------------------------


def parse_trace(path: str, lane: str = "device"):
    """(name -> total us, name -> count, total us) of a torch.profiler
    Chrome trace: `lane="device"` sums the kernel, memcpy and memset
    events; `lane="cpu"` the outermost `cpu_op` events of each thread.
    Raises ValueError when the lane holds no event."""
    with open(path) as fh:
        events = json.load(fh).get("traceEvents", [])
    spans = [e for e in events if e.get("ph") == "X"]
    if lane == "device":
        picked = [e for e in spans if e.get("cat") in DEVICE_CATEGORIES]
    elif lane == "cpu":
        picked = []
        ops = sorted((e for e in spans if e.get("cat") == "cpu_op"),
                     key=lambda e: (e["pid"], e["tid"], float(e["ts"]),
                                    -float(e.get("dur", 0.0))))
        ends: dict = {}
        for e in ops:
            key = (e["pid"], e["tid"])
            ts, end = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
            if ts >= ends.get(key, float("-inf")):
                picked.append(e)
                ends[key] = end
    else:
        raise ValueError(f"lane must be 'device' or 'cpu', got {lane!r}")
    if not picked:
        raise ValueError(
            f"trace {path} has no {lane} events "
            f"({DEVICE_CATEGORIES if lane == 'device' else 'cpu_op'}): "
            "refusing to report 0 device time")
    agg: dict = defaultdict(float)
    cnt: dict = defaultdict(int)
    for e in picked:
        agg[e.get("name", "?")] += float(e.get("dur", 0.0))
        cnt[e.get("name", "?")] += 1
    return dict(agg), dict(cnt), sum(agg.values())


def by_kind(agg: dict, cnt: dict) -> dict:
    """{kind: [us, count]} of parse_trace's sums."""
    kinds: dict = {}
    for name, us in agg.items():
        entry = kinds.setdefault(kernel_kind(name), [0.0, 0])
        entry[0] += us
        entry[1] += cnt[name]
    return kinds


def top_kernels(agg: dict, cnt: dict, top: int) -> list:
    """[[name (its first 100 characters), ms, count, kind], ...] of the
    `top` largest sums."""
    return [[name[:100], us / 1e3, cnt[name], kernel_kind(name)]
            for name, us in sorted(agg.items(), key=lambda kv: -kv[1])[:top]]


def summary(agg: dict, cnt: dict, window_us: float, top: int) -> dict:
    """The profilers' record of parse_trace's sums: {"window_ms", "kinds":
    {kind: [ms, launches]}, "top": top_kernels}."""
    return {"window_ms": window_us / 1e3,
            "kinds": {k: [us / 1e3, c] for k, (us, c)
                      in by_kind(agg, cnt).items()},
            "top": top_kernels(agg, cnt, top)}


def print_top(agg: dict, cnt: dict, window_us: float, top: int = 25) -> None:
    """The kernels' total against the traced window, then the `top`
    largest sums with their kind, K1 and K2 named."""
    total = sum(agg.values())
    print(f"device time: kernels {total / 1e3:.1f} ms in a "
          f"{window_us / 1e3:.1f} ms window")
    denom = total or 1.0
    for name, ms, count, kind in top_kernels(agg, cnt, top):
        print(f"{ms:9.2f} ms  {100 * ms * 1e3 / denom:5.1f}%  x{count:<4d} "
              f"[{kind}] {name}")


def profile_calls(fn, calls: int, dev: torch.device, out_dir: str):
    """`calls` calls of `fn` under torch.profiler (host, and the card on
    CUDA), synchronized; the Chrome trace written to
    `<out_dir>/trace.json` and parsed (the device lane on the card, the CPU
    ops on the CPU).  Returns (agg, cnt, window us, trace path)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        synchronize(dev)
        window_us = (time.perf_counter() - t0) * 1e6
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    agg, cnt, _ = parse_trace(path, "device" if dev.type == "cuda" else "cpu")
    return agg, cnt, window_us, path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m blindshadowremoval_tpu_torch.tools._timing",
        description="Top kernels of a torch.profiler Chrome trace, summed "
                    "by name over the device's kernel events only")
    ap.add_argument("trace")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--lane", default="device", choices=["device", "cpu"])
    args = ap.parse_args(argv)
    agg, cnt, total = parse_trace(args.trace, args.lane)
    print_top(agg, cnt, total, top=args.top)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
