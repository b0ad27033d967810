"""The open loop's request timed from outside the program, in every run:
host-clock spans (harness/spans.py, without profiler ranges) around the
service's `preprocess`, `stage` and `forward_staged`, the three calls the
frontend's two threads make for a batch.  They cost a few clock reads a
request; `Spans.restore` takes them off.

The collector thread preprocesses a batch's requests one by one and then
stages the batch; the dispatcher thread runs its forward.  So, in start
order, each `stage` closes a batch whose preprocess calls came since the
one before, and the k-th `forward_staged` is the k-th staged batch's (the
hand-off is a FIFO queue).  From those records: each batch's collector ms
(its preprocess calls plus its stage), its hand-off wait (end of its
stage to start of its forward) and its forward ms; and the share of the
window each thread was busy.
"""

from __future__ import annotations

import numpy as np

from bench_h100.harness.spans import Spans

COLLECTOR = ("preprocess", "stage")
DISPATCHER = "forward_staged"


def time_service(svc) -> Spans:
    """Host-clock spans on the service's three calls, each under its own
    name."""
    spans = Spans(ranges=False)
    for attr in COLLECTOR + (DISPATCHER,):
        spans.wrap(svc, attr, attr)
    return spans


def batches(records: list) -> dict:
    """Per batch, in ms: `collector` (its preprocess calls and its stage),
    `handoff` (end of its stage to start of its forward), `forward`."""
    records = sorted(records, key=lambda r: r[1])
    collector, stage_ends, pending = [], [], 0
    for name, t0, t1 in records:
        if name == "preprocess":
            pending += t1 - t0
        elif name == "stage":
            collector.append((pending + t1 - t0) / 1e6)
            stage_ends.append(t1)
            pending = 0
    forwards = [(t0, t1) for name, t0, t1 in records if name == DISPATCHER]
    n = min(len(stage_ends), len(forwards))
    return {
        "collector": np.asarray(collector, float),
        "handoff": np.asarray([(forwards[k][0] - stage_ends[k]) / 1e6
                               for k in range(n)], float),
        "forward": np.asarray([(t1 - t0) / 1e6 for t0, t1 in forwards],
                              float)}


def summarize(records: list, window_s: float) -> dict:
    """The per-batch arrays, each thread's busy share of `window_s`, and
    the mean preprocess ms a request."""
    busy = {name: sum(t1 - t0 for n, t0, t1 in records if n == name) / 1e9
            for name in COLLECTOR + (DISPATCHER,)}
    pre = [(t1 - t0) / 1e6 for n, t0, t1 in records if n == "preprocess"]
    return {
        **batches(records),
        "collector_busy": (busy["preprocess"] + busy["stage"]) / window_s,
        "preprocess_busy": busy["preprocess"] / window_s,
        "stage_busy": busy["stage"] / window_s,
        "dispatcher_busy": busy[DISPATCHER] / window_s,
        "preprocess_ms": float(np.mean(pre)) if pre else float("nan")}


def quantiles(what: str, ms: np.ndarray, of: str = "requests") -> str:
    """One line of a sample's p50, p95, p99 and max."""
    if not len(ms):
        return f"{what}: none"
    q = {p: float(np.percentile(ms, p)) for p in (50, 95, 99)}
    return (f"{what}: p50 {q[50]!r} p95 {q[95]!r} p99 {q[99]!r} max "
            f"{float(ms.max())!r} over {len(ms)} {of}")


def notes(s: dict) -> list[str]:
    """The result's lines of a summary."""
    return [
        f"collector busy share {s['collector_busy']!r} (preprocess "
        f"{s['preprocess_busy']!r}, stage {s['stage_busy']!r}); dispatcher "
        f"busy share {s['dispatcher_busy']!r}; preprocess ms a request "
        f"{s['preprocess_ms']!r}",
        quantiles("collector ms a batch", s["collector"], "batches"),
        quantiles("hand-off wait ms a batch", s["handoff"], "batches"),
        quantiles("forward ms a batch", s["forward"], "batches")]
