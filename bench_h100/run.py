"""Run one cell of the port's benchmark once on this machine's cards.

    python3 bench_h100/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Builds and warms the cell (its set-up, timed as `setup_s`), measures for
`--seconds`, checks every answer of the window against the plain
reference under `bench_h100/reference/`, and prints one JSON line last on
standard output: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics, or with `--trace 1` its per-layer metrics read from a
torch.profiler trace of the window), `device`, with `--trace 1` a
`breakdown`, the window's `notes` (what the driver saw besides the
metrics; also on standard error), and last `checks`, each compared number
beside its limit (also the last lines of standard error).  Exits
non-zero, with no result, without enough CUDA cards, when the program is
missing, when JAX or the JAX package was loaded, or when a per-layer
metric of the cell found nothing to read.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse   # noqa: E402
import json       # noqa: E402
import os         # noqa: E402
import sys        # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# a traced window is at most this long: the profiler's trace, its export
# and its reading grow with it, and the run has to end within its limit
TRACE_SECONDS = 8.0


class Run:
    """One run of a cell: its arguments and files, and what the driver,
    the window and the trace leave for the metric readers and the check."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool, device):
        self.cell = cell
        self.seed = seed
        self.seconds = seconds
        self.traced = trace
        self.device = device
        self.state: dict = {}         # the driver's
        self.spans = None             # harness.spans.Spans, traced runs
        self.trace = None             # harness.trace.Trace, traced runs
        self.window: dict = {}        # what the window measured


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _fail(msg: str, code: int) -> int:
    print(f"bench_h100: {msg}", file=sys.stderr, flush=True)
    return code


def _traced_window(run: Run) -> None:
    import torch

    from bench_h100.harness.spans import Spans
    from bench_h100.harness.trace import collect

    run.spans = Spans()
    run.cell.driver.install_spans(run, run.spans)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    try:
        with torch.profiler.profile(activities=acts,
                                    record_shapes=True) as prof:
            run.window = run.cell.driver.window(
                run, min(run.seconds, TRACE_SECONDS))
    finally:
        run.spans.restore()
    path = ROOT / "bench_h100" / "_work" / f"trace-{run.cell.name}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    try:
        run.trace = collect(prof, run.window["window_s"], path)
    finally:
        path.unlink(missing_ok=True)


def read_per_layer(run: Run) -> tuple[dict, list]:
    """({name: {"value", "unit"}} of the cell's per-layer metrics, the
    names of those whose reader found nothing).  Every metric a cell
    lists has something to read in it: one that reads nothing is a fault
    (a span's target gone, a kernel renamed), which fails the run."""
    metrics, unread = {}, []
    for m in run.cell.per_layer:
        value = run.cell.reader(m["name"]).read(run)
        if value is None:
            unread.append(m["name"])
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return metrics, unread


def execute(cell, seed: int, seconds: float, traced: bool, device) -> dict:
    """One run of `cell` on `device`: set-up, the window (traced or not),
    the metrics, then the check of every answer.  Returns the result line
    as a dict: the window's `notes`, then `checks`, then `unread`: the
    per-layer metrics that found nothing to read."""
    import torch

    from bench_h100.harness import device as dev

    on_card = device.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    run = Run(cell, seed, seconds, traced, device)
    cell.driver.setup(run)
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    if run.traced:
        _traced_window(run)
    else:
        run.window = cell.driver.window(run, run.seconds)
    record = (dev.device_record(cell.entry["chips"]) if on_card
              else {"platform": "cpu", "count": 0})

    metrics, breakdown, unread = {}, None, []
    if run.traced:
        metrics, unread = read_per_layer(run)
        record["busy_s"] = run.trace.busy_s()
        record["window_s"] = run.trace.window_s
        breakdown = {"device_ops": run.trace.device_ops(),
                     "idle_gaps": run.trace.idle_gaps()}
    else:
        values = dict(run.window["metrics"], setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(values[m["name"]]),
                                  "unit": m["unit"]}

    cell.driver.release(run)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    failed = int(run.window["failed"])
    checks = [("answers_missing", failed, 0)] + cell.driver.check(run)
    result = {"correct": all(v <= lim for _, v, lim in checks),
              "attempted": int(run.window["attempted"]), "failed": failed,
              "metrics": metrics, "device": record}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["notes"] = run.window.get("notes", [])
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    result["unread"] = unread
    return result


def main(argv=None) -> int:
    args = _args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    try:
        from bench_h100.harness import cells
        cell = cells.load(args.workload)
    except (OSError, KeyError, StopIteration, json.JSONDecodeError) as e:
        return _fail(f"cannot load cell {args.workload!r}: {e}", 2)
    import torch

    from bench_h100.harness import device as dev

    why = dev.cards_ok(cell.entry["chips"])
    if why:
        return _fail(f"no result: {why}", 3)
    try:
        import blindshadowremoval_tpu_torch  # noqa: F401
    except ImportError as e:
        return _fail(f"the program is missing: {e}", 4)

    result = execute(cell, args.seed, args.seconds, bool(args.trace),
                     torch.device("cuda", 0))
    loaded = dev.forbidden_loaded()
    if loaded:
        return _fail(f"no result: the process loaded {loaded}", 5)
    unread = result.pop("unread")
    if unread:
        return _fail(f"no result: {', '.join(unread)} found nothing to "
                     f"read in {cell.name}", 6)
    for line in result["notes"]:
        print(line, file=sys.stderr)
    for n, c in result["checks"].items():
        print(f"check {n} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
