"""Find the highest rate the served path sustains in an open loop, on the
card, in one process: for each seed of `--seeds` (its own weights and
photo pool), offer each rate of `--rates` for `--seconds` through the
cell's frontend and print a JSON line: the rate served, the latency
quantiles, whether the backlog grew (the last quarter's median latency
against the first quarter's), the requests a batch, and what the
frontend's threads did (harness/clock.py): the collector's and the
dispatcher's busy shares and their ms a batch, so the knee is attributed
to a layer and not only found.  The last line names the knee: the highest
rate at which no seed's backlog grew.

    python3 bench_h100/sweep.py --workload gsc-serve-open-half \
        --rates 48,72,96,120,144,168 --seconds 20 --seeds 7,8,9

An open-loop cell's fixed rate is set from the knee (PERF.md §4 says at
what share of it, and why).
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# the backlog grew where the last quarter's median latency is this many
# times the first quarter's, or a request went unanswered
GREW = 1.5


def row(rate: float, seed: int, w: dict) -> dict:
    """The sweep's line for one window of `offer`."""
    lat = w["latency_ms"]
    q = max(1, len(lat) // 4)
    growth = float(np.median(lat[-q:]) / np.median(lat[:q]))
    t = w["threads"]

    def p50(key):
        return float(np.median(t[key])) if len(t[key]) else None

    return {
        "rate": rate, "seed": seed,
        "served_per_s": w["units"] / w["window_s"], "failed": w["failed"],
        "p50_ms": float(np.percentile(lat, 50)),
        "p95_ms": float(np.percentile(lat, 95)),
        "p99_ms": float(np.percentile(lat, 99)),
        "last_vs_first_quarter": growth,
        "grew": bool(growth > GREW or w["failed"]),
        "occupancy": w["served"] / max(1, w["batches"]),
        "collector_busy": t["collector_busy"],
        "dispatcher_busy": t["dispatcher_busy"],
        "collector_ms_p50": p50("collector"),
        "handoff_ms_p50": p50("handoff"),
        "forward_ms_p50": p50("forward"),
        "preprocess_ms": t["preprocess_ms"],
        "late_ms_p95": float(np.percentile(w["late_ms"], 95))}


def knee(rows: list) -> float | None:
    """The highest rate at which no seed's backlog grew."""
    grew = {r["rate"] for r in rows if r["grew"]}
    held = [r["rate"] for r in rows if r["rate"] not in grew]
    return max(held) if held else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seeds", default="7")
    args = ap.parse_args(argv)

    import torch

    from bench_h100.harness import cells, device
    from bench_h100.run import Run

    cell = cells.load(args.workload)
    why = device.cards_ok(cell.entry["chips"])
    if why:
        print(f"sweep: {why}", file=sys.stderr)
        return 3
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        run = Run(cell, seed, args.seconds, False, torch.device("cuda", 0))
        cell.driver.setup(run)
        for rate in (float(r) for r in args.rates.split(",")):
            rows.append(row(rate, seed,
                            cell.driver.offer(run, rate, args.seconds)))
            print(json.dumps(rows[-1]), flush=True)
        cell.driver.release(run)
        del run
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"knee_per_s": knee(rows), "grew_above": GREW}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
