"""Find the highest rate the served path sustains in an open loop, on the
card, in one process: offer each rate of `--rates` for `--seconds` through
the cell's frontend and print the latency quantiles, the rate served and
whether the backlog grew (the last quarter's median latency against the
first quarter's).

    python3 bench_h100/sweep.py --workload gsc-serve-open \
        --rates 20,40,60,80 --seconds 10 --seed 7

A cell's fixed rate is set once from this, at four fifths of the highest
rate whose backlog did not grow.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)

    import torch

    from bench_h100.harness import cells, device
    from bench_h100.run import Run

    cell = cells.load(args.workload)
    why = device.cards_ok(cell.entry["chips"])
    if why:
        print(f"sweep: {why}", file=sys.stderr)
        return 3
    run = Run(cell, args.seed, args.seconds, False, torch.device("cuda", 0))
    cell.driver.setup(run)
    for rate in (float(r) for r in args.rates.split(",")):
        w = cell.driver.offer(run, rate, args.seconds)
        lat = w["latency_ms"]
        q = max(1, len(lat) // 4)
        growth = float(np.median(lat[-q:]) / np.median(lat[:q]))
        print(json.dumps({
            "rate": rate, "served_per_s": w["units"] / w["window_s"],
            "failed": w["failed"], "p50_ms": float(np.percentile(lat, 50)),
            "p95_ms": float(np.percentile(lat, 95)),
            "p99_ms": float(np.percentile(lat, 99)),
            "last_vs_first_quarter": growth,
            "occupancy": w["served"] / max(1, w["batches"]),
            "notes": w["notes"]}), flush=True)
    cell.driver.release(run)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
