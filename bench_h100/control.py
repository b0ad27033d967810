"""The readings that a cell's limits are set from, on the card, in one
process: for each seed, the program's numbers over a short window at the
cell's own load (the lower readings), and on the first `--control` seeds
the control's: the plain reference computed in the next precision below
the configuration's (float8 e4m3 for bf16), put in the program's place
and judged by the same comparison (the upper readings).

    python3 bench_h100/control.py --workload gsc-serve-batch \
        --seeds 11,12,13 --seconds 5 --control 3

Prints a JSON line a seed, then the largest program reading and the
smallest control reading of each number, and of each number the look
reads besides: the untrimmed gaps, and the far shares at every envelope
of `LOOK_DELTAS` and distance of `LOOK_TAUS` (harness/compare.py).  The
benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", type=int, default=3)
    args = ap.parse_args(argv)

    import torch

    from bench_h100.harness import cells, device
    from bench_h100.run import Run

    cell = cells.load(args.workload)
    why = device.cards_ok(cell.entry["chips"])
    if why:
        print(f"control: {why}", file=sys.stderr)
        return 3
    lower: dict = {}
    upper: dict = {}
    for k, seed in enumerate(int(s) for s in args.seeds.split(",")):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = True
        run = Run(cell, seed, args.seconds, False, torch.device("cuda", 0))
        cell.driver.setup(run)
        run.window = cell.driver.window(run, run.seconds)
        cell.driver.release(run)
        gc.collect()
        torch.cuda.empty_cache()
        line = {"seed": seed, "failed": run.window["failed"],
                "program": {n: v for n, v, _ in
                            cell.driver.check(run, look=True)},
                "program_look": run.state.get("look")}
        if k < args.control:
            line["control"] = {n: v for n, v, _ in
                               cell.driver.control(run, look=True)}
            line["control_look"] = run.state.get("look")
        for n, v in {**line["program_look"], **line["program"]}.items():
            lower[n] = max(lower.get(n, v), v)
        for n, v in {**line.get("control_look", {}),
                     **line.get("control", {})}.items():
            upper[n] = min(upper.get(n, v), v)
        print(json.dumps(line), flush=True)
        del run
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"lower": lower, "upper": upper,
                      "ratio": {n: upper[n] / lower[n] for n in upper
                                if lower.get(n)}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
