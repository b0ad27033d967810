"""Batch-size sweep of the headline inference benchmark (counterpart of
`tools/bench_sweep.py`).

`tools/bench.py`'s model and harness across batch sizes, in the serving
configuration it headlines; the generator is built once (its parameters do
not depend on the batch).  Batches below 16 are timed with the calls
queued behind a spin kernel (`_timing.QUEUED_BELOW`), where a forward's
kernels can be shorter than their launches; "timing" says how each batch
was timed.  One JSON line a batch.

    python -m blindshadowremoval_tpu_torch.tools.bench_sweep \
        [--int8-head] [--batches 64 96 128 ...] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

from blindshadowremoval_tpu_torch.config import resolve_device
from blindshadowremoval_tpu_torch.tools import _timing, bench


def sweep(batches, int8_head: bool = False, iters: int = bench.ITERS,
          device=None):
    """Yields {"batch", "faces_per_sec", "timing", "device"} a batch
    ("timing": `_timing.timing_mode`)."""
    dev = resolve_device(device)
    label = _timing.device_label(dev)
    model = bench.make_gen(int8_head=int8_head, device=dev)
    for batch in batches:
        img, uv, reg = bench.make_inputs(batch, bench.SIZE, 0, dev)
        best = bench.timed_forward(model, img, uv, reg, iters=iters)
        yield {"batch": batch, "faces_per_sec": round(batch * iters / best, 1),
               "timing": _timing.timing_mode(dev, batch), "device": label}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m blindshadowremoval_tpu_torch.tools.bench_sweep",
        description="bench's faces/s across batch sizes")
    ap.add_argument("--batches", type=int, nargs="+",
                    default=[64, 96, 128, 192, 256])
    ap.add_argument("--int8-head", action="store_true",
                    help="sweep the opt-in int8-head path instead of the "
                         "production bf16 configuration")
    _timing.add_device_arg(ap)
    args = ap.parse_args(argv)
    for line in sweep(args.batches, args.int8_head, device=args.device):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
