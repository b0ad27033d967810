"""Device profile of the fused G+D train step: the top kernels by device
time, K1 and K2 named (counterpart of `tools/profile_train.py`).

The step profiled is `Trainer.train_step` (augmentation on the device, the
generator, 3 discriminators and VGG-19, the full loss stack, both Adam
updates) at 256 px on `tools/bench_train.py`'s seeded batch, at the given
batch size, dtypes and `--remat` (`Config.remat`).  One step warms up,
then `--iters` steps run under torch.profiler, each ending in a loss
fetch; the Chrome trace is summed over the device's kernel events only
(`_timing.parse_trace`; on the CPU the outermost ATen ops).  The text
lines, then one JSON line.

    python -m blindshadowremoval_tpu_torch.tools.profile_train \
        [--batch 8] [--iters 4] [--remat] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import tempfile

import torch

from blindshadowremoval_tpu_torch.config import resolve_device
from blindshadowremoval_tpu_torch.tools import _timing, bench_train


def profile(batch: int = 8, iters: int = 4, remat: bool = False,
            compute_dtype: str = "bfloat16", vgg_dtype: str = "bfloat16",
            out: str | None = None, top: int = 30, device=None) -> dict:
    """Profiles `iters` steps; prints the JAX tool's lines and returns
    {"batch", "views_per_step", "remat", "device_ms_per_step",
    "us_per_view", "window_ms", "kinds", "top", "trace", "device"}."""
    dev = resolve_device(device)
    out = out or tempfile.mkdtemp(prefix="train_trace_")
    trainer, state = bench_train.trainer_for(batch, compute_dtype, vgg_dtype,
                                             remat, False, dev)
    data = bench_train.train_batch(batch, bench_train.SIZE, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    box = [state, 0.0]

    def one():
        box[0], losses, _ = trainer.train_step(box[0], data, gen)
        box[1] += float(losses["recon_c"])

    one()
    print("warmup loss:", box[1], flush=True)
    box[1] = 0.0
    agg, cnt, window_us, path = _timing.profile_calls(one, iters, dev, out)
    print(f"traced {iters} steps; acc {box[1]}", flush=True)
    b2 = 2 * batch
    total = sum(agg.values())
    print(f"\nbatch {batch} (x2 views), remat={remat}: "
          f"{total / iters / 1e3:.1f} ms/step, "
          f"{total / (iters * b2):.0f} us/view")
    _timing.print_top(agg, cnt, window_us, top=top)
    return {"batch": batch, "views_per_step": b2, "remat": remat,
            "device_ms_per_step": total / iters / 1e3,
            "us_per_view": total / (iters * b2),
            **_timing.summary(agg, cnt, window_us, top), "trace": path,
            "device": _timing.device_label(dev)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m blindshadowremoval_tpu_torch.tools.profile_train",
        description="Top kernels of the train step by device time")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--compute-dtype", default="bfloat16")
    ap.add_argument("--vgg-dtype", default="bfloat16")
    ap.add_argument("--out", default=None,
                    help="directory for the Chrome trace (default: a new "
                         "temporary directory)")
    ap.add_argument("--top", type=int, default=30)
    _timing.add_device_arg(ap)
    args = ap.parse_args(argv)
    print(json.dumps(profile(args.batch, args.iters, args.remat,
                             args.compute_dtype, args.vgg_dtype, args.out,
                             args.top, args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
