"""Device profile of the headline inference forward: the top kernels by
device time, K1 named (counterpart of `tools/profile_infer.py`).

`tools/bench.py`'s model and inputs, `--iters` forwards under
torch.profiler (each ending in a scalar fetch, as the JAX tool's do), the
Chrome trace summed over the device's kernel events only
(`_timing.parse_trace`).  On the CPU (`--device cpu`) the outermost ATen
ops stand in for kernels.  The trace stays in `--out` (a new temporary
directory by default).  The text lines, then one JSON line.

    python -m blindshadowremoval_tpu_torch.tools.profile_infer \
        [--batch 128] [--iters 8] [--int8-head] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import tempfile

import torch

from blindshadowremoval_tpu_torch.config import resolve_device
from blindshadowremoval_tpu_torch.tools import _timing, bench


def profile(batch: int = 128, iters: int = 8, out: str | None = None,
            top: int = 25, int8_head: bool = False, device=None) -> dict:
    """Profiles `iters` forwards; prints the JAX tool's lines and returns
    {"batch", "iters", "device_ms_per_fwd", "us_per_face", "window_ms",
    "kinds": {kind: [ms, launches]}, "top": [[name, ms, count, kind]],
    "trace", "device"}."""
    dev = resolve_device(device)
    out = out or tempfile.mkdtemp(prefix="infer_trace_")
    model = bench.make_gen(int8_head=int8_head, device=dev)
    img, uv, reg = bench.make_inputs(batch, bench.SIZE, 0, dev)
    fwd = bench.step(model)
    calls = iter(range(1, iters + 1))
    acc = []

    def one():
        t = next(calls)
        acc.append(float(fwd(img + t * _timing.STEP_EPS, uv, reg)))

    with torch.inference_mode():
        print("warmup:", float(fwd(img, uv, reg)))
        agg, cnt, window_us, path = _timing.profile_calls(one, iters, dev,
                                                          out)
    print("traced", iters, "forwards; acc", sum(acc))
    total = sum(agg.values())
    print(f"\ntotal device time {total / 1e3:.1f} ms over {iters} "
          f"fwd x batch {batch} = {total / iters / batch:.1f} us/face")
    _timing.print_top(agg, cnt, window_us, top=top)
    return {"batch": batch, "iters": iters,
            "device_ms_per_fwd": total / iters / 1e3,
            "us_per_face": total / iters / batch,
            **_timing.summary(agg, cnt, window_us, top), "trace": path,
            "device": _timing.device_label(dev)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m blindshadowremoval_tpu_torch.tools.profile_infer",
        description="Top kernels of bench's forward by device time")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--out", default=None,
                    help="directory for the Chrome trace (default: a new "
                         "temporary directory)")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--int8-head", action="store_true",
                    help="profile the opt-in int8-head path instead of the "
                         "production bf16+folded-BN config")
    _timing.add_device_arg(ap)
    args = ap.parse_args(argv)
    print(json.dumps(profile(args.batch, args.iters, args.out, args.top,
                             args.int8_head, args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
