"""Roofline of the headline inference forward (counterpart of
`tools/roofline_infer.py`).

Counts the FLOPs and bytes of one forward of `tools/bench.py`'s model
(`_timing.count_work`), times it with bench's harness, and sets the time
against the card's two bounds:

    t_compute   = flops / peak_flops
    t_bandwidth = bytes / peak_bandwidth
    speed_of_light = max(t_compute, t_bandwidth)

FLOPs: `torch.utils.flop_counter.FlopCounterMode` (convolutions and
matrix products, 2 per multiply-add, as XLA's cost analysis counts them),
the attention by its op's formula, 4*B*N^2*D a call: K1 launches through
ctypes, which no dispatch mode sees, so the op is counted whatever runs
inside it, on the card and on the CPU alike (at 256 px it is ~18% of the
forward's FLOPs).
Bytes: eager PyTorch does not fuse, so the count is each ATen op's inputs
and outputs ("unfused"), where XLA reports the bytes its fused program
accesses; the bandwidth bound is then that of the unfused program.

Peaks default to the H100 SXM's published dense rates (bf16 989 TFLOP/s,
HBM 3.35 TB/s; `_timing.py`), at its 700 W limit: the card's own limit is
printed in "device".

    python -m blindshadowremoval_tpu_torch.tools.roofline_infer \
        [--batch 128] [--iters 64] [--int8-head] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import torch

from blindshadowremoval_tpu_torch.config import resolve_device
from blindshadowremoval_tpu_torch.tools import _timing, bench


def count(model, img, uv, reg) -> _timing.Work:
    """FLOPs and unfused bytes of one forward of `model` on these inputs."""
    with torch.inference_mode(), _timing.count_work() as work:
        model(img, uv, reg)
    return work


def roofline(batch: int = 128, iters: int = 64,
             peak_tflops: float = _timing.PEAK_BF16_FLOPS / 1e12,
             peak_gbps: float = _timing.PEAK_BYTES / 1e9,
             int8_head: bool = False, fold_bn: bool = True,
             device=None) -> dict:
    """roofline_infer's record of bench's forward at `batch` on `device`
    (CUDA unless "cpu")."""
    dev = resolve_device(device)
    model = bench.make_gen(int8_head=int8_head, fold_bn=fold_bn, device=dev)
    img, uv, reg = bench.make_inputs(batch, bench.SIZE, 0, dev)
    work = count(model, img, uv, reg)
    flops, byts = float(work.flops), float(work.bytes)
    step_s = bench.timed_forward(model, img, uv, reg, iters=iters) / iters
    t_compute = flops / (peak_tflops * 1e12)
    t_bandwidth = byts / (peak_gbps * 1e9)
    sol = max(t_compute, t_bandwidth)
    return {
        "config": ("int8_head" if int8_head else "production")
                  + ("+fold_bn" if fold_bn else ""),
        "batch": batch,
        "gflops_per_face": flops / batch / 1e9,
        "mb_accessed_per_face": byts / batch / 1e6,
        "arithmetic_intensity_flop_per_byte": flops / max(byts, 1.0),
        "measured_ms_per_batch": step_s * 1e3,
        "faces_per_sec": batch / step_s,
        "t_compute_ms": t_compute * 1e3,
        "t_bandwidth_ms": t_bandwidth * 1e3,
        "bound": "bandwidth" if t_bandwidth > t_compute else "compute",
        "speed_of_light_ms": sol * 1e3,
        "fraction_of_speed_of_light": sol / step_s,
        "bytes_counted": "unfused: each ATen op's inputs and outputs",
        "attention_launches": len(work.attention_calls),
        "device": _timing.device_label(dev),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m blindshadowremoval_tpu_torch.tools.roofline_infer",
        description="Roofline of bench's forward: counted FLOPs and unfused "
                    "bytes against the card's peaks, and the measured time")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--iters", type=int, default=64)
    ap.add_argument("--peak-tflops", type=float,
                    default=_timing.PEAK_BF16_FLOPS / 1e12,
                    help="peak bf16 TFLOP/s (H100 SXM: 989)")
    ap.add_argument("--peak-gbps", type=float,
                    default=_timing.PEAK_BYTES / 1e9,
                    help="peak HBM GB/s (H100 SXM: 3350)")
    ap.add_argument("--int8-head", action="store_true",
                    help="analyze the opt-in int8-head path instead of the "
                         "production bf16+folded-BN config")
    ap.add_argument("--no-fold-bn", action="store_true")
    _timing.add_device_arg(ap)
    args = ap.parse_args(argv)
    print(json.dumps(roofline(args.batch, args.iters, args.peak_tflops,
                              args.peak_gbps, args.int8_head,
                              not args.no_fold_bn, args.device), indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
