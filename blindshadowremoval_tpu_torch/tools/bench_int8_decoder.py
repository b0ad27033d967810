"""Micro-bench: does static-scale int8 pay for the decoder's transposed
conv and the encoder's first conv (counterpart of
`tools/bench_int8_decoder.py`)?

Segments (the 256^2 generator's shapes, batch `--batch`):
  * up3 tail: ConvT 3x3 128->64 s2 (128^2 -> 256^2) + affine + leaky +
    the 7x7 64->2 head with the int8 static head in both, the ConvT in
    bf16 against int8 static;
  * encoder conv1: 7x7 3->32 s2 at 256^2, bf16 against int8 static.

The int8 products are `ops/quant.py`'s (`torch._int_mm` a tap, int32
accumulators): `int8_conv` for the head and conv1, and for the ConvT its
phase-packed form (`ops/packed.py:convt_packed_kernel`, a 2x2 conv to the
four output phases) on int8 codes, weights scaled per packed output
channel.  Each segment is timed by `_timing.timed_fn` (bench's harness).
The text lines, then one JSON line.

    python -m blindshadowremoval_tpu_torch.tools.bench_int8_decoder \
        [--batch 128] [--iters 40] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.nn.functional as F

from blindshadowremoval_tpu_torch.config import resolve_device
from blindshadowremoval_tpu_torch.tools import _timing

H, CIN, CMID = 128, 128, 64
XS = 8.0      # static activation bounds for the bench inputs
HS = 8.0
SLOPE = 0.3   # models/blocks.py's LeakyReLU


def bench_decoder(batch: int = 128, iters: int = 40, device=None) -> dict:
    """The JAX tool's lines, printed; returns {"tail_rel_err",
    "us_per_face": {segment: us}, "device"}."""
    from blindshadowremoval_tpu_torch.ops import packed as pk
    from blindshadowremoval_tpu_torch.ops.quant import (
        int8_accumulate,
        int8_conv,
        pad_same,
        quantize_weight,
    )

    dev = resolve_device(device)
    rng = np.random.default_rng(0)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    x = t(rng.normal(size=(batch, CIN, H, H)))
    wt = t(rng.normal(size=(CIN, CMID, 3, 3)) * 0.05)
    bt = t(rng.normal(size=(CMID,)) * 0.1)
    scale = t(rng.uniform(0.5, 1.5, CMID))
    shift = t(rng.normal(size=(CMID,)) * 0.1)
    wh = t(rng.normal(size=(2, CMID, 7, 7)) * 0.05)
    bh = t(rng.normal(size=(2,)) * 0.1)
    img = t(rng.uniform(size=(batch, 3, 2 * H, 2 * H)))
    w1 = t(rng.normal(size=(32, 3, 7, 7)) * 0.05)
    b1 = t(rng.normal(size=(32,)) * 0.1)

    wt_q, wt_s = quantize_weight(pk.convt_packed_kernel(wt))
    bt_p = pk.tile_phase(bt)[None, :, None, None]

    def col(v, dtype):
        return v.to(dtype)[None, :, None, None]

    def tail(v, convt_int8):
        if convt_int8:
            xs = XS / 127.0
            xq = torch.clamp(torch.round(v / xs), -127, 127).to(torch.int8)
            # convt_packed's (1, 0, 1, 0) padding; int8_accumulate adds
            # (0, 1, 0, 1) for its 2x2 "SAME", whose last row and column go
            acc = int8_accumulate(F.pad(xq, (1, 0, 1, 0)), wt_q)
            acc = acc[..., :v.shape[-2], :v.shape[-1]]
            y = acc.float() * (xs * wt_s)[None, :, None, None] + bt_p
            y = pk.unpack_image(y, CMID).to(torch.bfloat16)
        else:
            y = F.conv_transpose2d(v.to(torch.bfloat16),
                                   wt.to(torch.bfloat16), stride=2)
            y = y[..., :2 * v.shape[-2], :2 * v.shape[-1]]
            y = y + col(bt, torch.bfloat16)
        y = y * col(scale, y.dtype) + col(shift, y.dtype)
        y = F.leaky_relu(y, SLOPE)
        return int8_conv(y, wh, bh, 1, HS).float()

    def enc(v, use_int8):
        if use_int8:
            return int8_conv(v, w1, b1, 2, 1.0).float()   # inputs in [0, 1]
        out = F.conv2d(pad_same(v.to(torch.bfloat16), 7, 2),
                       w1.to(torch.bfloat16), stride=2)
        return (out + col(b1, torch.bfloat16)).float()

    with torch.inference_mode():
        ref = tail(x[:2], False)
        got = tail(x[:2], True)
        rel = float((ref - got).abs().max() / (ref.abs().max() + 1e-6))
        print(f"tail int8-vs-bf16 rel err: {rel:.3f} (quantization-scale "
              "noise)")
        times = {}
        for name, fn, inp in (
                ("up3 bf16 + int8s head", lambda v: tail(v, False), x),
                ("up3 int8s + int8s head", lambda v: tail(v, True), x),
                ("conv1 bf16", lambda v: enc(v, False), img),
                ("conv1 int8s", lambda v: enc(v, True), img)):
            best = _timing.timed_fn(lambda v, fn=fn: fn(v).mean(), inp,
                                    iters=iters)
            times[name] = best / iters / batch * 1e6
            print(f"{name:32s} {times[name]:8.2f} us/face")
    return {"tail_rel_err": rel, "us_per_face": times,
            "device": _timing.device_label(dev)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m blindshadowremoval_tpu_torch.tools.bench_int8_decoder",
        description="bf16 against int8 static-scale for the decoder's "
                    "transposed conv and the encoder's first conv")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--iters", type=int, default=40)
    _timing.add_device_arg(ap)
    args = ap.parse_args(argv)
    print(json.dumps(bench_decoder(args.batch, args.iters, args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
