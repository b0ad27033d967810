"""Micro-bench of the generator's 256^2 tail: ConvT(up3) + affine + leaky
+ 7x7 head, direct against phase-packed (`ops/packed.py`), bf16 and the
int8 static-scale head (counterpart of `tools/bench_packed_tail.py`).

The packed form computes the whole segment at 128^2 with 4x the channels:
the ConvT's four output phases stay channel groups (its natural product)
and the 7x7x64->2 head becomes a 5x5x256->8 conv, so no 256^2 tensor is
made.  The s2d head is `models/blocks.py:space_to_depth_conv`.  The int8
heads accumulate by `ops/quant.py`'s `torch._int_mm` taps (the direct one
through `int8_conv`, the packed one through `int8_accumulate` on the
packed kernel).

`--grad` times the backward through the same segment instead (the loss's
gradient with respect to both kernels and the segment input, as a train
step needs it), direct, s2d head and packed; the packed kernels are formed
inside the step, as a train step would form them.

Each form is timed by `_timing.timed_fn` (bench's harness); f32 forms are
first held to agree (forward 1e-3, the loss 1e-5 and the head kernel's
gradient 1e-4, the JAX tool's bars).  Inputs are seeded draws in the JAX
tool's shapes.  The text lines, then one JSON line.

    python -m blindshadowremoval_tpu_torch.tools.bench_packed_tail \
        [--batch 128] [--iters 40] [--grad] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.nn.functional as F

from blindshadowremoval_tpu_torch.config import resolve_device
from blindshadowremoval_tpu_torch.models.generator import f32_convs
from blindshadowremoval_tpu_torch.tools import _timing

H, CIN, CMID = 128, 128, 64
SCALE = 8.0          # the static int8 activation bound of the bench
SLOPE = 0.3          # models/blocks.py's LeakyReLU


def segment_operands(batch: int, device):
    """Seeded x [B, CIN, H, H] and the segment's parameters (torch
    layouts), f32 on `device`."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(batch, H, H, CIN)).astype(np.float32)
    p = {"wt": rng.normal(size=(CIN, CMID, 3, 3)) * 0.05,
         "bt": rng.normal(size=(CMID,)) * 0.1,
         "scale": rng.uniform(0.5, 1.5, CMID),
         "shift": rng.normal(size=(CMID,)) * 0.1,
         "wh": rng.normal(size=(2, CMID, 7, 7)) * 0.05,
         "bh": rng.normal(size=(2,)) * 0.1}
    p = {k: torch.from_numpy(np.asarray(v, np.float32)).to(device)
         for k, v in p.items()}
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().to(device), p


def _col(v, dtype):
    return v.to(dtype)[None, :, None, None]


def _upsample(x, wt, p, dtype):
    """ConvT(3x3, s2, SAME) + bias + affine + leaky at 256^2."""
    y = F.conv_transpose2d(x.to(dtype), wt.to(dtype), stride=2)
    y = y[..., :2 * x.shape[-2], :2 * x.shape[-1]] + _col(p["bt"], dtype)
    return F.leaky_relu(y * _col(p["scale"], dtype) + _col(p["shift"], dtype),
                        SLOPE)


def direct(x, p, dtype, int8=False, wt=None, wh=None):
    from blindshadowremoval_tpu_torch.ops.quant import int8_conv

    wt = p["wt"] if wt is None else wt
    wh = p["wh"] if wh is None else wh
    y = _upsample(x, wt, p, dtype)
    if int8:
        return int8_conv(y, wh, p["bh"], 1, SCALE).float()
    return (F.conv2d(y, wh.to(dtype), padding=3)
            + _col(p["bh"], dtype)).float()


def s2d_head(x, p, dtype, wt=None, wh=None):
    from blindshadowremoval_tpu_torch.models.blocks import space_to_depth_conv

    wt = p["wt"] if wt is None else wt
    wh = p["wh"] if wh is None else wh
    y = _upsample(x, wt, p, dtype)
    return space_to_depth_conv(y, wh, p["bh"], dtype).float()


def packed(x, p, dtype, int8=False, wt=None, wh=None):
    from blindshadowremoval_tpu_torch.ops import packed as pk
    from blindshadowremoval_tpu_torch.ops.quant import int8_accumulate

    wt_p = pk.convt_packed_kernel(p["wt"] if wt is None else wt)
    wh_p = pk.conv_same_packed_kernel(p["wh"] if wh is None else wh)
    tile = {k: _col(pk.tile_phase(p[k]), dtype)
            for k in ("bt", "scale", "shift")}
    y = pk.convt_packed(x.to(dtype), wt_p) + tile["bt"]
    y = F.leaky_relu(y * tile["scale"] + tile["shift"], SLOPE)
    bh_p = _col(pk.tile_phase(p["bh"]), torch.float32)
    if int8:
        xs = SCALE / 127.0
        yq = torch.clamp(torch.round(y.float() / xs), -127, 127).to(
            torch.int8)
        ws = wh_p.abs().amax(dim=(1, 2, 3)) / 127.0 + 1e-12
        wq = torch.clamp(torch.round(wh_p / ws[:, None, None, None]), -127,
                         127).to(torch.int8)
        out = (int8_accumulate(yq, wq).float() * (xs * ws)[None, :, None, None]
               + bh_p)
    else:
        out = pk.conv_same_packed(y, wh_p).float() + bh_p
    return pk.unpack_image(out, 2)


def us_per_face(fn, x, iters: int) -> float:
    """Microseconds a face of `fn` (a 0-d result), by bench's harness."""
    return _timing.timed_fn(fn, x, iters=iters) / iters / x.shape[0] * 1e6


def bench_tail(batch: int = 128, iters: int = 40, grad: bool = False,
               device=None) -> dict:
    """The JAX tool's lines, printed; returns {"grad", "batch",
    "us_per_face": {form: us}, "max_err": {...}, "device"}."""
    dev = resolve_device(device)
    x, p = segment_operands(batch, dev)
    bf16 = torch.bfloat16
    errs, times = {}, {}
    if not grad:
        with torch.inference_mode():
            with f32_convs(torch.float32):     # true f32: TF32 off
                err = (direct(x[:2], p, torch.float32)
                       - packed(x[:2], p, torch.float32)).abs().max().item()
            print(f"packed-vs-direct f32 max err: {err:.2e}")
            if not err < 1e-3:
                raise RuntimeError(f"packed tail disagrees: {err}")
            errs["packed"] = err
            forms = {"direct bf16": lambda v: direct(v, p, bf16),
                     "direct bf16+int8head": lambda v: direct(v, p, bf16,
                                                              True),
                     "s2d-head bf16": lambda v: s2d_head(v, p, bf16),
                     "packed bf16": lambda v: packed(v, p, bf16),
                     "packed bf16+int8head": lambda v: packed(v, p, bf16,
                                                              True)}
            for name, fn in forms.items():
                times[name] = us_per_face(lambda v, fn=fn: fn(v).mean(), x,
                                          iters)
                print(f"{name:24s} {times[name]:8.2f} us/face")
    else:
        segs = {"direct": direct, "s2d": s2d_head, "packed": packed}

        def value_and_grad(seg, v, dtype):
            wt = p["wt"].detach().requires_grad_()
            wh = p["wh"].detach().requires_grad_()
            v = v.detach().requires_grad_()
            out = seg(v, p, dtype, wt=wt, wh=wh)
            loss = (out * out).mean()
            _, g_wh, g_x = torch.autograd.grad(loss, (wt, wh, v))
            return loss.detach(), g_wh, g_x

        with f32_convs(torch.float32):         # true f32: TF32 off
            v0, g0, _ = value_and_grad(direct, x[:2], torch.float32)
            rest = {nm: value_and_grad(segs[nm], x[:2], torch.float32)
                    for nm in ("s2d", "packed")}
        for nm, (v1, g1, _) in rest.items():
            dv = abs(float(v0 - v1))
            dg = float((g0 - g1).abs().max())
            print(f"{nm} grad-vs-direct: dloss {dv:.2e}, dgrad(wh) {dg:.2e}")
            if not (dv < 1e-5 and dg < 1e-4):
                raise RuntimeError(f"{nm} gradients disagree: {dv}, {dg}")
            errs[nm] = {"dloss": dv, "dgrad_wh": dg}

        for nm, label in (("direct", "direct bf16"),
                          ("s2d", "s2d-head bf16"),
                          ("packed", "packed bf16")):
            def step(v, seg=segs[nm]):
                loss, g_wh, g_x = value_and_grad(seg, v, bf16)
                return (loss.float() + g_wh.float().mean()
                        + g_x.float().mean() * 1e-3)

            times[label] = us_per_face(step, x, iters)
            print(f"{label:24s} {times[label]:8.2f} us/face (fwd+bwd)")
    return {"grad": grad, "batch": batch, "us_per_face": times,
            "max_err": errs, "device": _timing.device_label(dev)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m blindshadowremoval_tpu_torch.tools.bench_packed_tail",
        description="The decoder tail direct, s2d-head and phase-packed")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--grad", action="store_true",
                    help="bench the backward (gradients with respect to "
                         "both kernels and the input) instead of the "
                         "forward")
    _timing.add_device_arg(ap)
    args = ap.parse_args(argv)
    print(json.dumps(bench_tail(args.batch, args.iters, args.grad,
                                args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
