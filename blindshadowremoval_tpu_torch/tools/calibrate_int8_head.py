"""Calibrate the int8 head's static activation scale on data (counterpart
of `tools/calibrate_int8_head.py`).

The int8 output head quantizes its input against a bound; a dynamic
per-sample max costs an extra pass over the activations, a static bound
does not (ops/quant.py).  This tool:

  1. restores a generator, either a port checkpoint directory
     (`utils/checkpoint.py`, as the CLI's `--ckpt`) or a TF checkpoint
     prefix (`<dir>/ckpt-N` with its `.index` and `.data`,
     `models/tf_checkpoint.py`; layers the bundle lacks keep the seed-0
     Glorot draw, and the count of each is printed), runs the UCB images
     through it in f32 with live BatchNorm, and captures the head's input
     activations (the `up3` block's output, by a forward hook);
  2. reports the observed abs-max per image and a suggested bound (1.25x
     the max), beside the per-channel bounds `ops/calibration.py` derives
     from the checkpoint's own BatchNorm statistics (the bounds serving
     uses) and how many channels' observed maxima those cover;
  3. measures the quality cost on the captured activations: the head's
     output in f32 against int8 with the dynamic max and with the static
     bound (PSNR against the f32 output's range).

`--data` (a glob of UCB input folders) is required: the JAX tool reads
the reference's UCB images.  Its figures are a quality result only on a
trained checkpoint and real images.  `--cpu` is `--device cpu` (the JAX
tool's default is its CPU backend; the port's, as every entry point's,
is the card).

    python -m blindshadowremoval_tpu_torch.tools.calibrate_int8_head \
        --ckpt CKPT --data 'ucb/input/*' [--images 8] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile

import numpy as np
import torch

from blindshadowremoval_tpu_torch.config import get_config, resolve_device
from blindshadowremoval_tpu_torch.tools import _timing

SIZE = 256
N_RES = 6


def restore_generator(ckpt: str, cfg) -> dict:
    """The unfolded generator state dict of `cfg`'s variant from a port
    checkpoint directory or a TF checkpoint prefix (module docstring)."""
    from blindshadowremoval_tpu_torch.models.tf_checkpoint import (
        VAL_SUFFIX,
        list_variables,
        load_tf_checkpoint,
    )
    from blindshadowremoval_tpu_torch.models.weights import generator_mapping
    from blindshadowremoval_tpu_torch.train.trainer import init_generator_vars

    if not os.path.isfile(ckpt + ".index"):
        from blindshadowremoval_tpu_torch.cli import _restore

        return _restore(dataclasses.replace(cfg, checkpoint_dir=ckpt))[0]
    held = {name for name, _ in list_variables(ckpt)}
    mapping = [e for e in generator_mapping(cfg.variant, cfg.n_res)
               if e[1] + VAL_SUFFIX in held]
    if not mapping:
        raise ValueError(f"{ckpt!r} holds no generator tensor")
    _, sd = init_generator_vars(dataclasses.replace(
        cfg, fold_bn=False, egress_dtype="float32"))
    loaded = load_tf_checkpoint(ckpt, mapping)
    print(f"TF checkpoint {ckpt}: {len(loaded)} of the generator's "
          f"{len(sd)} tensors read, the rest the seed-0 draw")
    return {**sd, **loaded}


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    """The JAX tool's PSNR: against the f32 output's own range."""
    mse = float(np.mean((a - b) ** 2))
    rng = float(np.abs(a).max()) or 1.0
    return 10 * np.log10(rng * rng / mse) if mse else 99.0


def calibrate(ckpt: str, data: str, images: int = 8, device=None) -> dict:
    """The JAX tool's lines, printed; returns {"absmax": [per image],
    "observed_max", "suggested_bound", "checkpoint_bounds" (per channel,
    ops/calibration.py), "channels_covered", "channels", "psnr_dynamic_db",
    "psnr_static_db", "device"}."""
    from blindshadowremoval_tpu_torch.data.dataset import Dataset
    from blindshadowremoval_tpu_torch.models import build_generator
    from blindshadowremoval_tpu_torch.models.generator import f32_convs
    from blindshadowremoval_tpu_torch.ops.calibration import head_input_bounds
    from blindshadowremoval_tpu_torch.ops.quant import float_conv, int8_conv

    dev = resolve_device(device)
    with tempfile.TemporaryDirectory(prefix="calibrate_") as work:
        cfg = get_config("ucb", img_size=SIZE, n_res=N_RES,
                         data_dirs_test=(data,), eval_views=1,
                         compute_dtype="float32", checkpoint_dir=work)
        sd = restore_generator(ckpt, cfg)
        # the live-BatchNorm f32-egress generator
        gen = build_generator(dataclasses.replace(
            cfg, fold_bn=False, egress_dtype="float32"), sd, dev)
        captured = []
        hook = gen.up3.register_forward_hook(
            lambda mod, inp, out: captured.append(out.detach().float()))
        acts, maxes = [], []
        try:
            for _, (batch, _, name) in zip(range(images),
                                           Dataset(cfg, "test")):
                with torch.inference_mode():
                    gen(*(torch.from_numpy(np.ascontiguousarray(batch[k]))
                          .to(dev) for k in ("img", "uv", "reg")))
                y = captured.pop()
                acts.append(y)
                maxes.append(float(y.abs().max()))
                print(f"{os.path.basename(name)}: head-input absmax "
                      f"{maxes[-1]:.3f}")
        finally:
            hook.remove()
    if not acts:
        raise ValueError(f"{data!r} holds no UCB image")
    bound = 1.25 * max(maxes)
    print(f"\nobserved max {max(maxes):.3f}, suggested static bound "
          f"{bound:.3f}")
    bounds = head_input_bounds(sd)
    per_channel = torch.stack([a.abs().amax(dim=(0, 2, 3)) for a in acts]
                              ).amax(dim=0).cpu().numpy()
    covered = int(np.sum(per_channel <= np.asarray(bounds)))
    print(f"checkpoint bounds (ops/calibration.py, per channel): "
          f"{min(bounds):.3f}-{max(bounds):.3f}, covering the observed max "
          f"of {covered}/{len(bounds)} channels")

    w, b = gen.head.conv.weight.detach().float(), gen.head.conv.bias.detach()
    outs = {"f32": [], "dynamic": [], "static": []}
    with torch.inference_mode(), f32_convs(torch.float32):   # TF32 off
        for y in acts:
            outs["f32"].append(float_conv(y, w, b).cpu().numpy())
            outs["dynamic"].append(int8_conv(y, w, b).cpu().numpy())
            outs["static"].append(int8_conv(y, w, b, 1, float(bound))
                                  .cpu().numpy())
    f32a, dyna, stata = (np.concatenate(outs[k]) for k in outs)
    p_dyn, p_stat = psnr(f32a, dyna), psnr(f32a, stata)
    print(f"head output parity vs f32: dynamic {p_dyn:.1f} dB, "
          f"static({bound:.2f}) {p_stat:.1f} dB")
    print(f"\nset: get_config(..., int8_head=True, "
          f"int8_head_scale={bound:.3f})")
    return {"absmax": maxes, "observed_max": max(maxes),
            "suggested_bound": bound, "checkpoint_bounds": list(bounds),
            "channels_covered": covered, "channels": len(bounds),
            "psnr_dynamic_db": p_dyn, "psnr_static_db": p_stat,
            "device": _timing.device_label(dev)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m blindshadowremoval_tpu_torch.tools.calibrate_int8_head",
        description="The int8 head's static bound from captured "
                    "activations, and its quality cost")
    ap.add_argument("--ckpt", default="runs/demo_gsc",
                    help="a port checkpoint directory or a TF checkpoint "
                         "prefix (ckpt-N)")
    ap.add_argument("--images", type=int, default=8)
    ap.add_argument("--data", required=True,
                    help="glob of the UCB input folders")
    ap.add_argument("--cpu", action="store_true",
                    help="the same as --device cpu")
    _timing.add_device_arg(ap)
    args = ap.parse_args(argv)
    print(json.dumps(calibrate(args.ckpt, args.data, args.images,
                               "cpu" if args.cpu else args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
