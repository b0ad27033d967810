"""Headline benchmark: GSC generator inference throughput on one card
(counterpart of the repository root's `bench.py`).

Prints one JSON line:
  {"metric": "faces_per_sec_per_chip", "value": N, "unit": "faces/s",
   "vs_baseline": N / 500, "device": "<nvidia-smi name, power.limit>"}

The 500 faces/s baseline is bench.py's (BASELINE.md's north star for the
JAX package; no figure measured on a TPU is a target here).  The model is
bench.py's production serving configuration: the GSCGenerator at 256x256,
batch 128, bf16 compute, BatchNorm folded into the convolutions, bf16
egress; it launches K1 six times a forward at (128, 1024, 128).  Weights
are Glorot-uniform from seed 0 (`models/build_generator`), or the caller's
state dict.

Measurement (`_timing.timed_fn`): ITERS forwards chained, the input
perturbed on the device at every call and per trial, the scalar
mean(rgb) + mean(dif) summed on the device and fetched once a trial, CUDA
events around the chain after one warm-up chain; the result must change
between trials.  The best of 3 trials.  Below B=16 the calls are queued
behind a spin kernel (`_timing.QUEUED_BELOW`).

    python -m blindshadowremoval_tpu_torch.tools.bench [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from blindshadowremoval_tpu_torch.config import get_config, resolve_device
from blindshadowremoval_tpu_torch.models import build_generator
from blindshadowremoval_tpu_torch.ops.calibration import calibrate_config
from blindshadowremoval_tpu_torch.tools import _timing

BASELINE_FACES_PER_SEC = 500.0
BATCH = 128
ITERS = _timing.ITERS
SIZE = 256
N_RES = 6


def make_gen(int8_head: bool = False, fold_bn: bool = True,
             state_dict: dict | None = None, device=None) -> torch.nn.Module:
    """bench.py's `make_gen` generator (bf16 compute, folded BN, bf16
    egress; `int8_head` the throughput-first opt-in head) on `device`
    (CUDA unless "cpu"), from the unfolded `state_dict` (Glorot-uniform
    from seed 0 without one); the int8 bounds calibrated from it before
    folding (ops/calibration.py), as serving does."""
    cfg = get_config(img_size=SIZE, n_res=N_RES, compute_dtype="bfloat16",
                     int8_head=int8_head, fold_bn=fold_bn,
                     egress_dtype="bfloat16")
    if state_dict is None:
        from blindshadowremoval_tpu_torch.train.trainer import (
            init_generator_vars,
        )

        state_dict = init_generator_vars(cfg)[1]
    return build_generator(calibrate_config(cfg, state_dict), state_dict,
                           device)


def make_inputs(batch: int = BATCH, size: int = SIZE, seed: int = 0,
                device="cpu"):
    """bench.py's seeded numpy draws (`bench.py:68-76`): img and uv
    uniform in [0, 1), reg uniform in [-0.02, 0.02), f32, NHWC."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(size=(batch, size, size, 3)).astype(np.float32)
    uv = rng.uniform(size=(batch, size, size, 3)).astype(np.float32)
    reg = rng.uniform(-0.02, 0.02, size=(batch, size, size, 6)).astype(
        np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (img, uv, reg))


def step_outputs(model, img, uv, reg):
    """(rgb, dif) of one forward: what the timed step reduces."""
    _, rgb, _, dif = model(img, uv, reg)
    return rgb, dif


def step(model):
    """bench.py's step: mean(rgb) + mean(dif) in f32, a 0-d tensor."""
    def run(img, uv, reg):
        rgb, dif = step_outputs(model, img, uv, reg)
        return rgb.float().mean() + dif.float().mean()
    return run


def timed_forward(model, img, uv, reg, iters: int = ITERS,
                  trials: int = 3) -> float:
    """Best seconds of `iters` chained forwards (module docstring)."""
    with torch.inference_mode():
        return _timing.timed_fn(step(model), img, uv, reg, iters=iters,
                                trials=trials)


def run(batch: int = BATCH, iters: int = ITERS, device=None) -> dict:
    """bench.py's measurement on `device` (CUDA unless "cpu"); its line."""
    dev = resolve_device(device)
    model = make_gen(device=dev)
    img, uv, reg = make_inputs(batch, SIZE, 0, dev)
    faces = batch * iters / timed_forward(model, img, uv, reg, iters=iters)
    return {"metric": "faces_per_sec_per_chip", "value": round(faces, 2),
            "unit": "faces/s",
            "vs_baseline": round(faces / BASELINE_FACES_PER_SEC, 3),
            "device": _timing.device_label(dev)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m blindshadowremoval_tpu_torch.tools.bench",
        description="GSC generator inference throughput (faces/s) in "
                    "bench.py's serving configuration: 256 px, batch 128, "
                    "bf16, folded BN, bf16 egress")
    _timing.add_device_arg(ap)
    args = ap.parse_args(argv)
    print(json.dumps(run(BATCH, ITERS, device=args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
