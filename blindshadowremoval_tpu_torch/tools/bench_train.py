"""Training-step throughput on one card (counterpart of
`tools/bench_train.py`).

Times the fused G+D train step (`Trainer.train_step`: augmentation on the
device, the generator, 3 discriminators and the VGG-19 forward, the full
loss stack, both Adam updates) at 256x256 across batch sizes: a batch of
B pairs is 2*B views, and K1 and K2 run at (2*B, 1024, 128), six times a
step each.  The batch is bench_train.py's seeded draws, on the card
before timing.  One step is counted (`_timing.count_work`: FLOPs by
FlopCounterMode, K1 and K2 by their ops' formulas), one more warms up,
then `--steps` steps run between CUDA events with each step's recon_c
loss kept on the device and fetched once after them; every loss must be
finite and differ from the step's before it (the warm-up's for the
first): a step that left its state as it was would repeat its loss.
"mfu_pct_vs_bf16_peak" sets the counted FLOPs against the H100's
989 TFLOP/s.

`--no-donate` and `--compiler-options` of the JAX tool are XLA-only (the
train step's state is updated in place here, and nothing is compiled) and
are not taken.  `--s2d` is `Config.s2d_convs`, `--remat` `Config.remat`.

    python -m blindshadowremoval_tpu_torch.tools.bench_train \
        [--batches 1,8,32] [--steps 20] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import math

import numpy as np
import torch

from blindshadowremoval_tpu_torch.config import get_config, resolve_device
from blindshadowremoval_tpu_torch.tools import _timing

SIZE = 256
N_RES = 6


def train_batch(batch_size: int, size: int, device, seed: int = 0) -> dict:
    """bench_train.py's seeded batch of 2*batch_size views (uniform images,
    mask and UV, reg in [-0.02, 0.02), a binary face map), f32 on
    `device`."""
    rng = np.random.default_rng(seed)
    b2 = batch_size * 2
    batch = {
        "img_dark": rng.uniform(size=(b2, size, size, 3)),
        "gt": rng.uniform(size=(b2, size, size, 3)),
        "mask": rng.uniform(size=(b2, size, size, 1)),
        "uv": rng.uniform(size=(b2, size, size, 3)),
        "reg": rng.uniform(-0.02, 0.02, size=(b2, size, size, 6)),
        "face": (rng.uniform(size=(b2, size, size, 1)) > 0.4),
    }
    return {k: torch.from_numpy(v.astype(np.float32)).to(device)
            for k, v in batch.items()}


def trainer_for(batch_size: int, compute_dtype: str, vgg_dtype: str,
                remat: bool, s2d: bool, device):
    """(Trainer, its state from seed 0) at SIZE px."""
    from blindshadowremoval_tpu_torch.train.trainer import Trainer

    cfg = get_config("train", img_size=SIZE, n_res=N_RES,
                     batch_size=batch_size, compute_dtype=compute_dtype,
                     vgg_dtype=vgg_dtype, remat=remat, s2d_convs=s2d)
    trainer = Trainer(cfg, device=device)
    return trainer, trainer.init_state(seed=0)


def check_losses(losses: list) -> None:
    """Raises StaleResultError unless every loss is finite and differs
    from the one before it."""
    if not all(map(math.isfinite, losses)) or any(
            a == b for a, b in zip(losses, losses[1:])):
        raise _timing.StaleResultError(
            f"train losses {losses}: one not finite, or one repeating the "
            "step's before it (a step that left its state as it was)")


def bench_config(batch_size: int, steps: int, compute_dtype: str,
                 vgg_dtype: str, remat: bool = False, s2d: bool = False,
                 device=None) -> dict:
    """bench_train.py's record of one configuration (its keys, and
    "device")."""
    dev = resolve_device(device)
    trainer, state = trainer_for(batch_size, compute_dtype, vgg_dtype, remat,
                                 s2d, dev)
    batch = train_batch(batch_size, SIZE, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    with _timing.count_work() as work:
        state, _, _ = trainer.train_step(state, batch, gen)
    state, losses, _ = trainer.train_step(state, batch, gen)
    warm = losses["recon_c"].float()

    def run():
        nonlocal state
        seen = [warm]
        for _ in range(steps):
            state, step_losses, _ = trainer.train_step(state, batch, gen)
            seen.append(step_losses["recon_c"].float())
        return torch.stack(seen)

    seconds, seen = _timing.device_span(run, dev)
    check_losses(seen.tolist())
    step_time = seconds / steps
    b2 = 2 * batch_size
    out = {
        "batch_size": batch_size,
        "views_per_step": b2,
        "compute_dtype": compute_dtype,
        "vgg_dtype": vgg_dtype,
        "remat": remat,
        "s2d": s2d,
        "step_time_ms": round(step_time * 1e3, 2),
        "steps_per_sec": round(1.0 / step_time, 2),
        "views_per_sec": round(b2 / step_time, 1),
        "step_tflops": round(work.flops / 1e12, 3),
        "mfu_pct_vs_bf16_peak": round(
            100.0 * work.flops / step_time / _timing.PEAK_BF16_FLOPS, 1),
        "attention_calls_per_step": {
            k: sum(c[3] == k for c in work.attention_calls)
            for k in ("fwd", "bwd")},
        "device": _timing.device_label(dev),
    }
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m blindshadowremoval_tpu_torch.tools.bench_train",
        description="Train-step throughput at 256 px across batch sizes. "
                    "The JAX tool's --no-donate and --compiler-options are "
                    "XLA-only and not taken.")
    ap.add_argument("--batches", default="1,8,32")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--compute-dtype", default="bfloat16")
    ap.add_argument("--vgg-dtype", default="float32")
    ap.add_argument("--remat", action="store_true",
                    help="recompute the bottleneck blocks in the backward "
                         "pass (Config.remat)")
    ap.add_argument("--s2d", action="store_true",
                    help="space-to-depth form of the 7x7 convs (conv1 and "
                         "the head; Config.s2d_convs), numerically the same")
    _timing.add_device_arg(ap)
    args = ap.parse_args(argv)
    for b in [int(x) for x in args.batches.split(",")]:
        print(json.dumps(bench_config(b, args.steps, args.compute_dtype,
                                      args.vgg_dtype, remat=args.remat,
                                      s2d=args.s2d, device=args.device)),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
