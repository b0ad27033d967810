"""Throughput of the landmark stack, S3FD detection and 2D-FAN alignment
(counterpart of `tools/bench_landmarks.py`).

  * FAN forward + heatmap decode (every detected face pays one 256x256
    FAN pass), batched, in `--dtype`: faces/s.
  * The S3FD trunk forward (the per-image cost) at a square input size:
    images/s.  The host decode and NMS run per image on the CPU and are
    timed apart on synthetic outputs (they overlap device work in a
    pipeline, so the device figure is the ceiling).

Both device figures come from `_timing.timed_fn` (bench's harness).  A
FAN-4 forward holds more launches than the device's queue of pending
launches, so below the harness's QUEUED_BELOW (16) its calls cannot be
queued and the FAN figure raises HostSyncError on the card: give it
`--batch 16` or more there.
Weights are seeded (`models/weights.py:synthetic_fan_weights`,
`synthetic_sfd_weights`): the throughput is set by the shapes, and the
published checkpoints are external downloads.  The text lines, then one
JSON line.

    python -m blindshadowremoval_tpu_torch.tools.bench_landmarks \
        [--batch 32] [--det-size 640] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from blindshadowremoval_tpu_torch.config import resolve_device
from blindshadowremoval_tpu_torch.tools import _timing

FAN_MODULES = 4
FAN_SIZE = 256       # models/fan.py's input


def bench_fan(batch: int, iters: int, dtype: torch.dtype, device) -> float:
    """FAN forward + decode, faces/s."""
    from blindshadowremoval_tpu_torch.models.fan import (
        build_fan,
        decode_heatmaps,
    )
    from blindshadowremoval_tpu_torch.models.weights import (
        fan_from_jax,
        synthetic_fan_weights,
    )

    dev = resolve_device(device)
    net = build_fan(fan_from_jax(synthetic_fan_weights(
        0, num_modules=FAN_MODULES)), FAN_MODULES, dtype, dev)
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.uniform(
        size=(batch, FAN_SIZE, FAN_SIZE, 3)).astype(np.float32)).to(dev)

    def step(i):
        hm = net(i.permute(0, 3, 1, 2))[-1]
        pts = decode_heatmaps(hm)                                # [B, 68, 2]
        # the argmax decode does not move under the harness's 1e-5
        # perturbation, so the points alone would read as a stale result
        return pts.float().mean().double() + hm.float().mean().double()

    with torch.inference_mode():
        best = _timing.timed_fn(step, img, iters=iters)
    return batch * iters / best


def bench_sfd(batch: int, size: int, iters: int, dtype: torch.dtype,
              device) -> float:
    """The S3FD trunk and heads, images/s."""
    from blindshadowremoval_tpu_torch.models.sfd import build_s3fd
    from blindshadowremoval_tpu_torch.models.weights import (
        sfd_from_jax,
        synthetic_sfd_weights,
    )

    dev = resolve_device(device)
    net = build_s3fd(sfd_from_jax(synthetic_sfd_weights(0)), dtype, dev)
    rng = np.random.default_rng(1)
    img = torch.from_numpy(rng.uniform(
        -120, 130, size=(batch, size, size, 3)).astype(np.float32)).to(dev)

    def step(i):
        outs = net(i.permute(0, 3, 1, 2))
        return sum(c.float().mean() + loc.float().mean() for c, loc in outs)

    with torch.inference_mode():
        best = _timing.timed_fn(step, img, iters=iters)
    return batch * iters / best


def time_host_decode(size: int, n: int = 20) -> float:
    """Seconds an image of the host decode + NMS on synthetic outputs: a
    near-zero face probability with a few dozen peaks (a multi-face
    frame), as the JAX tool draws them; uniform noise would put half the
    anchors above the threshold, which no real image does."""
    from blindshadowremoval_tpu_torch.models.sfd import decode_detections, nms

    rng = np.random.default_rng(2)
    outs = []
    for k in range(6):
        s = size // (4 * 2 ** k)
        face = rng.uniform(0.0, 0.02, size=(1, s, s)).astype(np.float32)
        n_peaks = max(1, 32 >> k)
        ph = rng.integers(0, s, n_peaks)
        pw = rng.integers(0, s, n_peaks)
        face[0, ph, pw] = rng.uniform(0.3, 1.0, n_peaks)
        conf = np.stack([1.0 - face, face], axis=1)          # [1, 2, s, s]
        loc = rng.uniform(-1, 1, size=(1, 4, s, s)).astype(np.float32)
        outs.append((conf, loc))
    t0 = time.perf_counter()
    for _ in range(n):
        dets = decode_detections(outs)
        if len(dets):
            nms(dets)
    return (time.perf_counter() - t0) / n


def bench_landmarks(batch: int = 32, det_batch: int = 8, det_size: int = 640,
                    iters: int = 10, dtype: str = "bfloat16",
                    device=None) -> dict:
    """The JAX tool's three lines, printed; returns {"fan_faces_per_s",
    "sfd_images_per_s", "host_decode_ms", "device"}."""
    dev = resolve_device(device)
    dt = getattr(torch, dtype)
    faces_s = bench_fan(batch, iters, dt, dev)
    print(f"FAN align (batch {batch}, {FAN_SIZE}x{FAN_SIZE}, {dtype}): "
          f"{faces_s:.1f} faces/s")
    imgs_s = bench_sfd(det_batch, det_size, iters, dt, dev)
    print(f"S3FD detect trunk (batch {det_batch}, {det_size}x{det_size}, "
          f"{dtype}): {imgs_s:.1f} images/s")
    host_s = time_host_decode(det_size)
    print(f"S3FD host decode+NMS: {host_s * 1e3:.2f} ms/image "
          f"({1.0 / host_s:.0f} images/s ceiling on one core)")
    return {"fan_faces_per_s": faces_s, "sfd_images_per_s": imgs_s,
            "host_decode_ms": host_s * 1e3,
            "device": _timing.device_label(dev)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m blindshadowremoval_tpu_torch.tools.bench_landmarks",
        description="FAN and S3FD throughput, and the host decode + NMS")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--det-batch", type=int, default=8)
    ap.add_argument("--det-size", type=int, default=640)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    _timing.add_device_arg(ap)
    args = ap.parse_args(argv)
    print(json.dumps(bench_landmarks(args.batch, args.det_batch,
                                     args.det_size, args.iters, args.dtype,
                                     args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
