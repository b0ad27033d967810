"""`fit()`-path training throughput through the real host loader
(counterpart of `tools/bench_fit.py`).

`tools/bench_train.py` times the step alone on a batch already on the
card.  This tool times what `fit()`'s inner loop achieves when each
step's batch comes from the train iterator (`data/dataset.py`: a pool of
forkserver parse processes: decode, crop, shadow synthesis, geometry
primitives) and is uploaded, and splits the result so the bottleneck is
named:

  * loader-only : samples/s through the real iterator;
  * upload-only : the host-to-device copy of one assembled batch;
  * end-to-end  : `train/loop.py`'s assembly (`_next_batch`, or with
                  `--prefetch` its `_BatchPrefetcher`: pinned upload of
                  batch i+1 on a side stream behind step i) and
                  `Trainer.train_step`, over `--steps` steps, synchronized
                  by a final loss fetch.

The configuration is the JAX tool's: 256 px, remat, device geometry.
`--data` (a glob of identity folders of PNG frames with `.npy`
landmarks) is required: the JAX tool's default points into the reference
data, which this repository does not hold.  The text lines, then one JSON
line.

    python -m blindshadowremoval_tpu_torch.tools.bench_fit --data 'tree/*' \
        [--batch 32] [--steps 12] [--warm 3] [--prefetch] [--device cpu]
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import tempfile
import time

import numpy as np
import torch

from blindshadowremoval_tpu_torch.config import get_config, resolve_device
from blindshadowremoval_tpu_torch.tools import _timing

SIZE = 256
N_RES = 6


def bench_fit(data: str, batch: int = 32, steps: int = 12, warm: int = 3,
              loader_samples: int = 48, compute_dtype: str = "bfloat16",
              vgg_dtype: str = "bfloat16", compact: bool = False,
              device_darken: bool = False, u8: bool = False,
              prefetch: bool = False, sync_every: int = 0,
              device=None) -> dict:
    """The JAX tool's three measurements; prints its lines and returns
    {"loader_ms_per_sample", "loader_samples_per_sec", "upload_mb",
    "upload_s", "upload_mb_per_s", "fit_ms_per_step", "views_per_sec",
    "final_recon_c", "workers", "device"}."""
    from blindshadowremoval_tpu_torch.data.dataset import (
        Dataset,
        stop_parse_servers,
    )
    from blindshadowremoval_tpu_torch.train.loop import (
        _assemble,
        _BatchPrefetcher,
        _next_batch,
    )
    from blindshadowremoval_tpu_torch.train.trainer import Trainer

    dev = resolve_device(device)
    with tempfile.TemporaryDirectory(prefix="bench_fit_") as work:
        cfg = get_config(
            "train", img_size=SIZE, n_res=N_RES, batch_size=batch,
            compute_dtype=compute_dtype, vgg_dtype=vgg_dtype, remat=True,
            device_geometry=True, compact_ingress=compact,
            device_darken=device_darken, ingress_u8=u8, data_dirs=(data,),
            checkpoint_dir=work)
        ds = Dataset(cfg, "train", seed=0)
        workers = ds.workers
        print(f"corpus: {len(ds.name_list)} identities; loader workers: "
              f"{workers} processes on {os.cpu_count()} core(s)")
        feed = iter(ds)
        get_batch = None
        try:
            # ---- loader-only: samples/s through the real iterator
            for _ in range(2 * workers):     # the pool's first samples
                next(feed)
            t0 = time.perf_counter()
            for _ in range(loader_samples):
                next(feed)
            per_sample = (time.perf_counter() - t0) / loader_samples
            print(f"loader-only: {1e3 * per_sample:.1f} ms/sample "
                  f"({1.0 / per_sample:.1f} samples/s = "
                  f"{2.0 / per_sample:.1f} views/s; batch {batch} needs "
                  f"one batch per device step)")

            # ---- one assembled batch: its size and upload time
            up = _assemble(feed, batch, compact, u8)
            nbytes = sum(v.nbytes for v in up.values())
            host = {k: torch.from_numpy(np.ascontiguousarray(v))
                    for k, v in up.items()}
            warm_copy = {k: v.to(dev) for k, v in host.items()}
            del warm_copy                               # warmed the path
            _timing.synchronize(dev)
            t0 = time.perf_counter()
            staged = {k: v.to(dev) for k, v in host.items()}
            _timing.synchronize(dev)
            t_up = max(time.perf_counter() - t0, 1e-9)
            del staged
            print(f"upload-only: {nbytes / 1e6:.1f} MB/batch, {t_up:.2f} s "
                  f"({nbytes / t_up / 1e6:.1f} MB/s through this link)")

            # ---- end-to-end fit() inner loop
            trainer = Trainer(cfg, device=dev)
            state = trainer.init_state(seed=0)
            gen = torch.Generator(device=dev).manual_seed(1)
            print("warming the train step ...", flush=True)
            for _ in range(warm):
                b = _next_batch(feed, batch, compact, u8, device=dev)
                state, losses, _ = trainer.train_step(state, b, gen)
            print(f"warm recon_c={float(losses['recon_c']):.4f}", flush=True)
            if prefetch:
                get_batch = _BatchPrefetcher(feed, batch, compact, u8,
                                             device=dev)
                next(get_batch)    # let the buffer fill: step 1 overlaps
            t0 = time.perf_counter()
            for i in range(steps):
                b = (next(get_batch) if get_batch is not None else
                     _next_batch(feed, batch, compact, u8, device=dev))
                state, losses, _ = trainer.train_step(state, b, gen)
                if sync_every and i % sync_every == 0:
                    float(losses["recon_c"])          # the fit() log fetch
            final = float(losses["recon_c"])          # syncs the chain
            dt = time.perf_counter() - t0
        finally:
            if get_batch is not None:
                get_batch.close()
            feed.close()
            del feed, ds
            gc.collect()
            stop_parse_servers()
    views = 2 * batch
    step_s = dt / steps
    print(f"end-to-end fit() loop: {step_s * 1e3:.0f} ms/step at batch "
          f"{batch} ({views / step_s:.1f} views/s; final "
          f"recon_c={final:.4f})")
    print(f"decomposition per step: host parse {batch * per_sample:.2f} s | "
          f"upload {t_up:.2f} s | measured {step_s:.2f} s")
    return {"loader_ms_per_sample": 1e3 * per_sample,
            "loader_samples_per_sec": 1.0 / per_sample,
            "upload_mb": nbytes / 1e6, "upload_s": t_up,
            "upload_mb_per_s": nbytes / t_up / 1e6,
            "fit_ms_per_step": step_s * 1e3, "views_per_sec": views / step_s,
            "final_recon_c": final, "workers": workers,
            "device": _timing.device_label(dev)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m blindshadowremoval_tpu_torch.tools.bench_fit",
        description="fit()'s step rate through the real host loader, split "
                    "into loader, upload and end to end")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--warm", type=int, default=3)
    ap.add_argument("--loader-samples", type=int, default=48)
    ap.add_argument("--data", required=True,
                    help="glob of the training identity folders (PNG "
                         "frames and .npy landmarks)")
    ap.add_argument("--compute-dtype", default="bfloat16")
    ap.add_argument("--vgg-dtype", default="bfloat16")
    ap.add_argument("--compact", action="store_true",
                    help="uint16 fixed-point train ingress "
                         "(config.compact_ingress wire format)")
    ap.add_argument("--device-darken", action="store_true",
                    help="derive (gt, img_dark) on the device "
                         "(config.device_darken wire format)")
    ap.add_argument("--u8", action="store_true",
                    help="quantize the compact wire at 1/255 (uint8) "
                         "instead of 1/65535 (config.ingress_u8)")
    ap.add_argument("--prefetch", action="store_true",
                    help="double-buffer host parse + upload of batch i+1 "
                         "behind step i (fit()'s _BatchPrefetcher)")
    ap.add_argument("--sync-every", type=int, default=0,
                    help="fetch a loss scalar every N steps (fit() with "
                         "--log-every N does this)")
    _timing.add_device_arg(ap)
    args = ap.parse_args(argv)
    print(json.dumps(bench_fit(
        args.data, args.batch, args.steps, args.warm, args.loader_samples,
        args.compute_dtype, args.vgg_dtype, args.compact, args.device_darken,
        args.u8, args.prefetch, args.sync_every, args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
