"""End-to-end throughput of the raw-image -> deshadowed pipeline
(counterpart of `tools/bench_e2e.py`).

Measures the warm `DeshadowPipeline` (eval/e2e.py):

  * detect stage: batched S3FD at the letterbox size, the host letterbox,
    decode and NMS included (models/sfd.py:FaceDetector);
  * align + crop + deshadow: FAN landmarks -> offline_crop -> the serving
    engine, through `DeshadowPipeline.__call__` with caller boxes (the
    detector's product), so every stage after detection runs;
  * the composed raw-image rate: the detect and (align+crop+deshadow)
    costs an image summed (the stages share the host thread);
  * `run_dir` serial against its depth-1 overlapped stage pipeline on the
    same PNGs (3 chunks at the serving batch), every image through the
    neural path, the canonical centred box standing in after the real
    detection where the random detector keeps none.

Weights are seeded (`models/weights.py:synthetic_sfd_weights`,
`synthetic_fan_weights`, the generator Glorot-uniform from seed 0): the
published S3FD and FAN checkpoints are external downloads, and the
throughput is set by the shapes.  The detector's candidate floor is raised
to `score_thresh = 0.9`, as the JAX tool does (`tools/bench_e2e.py:88`):
real images under real weights give a handful of candidates, where random
logits at the 0.05 floor would drown the run in NMS work no real frame
makes.  Host work stays on the CPU.  The text lines, then one JSON line.

    python -m blindshadowremoval_tpu_torch.tools.bench_e2e \
        [--images 64] [--size 720 1280] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

from blindshadowremoval_tpu_torch.config import get_config, resolve_device
from blindshadowremoval_tpu_torch.tools import _timing

SIZE = 256
N_RES = 6
FAN_MODULES = 4
SCORE_THRESH = 0.9


def bench_e2e(images: int = 64, size=(720, 1280), det_size: int = 640,
              det_batch: int = 8, fan_batch: int = 32, serve_batch: int = 32,
              device=None) -> dict:
    """The JAX tool's lines, printed; returns {"detect_images_per_s",
    "boxes_kept", "acd_images_per_s", "faces", "align_s", "crop_s",
    "deshadow_s", "e2e_images_per_s", "run_dir": {"serial": stats,
    "overlapped": stats}, "device"}."""
    from blindshadowremoval_tpu_torch.eval.e2e import DeshadowPipeline
    from blindshadowremoval_tpu_torch.models.weights import (
        fan_from_jax,
        sfd_from_jax,
        synthetic_fan_weights,
        synthetic_sfd_weights,
    )
    from blindshadowremoval_tpu_torch.utils.imageio import write_png

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    h, w = size
    frames = [rng.uniform(0, 255, (h, w, 3)).astype(np.uint8)
              for _ in range(images)]
    centred = (w * 0.3, h * 0.2, w * 0.7, h * 0.8)   # the detector's contract
    boxes = [centred] * images
    cfg = get_config("in_the_wild", img_size=SIZE, n_res=N_RES,
                     compute_dtype="bfloat16", fold_bn=False,
                     device_geometry=True, compact_output=True,
                     compact_ingress=True)
    print("building pipeline (warms all three stages) ...", flush=True)
    pipe = DeshadowPipeline(
        cfg, fan_weights=fan_from_jax(synthetic_fan_weights(
            2, num_modules=FAN_MODULES)),
        sfd_weights=sfd_from_jax(synthetic_sfd_weights(1)),
        det_size=det_size, det_batch=det_batch, fan_batch=fan_batch,
        fan_modules=FAN_MODULES, min_face=0, batch_size=serve_batch,
        device=dev)
    pipe.detector.score_thresh = SCORE_THRESH   # see the module docstring

    # ---- detect stage (device trunk + host letterbox/decode/NMS)
    pipe.detector(frames[:det_batch])          # warm the full path
    t0 = time.perf_counter()
    dets = pipe.detector(frames)
    t_det = time.perf_counter() - t0
    kept = sum(len(d) for d in dets)
    print(f"detect: {images / t_det:.1f} images/s "
          f"({1e3 * t_det / images:.2f} ms/image, {kept} boxes kept)",
          flush=True)

    # ---- align + crop + deshadow through the pipeline (caller boxes)
    pipe(frames[:serve_batch], boxes=boxes[:serve_batch])   # warm
    t0 = time.perf_counter()
    res = pipe(frames, boxes=boxes)
    t_acd = time.perf_counter() - t0
    faces = sum(r is not None for r in res)
    lt = pipe.last_times
    print(f"align+crop+deshadow: {images / t_acd:.1f} images/s "
          f"({faces}/{images} faces; align {lt.align:.2f}s "
          f"crop {lt.crop:.2f}s deshadow {lt.deshadow:.2f}s)", flush=True)
    per_img = t_det / images + t_acd / images
    print(f"e2e composed (stage sums): {1.0 / per_img:.1f} raw images/s "
          f"({1e3 * per_img:.2f} ms/image single-process)", flush=True)

    # ---- run_dir: serial stages against the overlapped stage pipeline
    orig_det = pipe._stage_detect

    def det_with_fallback(imgs_, lms_, bxs_):
        bxs_, dt = orig_det(imgs_, lms_, bxs_)
        for i in range(len(bxs_)):
            if lms_[i] is None and bxs_[i] is None:
                bxs_[i] = centred
        return bxs_, dt

    runs = {}
    pipe._stage_detect = det_with_fallback
    try:
        with tempfile.TemporaryDirectory(prefix="bench_e2e_") as work:
            src = os.path.join(work, "imgs")
            os.makedirs(src)
            # 3 chunks at the serving batch: no padded deshadow batch, and
            # the stage pipeline has depth to stream
            for i in range(3 * serve_batch):
                write_png(os.path.join(src, f"img{i:04d}.png"),
                          frames[i % images], level=1)
            for overlap in (False, True):
                stats = pipe.run_dir(src, os.path.join(work, f"out{overlap}"),
                                     batch_files=serve_batch,
                                     overlap=overlap)
                name = "overlapped" if overlap else "serial"
                runs[name] = stats
                print(f"run_dir {name}: wall {stats['wall']:.2f}s = "
                      f"{stats['images'] / stats['wall']:.1f} raw images/s "
                      f"(stage sums: det {stats['detect']:.2f} "
                      f"align {stats['align']:.2f} crop {stats['crop']:.2f} "
                      f"deshadow {stats['deshadow']:.2f}; "
                      f"{stats['faces']} faces, {stats['written']} written)",
                      flush=True)
    finally:
        pipe._stage_detect = orig_det
    return {"detect_images_per_s": images / t_det, "boxes_kept": kept,
            "acd_images_per_s": images / t_acd, "faces": faces,
            "align_s": lt.align, "crop_s": lt.crop,
            "deshadow_s": lt.deshadow, "e2e_images_per_s": 1.0 / per_img,
            "run_dir": runs, "device": _timing.device_label(dev)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m blindshadowremoval_tpu_torch.tools.bench_e2e",
        description="Raw images to deshadowed faces: detect, align + crop + "
                    "deshadow, and run_dir serial against overlapped")
    ap.add_argument("--images", type=int, default=64)
    ap.add_argument("--size", type=int, nargs=2, default=(720, 1280))
    ap.add_argument("--det-size", type=int, default=640)
    ap.add_argument("--det-batch", type=int, default=8)
    ap.add_argument("--fan-batch", type=int, default=32)
    ap.add_argument("--serve-batch", type=int, default=32)
    _timing.add_device_arg(ap)
    args = ap.parse_args(argv)
    print(json.dumps(bench_e2e(args.images, tuple(args.size), args.det_size,
                               args.det_batch, args.fan_batch,
                               args.serve_batch, args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
