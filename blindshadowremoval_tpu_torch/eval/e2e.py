"""From raw photos to deshadowed faces (port of
`blindshadowremoval_tpu/eval/e2e.py`).

The reference runs this as three manual passes with files between them:
landmark detection (`bmvc2022-dataprocess.py:10-29`), the crop
(`dataprocess.py:39-78`) and inference (`train_test_GSC.py:934-948`).
Here it is one object whose network stages run batched at fixed shapes:

    S3FD detection (batched, det_size)   models/sfd.py:FaceDetector
      -> 2D-FAN landmarks (batched 256²)  models/fan.py:LandmarkAligner
      -> the offline crop to 256²         geometry/crop.py:offline_crop
      -> the serving engine               eval/serving.py:ShadowRemovalService
      -> the shadow-map-gated composite   (this module, on the host)

No part masks exist for arbitrary photos, so the predicted shadow map gated
by the face region decides the composite; `pred` and `mask_pred` are
returned raw too.  With `landmarks=` an image skips detection and
alignment (the reference's shipped `.npy` contract); with `boxes=` it skips
detection.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import queue
import threading
import time
from typing import Any, Optional, Sequence

import numpy as np
import torch

from blindshadowremoval_tpu_torch.config import Config, resolve_device
from blindshadowremoval_tpu_torch.eval.serving import ShadowRemovalService
from blindshadowremoval_tpu_torch.geometry.crop import offline_crop
from blindshadowremoval_tpu_torch.models.fan import LandmarkAligner
from blindshadowremoval_tpu_torch.models.sfd import FaceDetector
from blindshadowremoval_tpu_torch.utils.imageio import imread, write_png


@dataclasses.dataclass
class StageTimes:
    """Wall seconds per stage of the last __call__ (host and device)."""

    detect: float = 0.0
    align: float = 0.0
    crop: float = 0.0
    deshadow: float = 0.0
    images: int = 0
    faces: int = 0

    def as_dict(self) -> dict:
        total = self.detect + self.align + self.crop + self.deshadow
        d = dataclasses.asdict(self)
        d["total"] = total
        if self.images:
            d["images_per_s"] = self.images / total if total else float("inf")
        return d


class DeshadowPipeline:
    """Detector, aligner and serving engine on one device (CUDA unless
    `device="cpu"`), each stage padding its tail batch to its batch shape.

    `sfd_weights` and `fan_weights` are the port's state dicts
    (`models/sfd.py:load_sfd_npz`, `models/fan.py:load_fan_npz`, or
    `models/weights.py:{sfd,fan}_from_jax`); without them the caller must
    give boxes or landmarks.  Both networks run in `stage_dtype` (bf16 by
    default) and the aligner takes uint8 crops.  `service_kwargs` (e.g.
    `batch_size`) go to the ShadowRemovalService built from `config` and
    `state_dict`, unless a `service` is given."""

    def __init__(self, config: Config, state_dict: Any = None,
                 fan_weights: Optional[dict] = None,
                 sfd_weights: Optional[dict] = None,
                 det_size: int = 640, det_batch: int = 4,
                 fan_batch: int = 16, fan_modules: int = 4,
                 stage_dtype: Optional[torch.dtype] = None,
                 min_face: int = 250, service: Any = None,
                 device: Any = None, **service_kwargs):
        dt = torch.bfloat16 if stage_dtype is None else stage_dtype
        self.device = resolve_device(device)
        self.config = config
        self.min_face = min_face
        self.detector = None
        self.aligner = None
        if sfd_weights is not None:
            self.detector = FaceDetector(sfd_weights, det_size=det_size,
                                         batch_size=det_batch, dtype=dt,
                                         device=self.device)
        if fan_weights is not None:
            # uint8 crops: 4x fewer bytes up, and the 1/255 step lies inside
            # the crop's own resampling noise (models/fan.py)
            self.aligner = LandmarkAligner(fan_weights,
                                           num_modules=fan_modules,
                                           batch_size=fan_batch, dtype=dt,
                                           ingress_u8=True,
                                           device=self.device)
        self.service = service or ShadowRemovalService(
            config, state_dict, device=self.device, **service_kwargs)
        self.last_times = StageTimes()

    def __call__(self, images: Sequence[np.ndarray],
                 landmarks: Optional[Sequence[Optional[np.ndarray]]] = None,
                 boxes: Optional[Sequence[Optional[Sequence[float]]]] = None,
                 ) -> list[Optional[dict]]:
        """RGB frames -> per image a result dict, or None where no usable
        face was found (no detection, or a crop of at most `min_face` px:
        dataprocess.py:66's `length > 250`).

        `landmarks[i]` (68x2) skips detection and alignment for image i,
        `boxes[i]` detection only.  Keys: `pred` (the deshadowed crop),
        `mask_pred` (the face-gated shadow map), `out` (the composite),
        `crop` (the aligned input), `lm` (its landmarks), `box` (the
        detector's box or None) and `crop_box` (the service's crop box)."""
        t = StageTimes(images=len(images))
        n = len(images)
        lms = list(landmarks) if landmarks is not None else [None] * n
        bxs = list(boxes) if boxes is not None else [None] * n

        bxs, t.detect = self._stage_detect(images, lms, bxs)
        lms, t.align = self._stage_align(images, lms, bxs)
        crops, t.crop = self._stage_crop(images, lms)
        results, t.deshadow, t.faces = self._stage_deshadow(crops, bxs)
        self.last_times = t
        return results

    # ------------------------------------------------------------ stages
    # each stage maps its inputs to outputs and wall seconds, so __call__
    # and the overlapped run_dir share them

    def _stage_detect(self, images, lms, bxs):
        """Stage 1: S3FD boxes for the images with neither landmarks nor
        a box; the best-scoring face of each (the reference's preds[0])."""
        need = [i for i in range(len(images))
                if lms[i] is None and bxs[i] is None]
        dt = 0.0
        if need:
            if self.detector is None:
                raise ValueError(
                    "no sfd_weights and no landmarks/boxes given for "
                    f"{len(need)} image(s): pass one of the three")
            t0 = time.perf_counter()
            dets = self.detector([images[i] for i in need])
            for i, d in zip(need, dets):
                bxs[i] = tuple(d[0, :4]) if len(d) else None
            dt = time.perf_counter() - t0
        return bxs, dt

    def _stage_align(self, images, lms, bxs):
        """Stage 2: 2D-FAN landmarks for the images with a box but no
        landmarks."""
        need = [i for i in range(len(images))
                if lms[i] is None and bxs[i] is not None]
        dt = 0.0
        if need:
            if self.aligner is None:
                raise ValueError(
                    "no fan_weights and no landmarks given for "
                    f"{len(need)} image(s)")
            t0 = time.perf_counter()
            pts = self.aligner([images[i] for i in need],
                               [bxs[i] for i in need])
            for i, p in zip(need, pts):
                lms[i] = p
            dt = time.perf_counter() - t0
        return lms, dt

    def _stage_crop(self, images, lms):
        """Stage 3: the offline crop (host, dataprocess.py semantics)."""
        t0 = time.perf_counter()
        crops = [None if lm is None else
                 offline_crop(im, lm, out_size=self.config.img_size,
                              min_face=self.min_face)
                 for im, lm in zip(images, lms)]
        return crops, time.perf_counter() - t0

    def _stage_deshadow(self, crops, bxs):
        """Stage 4: the batched service and the shadow-map-gated
        composite."""
        keep = [i for i, c in enumerate(crops) if c is not None]
        results: list[Optional[dict]] = [None] * len(crops)
        dt = 0.0
        if keep:
            t0 = time.perf_counter()
            # offline_crop keeps the [0, 255] scale; the service takes
            # [0, 1], as the dataset parsers give it
            out = self.service.remove_shadows(
                [crops[i][0] / 255.0 for i in keep],
                [crops[i][1] for i in keep])
            dt = time.perf_counter() - t0
            for i, r in zip(keep, out):
                mask = np.clip(np.asarray(r["mask_pred"], np.float32),
                               0.0, 1.0)
                comp = r["pred"] * mask + r["img"] * (1.0 - mask)
                results[i] = {
                    "pred": r["pred"], "mask_pred": r["mask_pred"],
                    "out": np.clip(comp, 0.0, 1.0),
                    "crop": r["img"], "lm": crops[i][1],
                    "box": bxs[i], "crop_box": r["box"],
                }
        return results, dt, len(keep)

    # ------------------------------------------------------------- dirs
    def run_dir(self, input_dir: str, output_dir: str,
                batch_files: int = 16, overlap: bool = True) -> dict:
        """Every PNG in `input_dir` -> `<output_dir>/<name>-out.png` (the
        composite), `-pred.png` and `-mask.png`.  A PNG with a sibling
        `<name>.npy` uses those landmarks; the rest are detected and
        aligned.  Returns the stages' summed seconds, the wall time and
        the count written.

        `overlap=True` runs the stages as a depth-1 thread pipeline over
        chunks of `batch_files` files: reading, detection, alignment and
        the crop each on their own thread, the deshadow stage on this one,
        writing on another, so each works on a different chunk.  Every
        device stage ends in a fetch to the host, so a device error
        surfaces on its stage's thread and ends the run here.  An error in
        any stage, the writer's included, stops the run at once: no chunk
        is deshadowed after it.  (cuDNN's TF32 switch, which the f32
        networks turn off around their convolutions, is process-wide: run
        f32 networks on the card with `overlap=False`.)"""
        os.makedirs(output_dir, exist_ok=True)
        files = sorted(glob.glob(os.path.join(input_dir, "*.png")))
        chunks = [files[s:s + batch_files]
                  for s in range(0, len(files), batch_files)]
        agg = StageTimes()
        agg_lock = threading.Lock()
        written = 0
        t_wall = time.perf_counter()

        def read_chunk(chunk):
            imgs, lms = [], []
            for f in chunk:
                imgs.append(np.ascontiguousarray(imread(f)[..., ::-1]))
                npy = f.rsplit(".", 1)[0] + ".npy"
                lms.append(np.load(npy) if os.path.isfile(npy) else None)
            return imgs, lms

        def write_results(chunk, res):
            nonlocal written
            for f, r in zip(chunk, res):
                if r is None:
                    print(f"no face: {f}")
                    continue
                name = os.path.splitext(os.path.basename(f))[0]
                for key, suffix in (("out", "out"), ("pred", "pred"),
                                    ("mask_pred", "mask")):
                    img8 = np.clip(np.asarray(r[key], np.float32) * 255.0,
                                   0, 255).astype(np.uint8)
                    if img8.shape[-1] == 1:
                        img8 = np.repeat(img8, 3, axis=-1)
                    write_png(os.path.join(output_dir,
                                           f"{name}-{suffix}.png"), img8)
                written += 1

        def add_times(t: StageTimes):
            with agg_lock:
                for field in dataclasses.fields(StageTimes):
                    setattr(agg, field.name, getattr(agg, field.name)
                            + getattr(t, field.name))

        def finish_stats():
            stats = agg.as_dict()
            wall = time.perf_counter() - t_wall
            stats["wall"] = wall
            if agg.images:
                stats["images_per_s_wall"] = agg.images / wall
            stats["written"] = written
            return stats

        if not overlap:
            for chunk in chunks:
                imgs, lms = read_chunk(chunk)
                res = self(imgs, landmarks=lms)
                write_results(chunk, res)
                add_times(self.last_times)
            return finish_stats()

        # ---- the depth-1 stage pipeline.  Every blocking put and get
        # polls `stop`, so an error anywhere unblocks every thread.
        stop = threading.Event()
        errors: list[BaseException] = []

        def _put(q, item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def _get(q):
            while not stop.is_set():
                try:
                    return q.get(timeout=0.5)
                except queue.Empty:
                    continue
            return ("stop", None)

        def reader(q_out):
            try:
                for chunk in chunks:
                    imgs, lms = read_chunk(chunk)
                    if not _put(q_out, ("item", (chunk, imgs, lms,
                                                 [None] * len(imgs)))):
                        return
                _put(q_out, ("end", None))
            except BaseException as e:
                _put(q_out, ("err", e))

        def stage_worker(q_in, q_out, fn):
            while True:
                kind, payload = _get(q_in)
                if kind != "item":
                    _put(q_out, (kind, payload))
                    return
                try:
                    item = ("item", fn(*payload))
                except BaseException as e:
                    _put(q_out, ("err", e))
                    return
                if not _put(q_out, item):
                    return

        def detect(chunk, imgs, lms, bxs):
            bxs, dt = self._stage_detect(imgs, lms, bxs)
            add_times(StageTimes(detect=dt))
            return chunk, imgs, lms, bxs

        def align(chunk, imgs, lms, bxs):
            lms, dt = self._stage_align(imgs, lms, bxs)
            add_times(StageTimes(align=dt))
            return chunk, imgs, lms, bxs

        def crop(chunk, imgs, lms, bxs):
            crops, dt = self._stage_crop(imgs, lms)
            add_times(StageTimes(crop=dt))
            return chunk, crops, bxs

        def writer(q_in):
            while True:
                kind, payload = _get(q_in)
                if kind != "item":
                    return
                try:
                    write_results(*payload)
                except BaseException as e:
                    # stop at once: no further chunk is deshadowed
                    errors.append(e)
                    stop.set()
                    return

        q_read, q_det, q_aln, q_crop, q_write = (queue.Queue(maxsize=1)
                                                 for _ in range(5))
        threads = [
            threading.Thread(target=reader, args=(q_read,), daemon=True),
            threading.Thread(target=stage_worker,
                             args=(q_read, q_det, detect), daemon=True),
            threading.Thread(target=stage_worker,
                             args=(q_det, q_aln, align), daemon=True),
            threading.Thread(target=stage_worker,
                             args=(q_aln, q_crop, crop), daemon=True),
            threading.Thread(target=writer, args=(q_write,), daemon=True),
        ]
        for th in threads:
            th.start()
        try:
            while True:
                kind, payload = _get(q_crop)
                if kind == "err":
                    raise payload
                if kind != "item":
                    break
                chunk, crops, bxs = payload
                results, dt, faces = self._stage_deshadow(crops, bxs)
                add_times(StageTimes(deshadow=dt, images=len(chunk),
                                     faces=faces))
                if not _put(q_write, ("item", (chunk, results))):
                    break
            # the writer drains its queue before the shutdown
            _put(q_write, ("end", None))
            threads[-1].join()
        finally:
            stop.set()
            for th in threads:
                th.join()
        if errors:
            raise errors[0]
        return finish_stats()
