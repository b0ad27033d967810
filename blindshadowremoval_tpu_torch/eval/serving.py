"""Batched inference service (port of
`blindshadowremoval_tpu/eval/serving.py:ShadowRemovalService`).

Requests (a face image and its 68 landmarks) are cropped and aligned on
the host, stacked into fixed-size batches (the tail batch padded), sent to
the device, run through the generator, clipped and face-gated there, and
fetched back.

`BatchingFrontend` coalesces single requests that arrive at any time into
the service's batches.

Usage:
    svc = ShadowRemovalService(cfg, state_dict, batch_size=64)
    outputs = svc.remove_shadows(images, landmarks)   # N images in, N out
    with BatchingFrontend(svc, max_delay_ms=5.0) as fe:
        result = fe.submit(image, landmarks).result()
    svc = ShadowRemovalService(cfg, state_dict, batch_size=64,
                               mesh=make_mesh((2,), ("data",)))
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Optional, Sequence

import numpy as np
import torch

from blindshadowremoval_tpu_torch.config import Config, resolve_device
from blindshadowremoval_tpu_torch.data.dataset import _geometry_primitives
from blindshadowremoval_tpu_torch.geometry.crop import face_crop_and_resize
from blindshadowremoval_tpu_torch.geometry.landmarks import LM_REF
from blindshadowremoval_tpu_torch.geometry.triangulation import (
    device_geometry_maps,
    generate_face_region,
    generate_offset_map,
    generate_uv_map,
)
from blindshadowremoval_tpu_torch.models import build_generator
from blindshadowremoval_tpu_torch.ops.calibration import calibrate_config
from blindshadowremoval_tpu_torch.ops.image import dequantize
from blindshadowremoval_tpu_torch.parallel.mesh import (
    batch_sharding,
    gather,
    shard_batch,
)


@dataclasses.dataclass
class ShadowRemovalService:
    """Batched inference over the config's generator variant (gsc, tsm
    with frame=1 and the ShareLayer on, or rgb, whose shadow map is zeros).

    `device_geometry` (on by default, as in the JAX package) rasterizes the
    UV, offset and face maps on the device from landmarks and Delaunay
    topologies (the host ships only those).  From the config:
    `compact_ingress` sends the cropped [0,1] image (and the UV map in
    host-maps mode) as uint16 fixed point, dequantized on the device;
    `compact_output` returns uint8 predictions and f16 shadow maps.
    `state_dict` holds unfolded weights (see `models/build_generator`).
    An int8 head at the auto bound (`int8_head_scale` 0.0) is calibrated
    from them (ops/calibration.py) before they are folded; `config` is
    the calibrated config after construction.

    `mesh` (parallel/mesh.py:make_mesh; JAX serving.py:61-92): each batch
    is split over the mesh's "data" axis, one generator replica on each
    shard's device, and put back together in order on the first of them
    (`device` is then that device); `batch_size` must be a multiple of the
    mesh size.  The model has no cross-batch op, so no collective runs.
    The replicas are called in turn from one thread; on separate cards
    their kernels overlap, as CUDA launches return at once."""

    config: Config
    state_dict: Any = None
    batch_size: int = 64
    device: Any = None
    device_geometry: bool = True
    mesh: Any = None

    def __post_init__(self):
        self._sharding = None
        if self.mesh is not None:
            n = self.mesh.size
            if self.batch_size % n:
                raise ValueError(
                    f"batch_size {self.batch_size} not divisible by the "
                    f"{n}-device mesh")
            self._sharding = batch_sharding(self.mesh)
            self.device = self._sharding.devices[0]
        self.device = resolve_device(self.device)
        # calibrated before build_generator folds: folding consumes the
        # BatchNorm statistics the bounds come from
        cfg, sd = self.config, self.state_dict
        if sd is None and (cfg.int8_head or cfg.int8_head_split):
            from blindshadowremoval_tpu_torch.train.trainer import (
                init_generator_vars,
            )

            sd = init_generator_vars(cfg)[1]   # build_generator's draw
        cfg = self.config = calibrate_config(cfg, sd)
        self.gen = build_generator(cfg, sd, self.device)
        self._replicas = [self.gen]
        if self._sharding is not None:
            self._replicas += [build_generator(cfg, sd, d)
                               for d in self._sharding.devices[1:]]
        # snapshot the wires: the call paths below read these, even if a
        # caller replaces the config afterwards
        self._compact = cfg.compact_output
        self._devgeo = self.device_geometry
        self._compact_in = cfg.compact_ingress

    # ----------------------------------------------------------- pipeline
    def preprocess(self, image: np.ndarray, landmarks: np.ndarray) -> dict:
        """Host side of one request: crop/align, then either the geometry
        primitives (device geometry) or the host-rasterized maps."""
        s = self.config.img_size
        crop, lm, _, box = face_crop_and_resize(image, landmarks, s)
        crop = np.asarray(crop, np.float32)
        if self._devgeo:
            return {"img": crop, "box": box, **_geometry_primitives(lm)}
        return {
            "img": crop,
            "uv": generate_uv_map(lm, s),
            "reg": np.concatenate([generate_offset_map(lm, LM_REF, s),
                                   generate_offset_map(LM_REF, lm, s)], 2),
            "face": generate_face_region(lm, s),
            "box": box,
        }

    def stage(self, chunk: Sequence[dict]) -> tuple:
        """Stack one chunk of preprocessed views (at most batch_size, the
        tail padded to batch_size) and send it to the device (over a mesh:
        each tensor as the list of its shards).  Returns what
        `forward_staged` takes."""
        n = len(chunk)
        bs = self.batch_size
        if n > bs:
            raise ValueError(f"chunk of {n} exceeds batch_size {bs}")

        def stack(key, fill=0.0):
            arr = np.stack([v[key] for v in chunk])
            if self._compact_in and key in ("img", "uv"):
                # [0,1] fixed-point wire format, dequantized on the device
                arr = np.rint(np.clip(arr, 0.0, 1.0)
                              * 65535.0).astype(np.uint16)
            elif not np.issubdtype(arr.dtype, np.integer):
                arr = arr.astype(np.float32)
            if n < bs:   # pad the tail batch to the batch shape
                pad = np.full((bs - n,) + arr.shape[1:], fill, arr.dtype)
                arr = np.concatenate([arr, pad])
            t = torch.from_numpy(arr)
            if self._sharding is not None:
                return shard_batch(t, self._sharding)
            return t.to(self.device)

        if self._devgeo:
            return (stack("img"), stack("lm"), stack("face_pts"),
                    stack("uv_tris", -1), stack("face_tris", -1),
                    stack("reg_tris", -1))
        return (stack("img"), stack("uv"), stack("reg"))

    @torch.inference_mode()
    def _forward(self, staged: tuple) -> tuple[torch.Tensor, torch.Tensor]:
        """Device side of one batch: maps, generator, clip, face gate and
        the egress cast; over a mesh, each shard on its replica, the
        results gathered on `device`."""
        if self._sharding is None:
            return self._forward_on(self.gen, staged)
        outs = [self._forward_on(gen, part)
                for gen, part in zip(self._replicas, zip(*staged))]
        return tuple(gather(list(o), self.device) for o in zip(*outs))

    @torch.inference_mode()
    def _forward_on(self, gen: torch.nn.Module,
                    staged: tuple) -> tuple[torch.Tensor, torch.Tensor]:
        s = self.config.img_size
        if self._devgeo:
            img, lm, face_pts, uv_tris, face_tris, reg_tris = staged
            maps = device_geometry_maps(lm, face_pts, uv_tris, face_tris,
                                        reg_tris, s)
            uv, reg, face = maps["uv"], maps["reg"], maps["face"]
        else:
            (img, uv, reg), face = staged, None
        img, uv = dequantize(img), dequantize(uv)
        variant = self.config.variant
        if variant == "rgb":
            rgb = gen(img, uv)
            dif = rgb[..., :1] * 0
        else:
            out = (gen(img, uv, reg, frame=1, share=True)
                   if variant == "tsm" else gen(img, uv))
            _, rgb, _, dif = out
        rgb = rgb.clamp(0.0, 1.0)
        if face is not None:
            dif = dif * face
        if self._compact:
            return (torch.round(rgb * 255.0).to(torch.uint8),
                    dif.to(torch.float16))
        return rgb, dif

    def forward_staged(self, staged: tuple,
                       chunk: Sequence[dict]) -> list[dict]:
        """Run the forward on `stage()`'s product and unpack the per-view
        result dicts (the device-to-host fetch happens here)."""
        n = len(chunk)
        rgb, dif = self._forward(staged)
        rgb, dif = _to_host(rgb)[:n], _to_host(dif)[:n]
        if self._compact:
            rgb = rgb.astype(np.float32) / 255.0
            dif = dif.astype(np.float32)
        results: list[dict] = []
        for i, v in enumerate(chunk):
            results.append({
                # device geometry gates mask_pred by the face map on the
                # device; the host-maps path multiplies here
                "pred": rgb[i],
                "mask_pred": dif[i] if self._devgeo else dif[i] * v["face"],
                "box": v["box"],
                "img": v["img"],        # the cropped/aligned input
            })
        return results

    def remove_shadows(self, images: Sequence[np.ndarray],
                       landmarks: Sequence[np.ndarray]) -> list[dict]:
        """N (image, 68x2 landmarks) pairs -> N {'pred', 'mask_pred', 'box',
        'img'} dicts, in batches of batch_size."""
        views = [self.preprocess(im, lm) for im, lm in zip(images, landmarks)]
        results: list[dict] = []
        bs = self.batch_size
        for start in range(0, len(views), bs):
            chunk = views[start:start + bs]
            results.extend(self.forward_staged(self.stage(chunk), chunk))
        return results


class BatchingFrontend:
    """Dynamic request batching over a ShadowRemovalService (port of the
    JAX package's `eval/serving.py:BatchingFrontend`).

    `submit()` returns a Future at once.  A collector thread assembles
    batches of up to `max_batch` requests (default: the service's batch
    size) or whatever arrived within `max_delay_ms` of a batch's first
    request, preprocesses each request (a bad one fails only its own
    future) and stages the batch; a dispatcher thread runs the forward, so
    the collector prepares batch i+1 while batch i runs (a depth-1
    pipeline of `stage` and `forward_staged`).  Batches reach the device in
    arrival order from one thread, so the service needs no lock.

    If the collector ever exits on an error outside the per-request
    handling, the frontend closes itself: the futures of the batch in hand
    and every queued future fail with that error, and later submits raise.
    (The JAX package's collector only signals its dispatcher then, and
    waiters hang.)"""

    def __init__(self, service: ShadowRemovalService,
                 max_batch: Optional[int] = None,
                 max_delay_ms: float = 5.0):
        self._service = service
        self._max_batch = int(max_batch or service.batch_size)
        if self._max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self._max_delay = float(max_delay_ms) / 1000.0
        self._q: queue.Queue = queue.Queue()
        self._closed = threading.Event()
        # serializes submit's closed check and enqueue against the flag
        # going up, so no request lands in a queue nobody drains
        self._submit_lock = threading.Lock()
        self.batches_dispatched = 0
        self.requests_served = 0
        self._dispatch_q: queue.Queue = queue.Queue(maxsize=1)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="bsr-serving-batcher")
        self._dispatcher = threading.Thread(target=self._dispatch_loop,
                                            daemon=True,
                                            name="bsr-serving-dispatch")
        self._thread.start()
        self._dispatcher.start()

    # ------------------------------------------------------------ client
    def submit(self, image: np.ndarray, landmarks: np.ndarray) -> Future:
        """Enqueue one request; the Future's result is the service's
        per-image dict ({'pred', 'mask_pred', 'box', 'img'})."""
        with self._submit_lock:
            if self._closed.is_set():
                raise RuntimeError("BatchingFrontend is closed")
            fut: Future = Future()
            self._q.put((image, landmarks, fut))
        return fut

    def close(self, flush: bool = True) -> None:
        """Stop both threads.  `flush=True` serves everything already
        queued first; otherwise queued futures are cancelled.  Idempotent."""
        if not flush:
            self._cancel_queued()
        with self._submit_lock:
            self._closed.set()
        self._thread.join(timeout=60.0)
        self._dispatcher.join(timeout=60.0)
        self._cancel_queued()

    def _cancel_queued(self) -> None:
        try:
            while True:
                self._q.get_nowait()[2].cancel()
        except queue.Empty:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # --------------------------------------------------------- collector
    def _loop(self) -> None:
        svc = self._service
        in_hand: list[Future] = []    # taken off the queue, not dispatched
        try:
            while True:
                try:
                    first = self._q.get(timeout=0.05)
                except queue.Empty:
                    if self._closed.is_set():
                        return
                    continue
                batch = [first]
                in_hand = [first[2]]
                deadline = time.monotonic() + self._max_delay
                while len(batch) < self._max_batch:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    try:
                        batch.append(self._q.get(timeout=remaining))
                    except queue.Empty:
                        break
                    in_hand.append(batch[-1][2])
                imgs, lms, futs = zip(*batch)
                live = [i for i, f in enumerate(futs)
                        if f.set_running_or_notify_cancel()]
                # one request's bad input fails only its own future
                views, ok = [], []
                for i in live:
                    try:
                        views.append(svc.preprocess(imgs[i], lms[i]))
                        ok.append(i)
                    except Exception as e:
                        futs[i].set_exception(e)
                bs = svc.batch_size
                for s in range(0, len(ok), bs):
                    sub_futs = [futs[i] for i in ok[s:s + bs]]
                    vchunk = views[s:s + bs]
                    try:
                        staged = svc.stage(vchunk)
                    except Exception as e:
                        for f in sub_futs:
                            f.set_exception(e)
                        continue
                    self._dispatch_q.put((staged, vchunk, sub_futs))
                    in_hand = [f for f in in_hand if f not in sub_futs]
                in_hand = []
        except BaseException as e:
            self._fail_all(e, in_hand)
            raise
        finally:
            self._dispatch_q.put(None)       # the dispatcher's shutdown

    def _fail_all(self, err: BaseException, in_hand: list) -> None:
        """The collector failed: close, and fail the futures it held and
        every queued one, so no waiter hangs."""
        with self._submit_lock:
            self._closed.set()
        failed = list(in_hand)
        try:
            while True:
                failed.append(self._q.get_nowait()[2])
        except queue.Empty:
            pass
        for f in failed:
            if not f.done():
                f.set_exception(err)

    def _dispatch_loop(self) -> None:
        while True:
            item = self._dispatch_q.get()
            if item is None:
                return
            staged, vchunk, futs = item
            try:
                results = self._service.forward_staged(staged, vchunk)
            except Exception as e:           # surface on every waiter
                for f in futs:
                    f.set_exception(e)
                continue
            self.batches_dispatched += 1
            self.requests_served += len(futs)
            for f, r in zip(futs, results):
                if not f.done():
                    f.set_result(r)


def _to_host(t: torch.Tensor) -> np.ndarray:
    # numpy has no bfloat16: a bf16 egress arrives on the host as f32
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()
