"""Data pipeline: host decode/crop + geometry -> batch dicts (port of
`blindshadowremoval_tpu/data/dataset.py`).

Batches are dicts of named [V, S, S, C] numpy arrays; `pack_views` /
`unpack_views` give the reference's channel-packed layout.  Images are
decoded by the port's own PNG codec (utils/imageio.py) with cv2's channel
conventions, and folders are natural-sorted without natsort.

File-layout contracts, as in the JAX package:
  * train / val dirs: `<identity>/<frame>.png` + `<frame>.npy` 68x2
    landmarks; a sample is one random frame of a random identity, cropped
    with augmentation, and its mirrored twin (`parse_train`), read by a
    pool of worker processes (`_train_iter`);
  * UCB test: `<root>/input/<id>/<img>.npy|png` with gt at `<root>/gt/...`
    (dataset.py:151-155);
  * FFHQ / in-the-wild: gt = input (dataset.py:622-623);
  * SFW: `<frame>.png` + `<frame>.npy` + `<frame>_label.png`
    (+ `<frame>_label_cmap.png`); video mode and the GSC variant's SFW
    protocol pick 10 temporally spread frames with the reference's
    frame-offset schedule (dataset.py:808-867); the other variants' SFW
    sample is the frame and its mirrored twin;
  * UCB under variant="tsm": the anchor and its mirrored twin
    (`parse_test_ucb_mirror`).
"""

from __future__ import annotations

import atexit
import concurrent.futures as _futures
import glob as _glob
import multiprocessing
import os
import queue as _queue
import re
import threading
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from blindshadowremoval_tpu_torch.config import Config
from blindshadowremoval_tpu_torch.data.synthesis import shadow_synthesis_host
from blindshadowremoval_tpu_torch.geometry.crop import face_crop_and_resize
from blindshadowremoval_tpu_torch.geometry.landmarks import (
    LM_REF,
    forehead_points,
)
from blindshadowremoval_tpu_torch.geometry.triangulation import (
    _with_anchors,
    build_triangulation,
    generate_face_region,
    generate_offset_map,
    generate_uv_map,
)
from blindshadowremoval_tpu_torch.utils.imageio import imread, resize_linear

# channel-packed layout of a test view (the reference's packed tensors)
TEST_PACK = ("img", 3), ("gt", 3), ("uv", 3), ("reg", 6), ("face", 1)


def _natsorted(items):
    """Natural sort (numeric-aware), matching natsort's default for paths."""
    def key(s):
        return [int(t) if t.isdigit() else t
                for t in re.split(r"(\d+)", str(s))]

    return sorted(items, key=key)


def _imread_rgb(path: str) -> np.ndarray:
    """[H, W, 3] RGB in [0, 1] (f64, as cv2's uint8 / 255.0)."""
    return imread(path)[..., ::-1] / 255.0


def _imread_gray_raw(path: str) -> np.ndarray:
    """[H, W, 1] f32 gray levels 0..255 (the label masks)."""
    return imread(path, gray=True)[..., None].astype(np.float32)


def _geometry(lm: np.ndarray, size: int) -> dict:
    return {
        "uv": generate_uv_map(lm, size),
        "reg": np.concatenate([generate_offset_map(lm, LM_REF, size),
                               generate_offset_map(LM_REF, lm, size)], axis=2),
        "face": generate_face_region(lm, size),
    }


def _geometry_primitives(lm: np.ndarray) -> dict:
    """Landmarks + Delaunay topologies instead of rasterized maps: with
    device geometry the forward rasterizes UV/offset/face maps on the
    device (`triangulation.device_geometry_maps`), and the host ships only
    these small arrays."""
    lm = np.asarray(lm, np.float32)
    fp = np.concatenate([lm, forehead_points(lm, 0.8)], axis=0)
    return {
        "lm": lm,
        "face_pts": fp.astype(np.float32),
        "uv_tris": build_triangulation(lm).triangles,
        "face_tris": build_triangulation(fp).triangles,
        "reg_tris": build_triangulation(_with_anchors(lm)).triangles,
    }


def _stack_views(views: Sequence[dict]) -> dict:
    """Per-view dicts -> [V, ...] arrays (int32 topologies, f32 the rest)."""
    return {k: np.stack([v[k] for v in views]).astype(
                np.int32 if k.endswith("_tris") else np.float32)
            for k in views[0]}


def pack_views(view: dict, layout=TEST_PACK) -> np.ndarray:
    """Dict -> channel-packed array (the reference's tensor layout)."""
    return np.concatenate([view[k][..., :c] for k, c in layout], axis=-1)


def unpack_views(packed: np.ndarray, layout=TEST_PACK) -> dict:
    out, ofs = {}, 0
    for k, c in layout:
        out[k] = packed[..., ofs:ofs + c]
        ofs += c
    return out


def prefetch(iterable, depth: int = 2):
    """Background-thread prefetch: parse sample i+1..i+depth on the host
    while the consumer's device work for sample i runs.  A parser error is
    raised at the consumer; a consumer that stops early (or raises) stops
    the producer thread."""
    q: _queue.Queue = _queue.Queue(maxsize=depth)
    done = object()
    stop = threading.Event()   # consumer gone: unblock + end the producer

    def put(item) -> bool:
        """Blocking put that gives up once the consumer is gone."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except _queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterable:
                if not put(item):
                    return
            put(done)
        except BaseException as e:  # surface parser errors at the consumer
            put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


# the train iterator's worker process: its Dataset and Generator
_WORKER: dict = {}


def _worker_init(config: Config, mode: str, names: list, seed: int,
                 started) -> None:
    """A parse worker's start: one torch intra-op thread (the workers fill
    the cores), and the Generator of SeedSequence(seed)'s k-th child for
    the k-th worker started.  The parse path calls no numpy BLAS
    (utils/imageio.py:resize_linear gathers): OpenBLAS's spinning thread
    pool, one a worker, left 7 workers barely faster than one."""
    torch.set_num_threads(1)
    with started.get_lock():
        k = started.value
        started.value += 1
    ds = Dataset(config, mode, seed=seed)
    ds.name_list = list(names)
    _WORKER["ds"] = ds
    _WORKER["rng"] = np.random.default_rng(
        np.random.SeedSequence(seed, spawn_key=(k,)))


def _worker_sample() -> dict:
    """One sample of a random identity, in a parse worker."""
    ds, rng = _WORKER["ds"], _WORKER["rng"]
    d = ds.name_list[int(rng.integers(0, len(ds.name_list)))]
    return ds.parse_train(d, rng=rng)


# the manager threads of closed parse pools, still joining their workers
_closing_pools: list = []


def stop_parse_servers() -> None:
    """Stop the forkserver that forks the parse workers, then the resource
    tracker they share, and wait for both to end (a later train iterator
    starts both again).  Left alone, each ends only once it sees its
    parent gone, and then unloads torch: a program would leave them
    running past its own end.  Runs at exit, after the executors' own exit
    hook has joined the workers; a caller that runs it before (the CLI)
    drops its iterators first.  Closed pools finish joining their workers
    before the tracker stops, which must outlive their semaphores."""
    from multiprocessing import forkserver, resource_tracker
    while _closing_pools:
        _closing_pools.pop().join(timeout=60)
    for server in (forkserver._forkserver, resource_tracker._resource_tracker):
        server._stop()


atexit.register(stop_parse_servers)


class Dataset:
    """Mode-dispatching dataset with the reference's `.name_list` contract:
    "train" and "val" list identity folders and iterate forever over
    random augmented samples parsed by `workers` processes; the other
    modes list test samples and iterate over them once."""

    def __init__(self, config: Config, mode: str, dset: Optional[str] = None,
                 seed: int = 0, workers: Optional[int] = None):
        self.config = config
        self.mode = mode
        self.dset = dset
        self.seed = seed
        # train/val parse processes; by default half the cores (2-16): on
        # an 8-core H100 host 4 keep up with the step (17 ms a sample, 543
        # ms a batch of 32 against a 552 ms step, chip_smoke.py phase 13)
        # and leave the rest to the step's launching thread, which a busy
        # host slows (phase 13 times the step alone and beside the pool)
        self.workers = workers or max(2, min((os.cpu_count() or 2) // 2, 16))
        self.rng = np.random.default_rng(seed)
        dirs = {"train": config.data_dirs,
                "val": config.data_dirs_val}.get(mode, config.data_dirs_test)
        self.name_list = self._collect(dirs)
        self.feed = iter(self)

    # ----------------------------------------------------------- listing
    def _collect(self, dirs: Sequence[str]) -> list[str]:
        if self.mode in ("train", "val"):
            return [d for pattern in dirs for d in _glob.glob(pattern)]
        # sfw frame eval keys off the label masks (dataset_with_TSM.py:62);
        # video mode and image eval key off the landmark files
        # (dataset.py:56)
        if self.dset == "sfw" and self.config.mode != "sfw_video":
            pattern = "/*_label.png"
        else:
            pattern = "/*.npy"
        samples: list[str] = []
        for d in dirs:
            for folder in _natsorted(_glob.glob(d)):
                samples += _natsorted(_glob.glob(folder + pattern))
        return samples

    # ----------------------------------------------------------- parsers
    def parse_train(self, identity_dir: str,
                    rng: Optional[np.random.Generator] = None) -> dict:
        """One training sample (dataset.py:219-265): a random frame of
        the identity, cropped with augmentation, and its mirrored twin, as
        a dict of [2, S, S, C] arrays.  `rng` (default `self.rng`) lets
        each parse worker draw from its own Generator.

        Four wires: `device_geometry` ships landmarks and topologies and the
        UNGATED occluder mask (the step rasterizes the face and gates by
        it) where host maps ship uv, reg and face; `device_darken` ships
        the raw crop as `gt` and no `img_dark` (the step derives the pair,
        one draw a mirrored pair, like this parser)."""
        cfg = self.config
        s = cfg.img_size
        rng = self.rng if rng is None else rng
        lms = _glob.glob(identity_dir + "/*.npy")
        lm_path = lms[int(rng.integers(0, len(lms)))]
        gt0 = _imread_rgb(lm_path.rsplit(".", 1)[0] + ".png")
        gt, lm, lm_mirror, _ = face_crop_and_resize(
            gt0, np.load(lm_path), s, aug=True, rng=rng)
        devgeo, devdark = cfg.device_geometry, cfg.device_darken
        gt, img_dark, mask, _, face = shadow_synthesis_host(
            gt, lm, 0.0, mask_dir=cfg.shadow_mask_dir or None, rng=rng,
            rasterize_face=not devgeo, darken=not devdark)
        if devgeo:
            g, gm = _geometry_primitives(lm), _geometry_primitives(lm_mirror)
        else:
            g, gm = _geometry(lm, s), _geometry(lm_mirror, s)
        view0 = {"gt": gt, "mask": mask[..., :1], **g}
        view1 = {"gt": gt[:, ::-1], "mask": mask[:, ::-1, :1], **gm}
        if img_dark is not None:
            view0["img_dark"] = img_dark
            view1["img_dark"] = img_dark[:, ::-1]
        if not devgeo:
            view0["face"] = face[..., :1]
            view1["face"] = face[:, ::-1, :1]
        return _stack_views([view0, view1])

    def _test_view(self, lm_path: str, gt: Optional[np.ndarray],
                   extra: Optional[np.ndarray] = None):
        """One eval view: crop + geometry; gt rides through the same crop.
        With `config.device_geometry` the view carries landmarks + Delaunay
        topologies instead of host-rasterized maps."""
        cfg = self.config
        s = cfg.img_size
        img = _imread_rgb(lm_path.rsplit(".", 1)[0] + ".png")
        chans = [img] + ([gt] if gt is not None else []) + \
            ([extra] if extra is not None else [])
        stacked = np.concatenate(chans, axis=2)
        crop, lm, lm_mirror, box = face_crop_and_resize(
            stacked, np.load(lm_path), s)
        g = _geometry_primitives(lm) if cfg.device_geometry else \
            _geometry(lm, s)
        view = {"img": crop[..., :3], **g}
        ofs = 3
        if gt is not None:
            view["gt"] = crop[..., ofs:ofs + 3]
            ofs += 3
        if extra is not None:
            view["extra"] = crop[..., ofs:]
        return view, box, lm_mirror

    def _parse_test_multiview(self, lm_path: str,
                              gt: np.ndarray) -> tuple[dict, np.ndarray]:
        """Anchor + eval_views-1 random same-folder reference views, all
        carrying the anchor's gt (dataset.py:148-302,616-770).  The views
        are drawn with the JAX package's calls on `self.rng`, in its order,
        so one seed picks the same views in both.  Returns (batch dict of
        [V,...] arrays, anchor crop box)."""
        views = []
        anchor, box, _ = self._test_view(lm_path, gt)
        views.append(anchor)
        pool = _glob.glob(os.path.dirname(lm_path) + "/*.npy")
        for _ in range(self.config.eval_views - 1):
            ref = pool[int(self.rng.integers(0, len(pool)))]
            v, _, _ = self._test_view(ref, gt)
            views.append(v)
        return _stack_views(views), np.asarray(box, np.float32)

    def parse_test_ucb(self, lm_path: str) -> tuple[dict, np.ndarray]:
        """UCB eval sample: gt lives in the parallel `gt/` tree."""
        return self._parse_test_multiview(
            lm_path, _imread_rgb(self._ucb_gt_path(lm_path)))

    def _mirror_geometry(self, lm_mirror: np.ndarray) -> dict:
        cfg = self.config
        return _geometry_primitives(lm_mirror) if cfg.device_geometry else \
            _geometry(lm_mirror, cfg.img_size)

    def parse_test_ucb_mirror(self, lm_path: str) -> tuple[dict, np.ndarray]:
        """The TSM variant's UCB sample (dataset.py:320-338): the anchor and
        its mirrored twin with mirrored geometry, gt riding the flip."""
        gt = _imread_rgb(self._ucb_gt_path(lm_path))
        v, box, lm_mirror = self._test_view(lm_path, gt)
        view_m = {"img": v["img"][:, ::-1], "gt": v["gt"][:, ::-1],
                  **self._mirror_geometry(lm_mirror)}
        return _stack_views([v, view_m]), np.asarray(box, np.float32)

    @staticmethod
    def _ucb_gt_path(lm_path: str) -> str:
        """`<root>/input/<id>/<img>` -> `<root>/gt/<id>/<img>.png`
        (dataset.py:151-155)."""
        parts = lm_path.replace("\\", "/").split("/")
        stem = parts[-1].split(".")[0] + ".png"
        return "/".join(parts[:-3] + ["gt"] + parts[-2:-1] + [stem])

    def parse_test_ffhq(self, lm_path: str) -> tuple[dict, np.ndarray]:
        """In-the-wild: gt = input (dataset.py:622-623)."""
        return self._parse_test_multiview(
            lm_path, _imread_rgb(lm_path.rsplit(".", 1)[0] + ".png"))

    def parse_test_sfw(self, label_path: str) -> tuple[dict, np.ndarray]:
        """One SFW frame and its mirrored twin, with the cmap and the label
        mask (dataset.py:353-383); the GSC variant has its own 10-frame
        protocol (_parse_test_sfw_gsc)."""
        if self.config.variant == "gsc":
            return self._parse_test_sfw_gsc(label_path)
        stem = label_path[:-len("_label.png")]
        # the cmap rides the label's stem: <frame>_label_cmap.png
        cmap = _imread_rgb(label_path[:-len(".png")] + "_cmap.png")
        label = _imread_gray_raw(label_path)
        extra = np.concatenate([cmap, label], axis=2)
        v, box, lm_mirror = self._test_view(stem + ".npy", None, extra)
        view_m = {"img": v["img"][:, ::-1], "extra": v["extra"][:, ::-1],
                  **self._mirror_geometry(lm_mirror)}
        batch = _stack_views([v, view_m])
        batch["cmap"] = batch["extra"][..., :3]
        batch["label"] = batch["extra"][..., 3:4]
        del batch["extra"]
        return batch, np.asarray(box, np.float32)

    @staticmethod
    def _available_frames(folder: str) -> tuple[int, int]:
        avail = sorted(int(os.path.basename(p).split(".")[0])
                       for p in _glob.glob(os.path.join(folder, "*.npy"))
                       if os.path.basename(p).split(".")[0].isdigit())
        return (avail[0], avail[-1]) if avail else (0, 0)

    def _parse_test_sfw_gsc(self, label_path: str) -> tuple[dict, np.ndarray]:
        """The GSC variant's testsfw parse (dataset.py:338-614): 10
        temporally spread frames, each carrying the anchor's cmap + label
        resized to the frame's raw resolution and cropped in that frame's
        own geometry.  Scheduled frames are clamped to the available ones
        (the reference `input()`-hangs on a missing frame)."""
        folder = os.path.dirname(label_path)
        stem = os.path.basename(label_path)[:-len("_label.png")]
        cmap = _imread_rgb(label_path[:-len(".png")] + "_cmap.png")
        label = _imread_gray_raw(label_path)
        lo, hi = self._available_frames(folder)
        frames = [min(max(fr, lo), hi)
                  for fr in self.video_frame_schedule(int(stem))]
        views, box = [], None
        for fr in frames:
            lm_path = os.path.join(folder, f"{fr}.npy")
            raw = _imread_rgb(os.path.join(folder, f"{fr}.png"))
            h, w = raw.shape[:2]
            if cmap.shape[:2] != (h, w):
                ex = np.concatenate(
                    [resize_linear(cmap, (w, h)),
                     resize_linear(label[..., 0], (w, h))[..., None]], axis=2)
            else:
                ex = np.concatenate([cmap, label], axis=2)
            v, b, _ = self._test_view(lm_path, None, ex.astype(np.float32))
            views.append(v)
            if box is None:
                box = b
        batch = _stack_views(views)
        batch["cmap"] = batch["extra"][..., :3]
        batch["label"] = batch["extra"][..., 3:4]
        del batch["extra"]
        return batch, np.asarray(box, np.float32)

    @staticmethod
    def video_frame_schedule(frame: int) -> list[int]:
        """The 10-frame temporal spread (dataset.py:808-867)."""
        f = frame
        if f < 3:
            rest = [f + 2, f + 4, f + 6, f + 8, f + 10, f + 12, f + 14,
                    f + 16, f + 1]
        elif f < 5:
            rest = [f + 1, f + 3, f + 5, f + 7, f + 9, f + 11, f + 13,
                    f + 15, f - 2]
        elif f < 7:
            rest = [f + 1, f + 3, f + 5, f + 7, f + 9, f + 11, f + 13,
                    f - 2, f - 4]
        elif f < 9:
            rest = [f + 1, f + 3, f + 5, f + 7, f + 9, f + 11, f - 2,
                    f - 4, f - 6]
        elif f > 100:
            rest = [f - 1, f - 3, f - 5, f - 7, f - 9, f - 11, f - 2,
                    f - 4, f - 6]
        else:
            rest = [f + 1, f + 3, f + 5, f + 7, f + 9, f - 2, f - 4,
                    f - 6, f - 8]
        return [f] + rest

    def parse_test_sfw_video(self, lm_path: str) -> tuple[dict, np.ndarray]:
        """10 temporally spread frames of one video (dataset.py:772-1065),
        clamped to the video's available frames (the reference blocks on a
        missing one)."""
        folder = os.path.dirname(lm_path)
        stem = os.path.basename(lm_path).split(".")[0]
        lo, hi = self._available_frames(folder)
        frames = [min(max(fr, lo), hi)
                  for fr in self.video_frame_schedule(int(stem))]
        views, box = [], None
        for fr in frames:
            v, b, _ = self._test_view(os.path.join(folder, f"{fr}.npy"), None)
            views.append(v)
            if box is None:
                box = b
        return _stack_views(views), np.asarray(box, np.float32)

    # --------------------------------------------------------- iteration
    def __iter__(self) -> Iterator:
        if self.mode in ("train", "val"):
            return self._train_iter()
        return self._test_iter()

    def _train_iter(self):
        """Endless random samples parsed by a pool of worker processes
        (the JAX package's thread pool, dataset.py:490-526, as processes),
        2 per worker in flight, yielded in submission order.

        Processes, not threads: the port's train step is eager, ~7,250
        kernel launches a step from the Python thread that trains, and a
        parse thread holds the GIL for its numpy and torch dispatch; with
        the JAX package's thread pool, fit ran 3.1-4.4 s a step against
        0.35 s for the bare step on an H100 host (chip_smoke.py phase 13,
        PERF.md §6).  JAX's step is one jitted call, so its threads never
        met this.

        Each worker draws from its own np.random.Generator, the k-th
        process started taking SeedSequence(seed)'s k-th child, and runs
        its torch CPU ops on one intra-op thread.  The pool lives as long
        as the iterator: closing or dropping it cancels the queued parses
        and ends the processes; at the program's exit the forkserver and
        resource tracker behind them are stopped too
        (`stop_parse_servers`)."""
        n_workers = self.workers
        # forkserver: a fresh server process, started once and never the
        # caller with its threads and CUDA context, imports the parser and
        # forks each worker; a worker re-imports the caller's main module,
        # so a script that trains keeps its work under `if __name__ ==
        # "__main__":`, as for any spawned process
        ctx = multiprocessing.get_context("forkserver")
        ctx.set_forkserver_preload([__name__])
        pool = _futures.ProcessPoolExecutor(
            n_workers, mp_context=ctx, initializer=_worker_init,
            initargs=(self.config, self.mode, self.name_list, self.seed,
                      ctx.Value("i", 0)))
        try:
            pending = [pool.submit(_worker_sample)
                       for _ in range(2 * n_workers)]
            idx = 0
            while True:
                result = pending[idx].result()
                pending[idx] = pool.submit(_worker_sample)
                idx = (idx + 1) % len(pending)
                yield result
        finally:
            manager = pool._executor_manager_thread
            pool.shutdown(wait=False, cancel_futures=True)
            if manager is not None:
                _closing_pools.append(manager)

    def _test_iter(self):
        for name in self.name_list:
            if self.dset == "sfw" and self.config.mode == "sfw_video":
                yield (*self.parse_test_sfw_video(name), name)
            elif self.dset == "sfw":
                yield (*self.parse_test_sfw(name), name)
            elif self.config.mode == "ucb":
                parse = (self.parse_test_ucb_mirror
                         if self.config.variant == "tsm"
                         else self.parse_test_ucb)
                yield (*parse(name), name)
            else:
                yield (*self.parse_test_ffhq(name), name)
