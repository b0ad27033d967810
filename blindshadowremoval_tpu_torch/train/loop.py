"""The epoch-level training loop (port of
`blindshadowremoval_tpu/train/loop.py`, the reference's `FSRNet.train`,
train_test_GSC.py:166-197).

`fit`: restore the latest checkpoint (or start from the seed), then
`max_epoch` epochs of `steps_per_epoch` train steps; after each epoch a
checkpoint, optionally a quality probe that keeps the best checkpoint, and
a val pass of steps/10 steps with `train=False`.  Batches stream from the
train iterator's pool of parse processes (data/dataset.py) through
`_BatchPrefetcher`, which assembles and uploads batch i+1 while step i
runs.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Optional

import numpy as np
import torch

from blindshadowremoval_tpu_torch.config import Config
from blindshadowremoval_tpu_torch.train.trainer import Trainer
from blindshadowremoval_tpu_torch.utils.checkpoint import CheckpointManager
from blindshadowremoval_tpu_torch.utils.logging import TrainLogger

# [0,1]-bounded planes shipped as fixed point under config.compact_ingress
_COMPACT_KEYS = ("img_dark", "gt", "mask")


def _assemble(feed, batch_size: int, compact: bool = False,
              u8: bool = False) -> dict:
    """`batch_size` parsed samples (2 mirrored views each) as one host
    batch of [2 * batch_size, ...] numpy arrays.

    `compact` ships the [0,1] image planes as uint16 fixed point (uint8
    with `u8`, the 8-bit source's own step); the step dequantizes them on
    the device.  The compact wire CLAMPS gt and img_dark to [0, 1], where
    the reference's CTM extrapolations reach ~[-0.25, 1.3]: unclamped, the
    bf16 step goes NaN within ~10 steps at batch 32 (the device-darken
    wire clamps alike, data/synthesis.py)."""
    views = [next(feed) for _ in range(batch_size)]
    out = {k: np.concatenate([np.asarray(v[k]) for v in views], axis=0)
           for k in views[0]}
    if compact:
        scale, dtype = (255.0, np.uint8) if u8 else (65535.0, np.uint16)
        for k in _COMPACT_KEYS:
            if k in out:
                out[k] = np.round(
                    np.clip(out[k], 0.0, 1.0) * scale).astype(dtype)
    return out


def _next_batch(feed, batch_size: int, compact: bool = False,
                u8: bool = False, device="cpu") -> dict:
    """`_assemble`, as tensors on `device` (a plain copy; the train loop
    uploads through `_BatchPrefetcher`)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in _assemble(feed, batch_size, compact, u8).items()}


class _BatchPrefetcher:
    """One-thread double buffer for the train loop: the host parse AND
    the host-to-device copy of batch i+1 overlap step i.

    On a CUDA device the worker copies each batch into pinned host memory
    and uploads it on a side stream of its own, recording an event after
    the copies; the consumer's stream waits on that event (exactly this
    batch's copies, not the side stream's later work) and every tensor is
    recorded on the consumer's stream, so the allocator does not reuse its
    memory while the step still reads it.  A feed error surfaces on the
    consumer; `close()` unblocks a worker parked on a full queue.
    `wait_s` sums the time the consumer spent blocked on the queue."""

    def __init__(self, feed, batch_size: int, compact: bool, u8: bool,
                 device="cpu", depth: int = 1):
        self.device = torch.device(device)
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self.wait_s = 0.0

        def put(item) -> bool:
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def work():
            cuda = self.device.type == "cuda"
            stream = torch.cuda.Stream(self.device) if cuda else None
            while not self._stop.is_set():
                try:
                    host = _assemble(feed, batch_size, compact, u8)
                    if not cuda:
                        item = ({k: torch.from_numpy(np.ascontiguousarray(v))
                                 for k, v in host.items()}, None)
                    else:
                        with torch.cuda.stream(stream):
                            b = {k: torch.from_numpy(
                                np.ascontiguousarray(v)).pin_memory().to(
                                    self.device, non_blocking=True)
                                 for k, v in host.items()}
                            done = torch.cuda.Event()
                            done.record(stream)
                        item = (b, done)
                except BaseException as e:        # surface on the consumer
                    put(e)
                    return
                if not put(item):
                    return

        self._thread = threading.Thread(target=work, daemon=True,
                                        name="bsr-batch-prefetch")
        self._thread.start()

    def __next__(self) -> dict:
        t0 = time.perf_counter()
        item = self._q.get()
        self.wait_s += time.perf_counter() - t0
        if isinstance(item, BaseException):
            raise item
        batch, done = item
        if done is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(done)
            for t in batch.values():
                t.record_stream(stream)
        return batch

    def close(self) -> None:
        self._stop.set()
        # drain so a put-blocked worker can observe the stop flag
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)


class _UCBProbe:
    """Per-epoch UCB-subset quality probe for best-checkpoint selection: a
    small version of the UCB evaluation (train_test_GSC.py:360-748),
    `n_images` anchors at eval_views=1 through the fused one-pass eval
    step, mean PSNR out.  The batches and part masks parse once; the
    evaluator is built once and only its generator's weights change."""

    metric_name = "PSNR"
    metric_unit = "dB"

    def __init__(self, config: Config, n_images: int = 20, device=None):
        from blindshadowremoval_tpu_torch.data.dataset import Dataset
        from blindshadowremoval_tpu_torch.eval.evaluators import UCBEvaluator

        probe_cfg = dataclasses.replace(
            config, mode="ucb", eval_views=1, fold_bn=False,
            int8_head=False, egress_dtype="float32")
        if not probe_cfg.data_dirs_test or not probe_cfg.part_mask_root:
            raise ValueError(
                "select_best needs config.data_dirs_test (UCB input glob) "
                "and config.part_mask_root (the UCB_input_images_* parent) "
                "to run the quality probe")
        ds = Dataset(probe_cfg, "test")
        self._ev = UCBEvaluator(probe_cfg, None, device=device)
        self._batches = []
        it = iter(ds)
        for i in range(min(n_images, len(ds.name_list))):
            batch, box, name = next(it)
            # name-keyed mask pairing: a misordered mask dir fails loudly
            parts = self._ev._load_part_masks(probe_cfg.part_mask_root, i,
                                              sample_name=name)
            self._batches.append((batch, box, name, parts))

    def __call__(self, state) -> float:
        self._ev.gen.load_state_dict(state.gen.state_dict())
        psnrs = [self._ev.run_one_fused(b, box, name, parts)["psnr"]
                 for b, box, name, parts in self._batches]
        return float(sum(psnrs) / len(psnrs))


class _SFWProbe:
    """Per-epoch SFW shadow-segmentation AUC probe for best-checkpoint
    selection (the TSM variant's axis of quality: testsfw pixel ROC-AUC
    of the predicted shadow map against `*_label.png` class 2,
    train_with_TSM.py:619-707).  Frames parse once; each probe is one
    forward and one AUC a frame."""

    metric_name = "AUC"
    metric_unit = ""

    def __init__(self, config: Config, n_images: int = 20, device=None):
        from blindshadowremoval_tpu_torch.data.dataset import Dataset
        from blindshadowremoval_tpu_torch.eval.evaluators import SFWEvaluator

        probe_cfg = dataclasses.replace(
            config, mode="sfw", fold_bn=False, int8_head=False,
            int8_head_split=False, egress_dtype="float32")
        if not probe_cfg.data_dirs_test:
            raise ValueError(
                "select_best with probe_metric='auc' needs "
                "config.data_dirs_test pointing at an SFW-format directory "
                "glob")
        ds = Dataset(probe_cfg, "test", dset="sfw")
        if not ds.name_list:
            raise ValueError(
                f"no SFW frames ({probe_cfg.data_dirs_test!r} matched "
                "nothing with the <frame>_label.png contract)")
        self._ev = SFWEvaluator(probe_cfg, None, device=device)
        it = iter(ds)
        self._batches = [next(it)
                         for _ in range(min(n_images, len(ds.name_list)))]

    def __call__(self, state) -> float:
        from blindshadowremoval_tpu_torch.ops.auc import (
            roc_auc_with_sentinels,
        )

        self._ev.gen.load_state_dict(state.gen.state_dict())
        aucs = []
        for batch, _box, _name in self._batches:
            _, _, _, mask_pred, face = self._ev.forward(batch, frame=2,
                                                        share=True)
            shadow_gt = (batch["label"][0] == 2).astype(np.float32)
            aucs.append(float(roc_auc_with_sentinels(
                self._ev._tensor(shadow_gt),
                self._ev._tensor(mask_pred[0] * face[0]))))
        return float(sum(aucs) / len(aucs))


def _host_losses(losses: dict) -> dict:
    """The step's 0-d loss tensors as floats, in one device fetch."""
    vals = torch.stack([v.float() for v in losses.values()]).cpu().tolist()
    return dict(zip(losses, vals))


def fit(config: Config, dataset_train, dataset_val=None,
        trainer: Optional[Trainer] = None, seed: int = 0,
        select_best: bool = False, probe_images: int = 20,
        probe_metric: str = "psnr", device=None,
        stats: Optional[dict] = None):
    """Run the training schedule; returns the final TrainState.

    Resumes from the newest checkpoint in `config.checkpoint_dir` (its
    step is the epoch), so a second call with `max_epoch` raised goes on
    where the first stopped.  The step's randomness comes from one
    `torch.Generator` on the device seeded with `seed`, anew each call, as
    the JAX package derives its keys from PRNGKey(seed).  With
    `select_best`, every epoch runs a quality probe (`probe_metric`
    "psnr": the UCB probe; "auc": the SFW probe, on
    `config.data_dirs_test`) and keeps the best checkpoint under
    `<checkpoint_dir>/best`.  `device`: CUDA unless "cpu" (or the given
    `trainer`'s).  `stats`, when given a dict, gets a record an epoch under
    "epochs": the steps, the host seconds of the step loop (synchronized
    at its end), the seconds spent waiting on the prefetcher, those of
    the save, the probe and the val pass, the probe's value and the last
    logged losses.  The loaders' iterators close when fit returns."""
    trainer = trainer or Trainer.shared(config, device=device)
    dev = trainer.device
    state = trainer.init_state(seed)
    mgr = CheckpointManager(config.checkpoint_dir, device=dev)
    prefetch = feed = feed_val = None
    try:
        state, last_epoch = mgr.restore_latest(state)
        print("**********************************************************")
        print(f"Restore from Epoch {last_epoch}")
        print("**********************************************************")
        log = TrainLogger(config.checkpoint_dir, config.img_log_freq,
                          config.txt_log_freq, config.fig_size)
        feed = iter(dataset_train)
        feed_val = iter(dataset_val) if dataset_val is not None else None
        # build the probe first, so a misconfigured select_best fails
        # before the first epoch
        probe = None
        if select_best:
            if probe_metric not in ("psnr", "auc"):
                raise ValueError(f"probe_metric must be 'psnr' or 'auc', "
                                 f"got {probe_metric!r}")
            probe = (_SFWProbe if probe_metric == "auc"
                     else _UCBProbe)(config, probe_images, device=dev)
        gen = torch.Generator(device=dev).manual_seed(seed)
        wires = dict(compact=config.compact_ingress, u8=config.ingress_u8)
        prefetch = _BatchPrefetcher(feed, config.batch_size, device=dev,
                                    **wires)
        for epoch in range(last_epoch, config.max_epoch):
            t0 = time.perf_counter()
            wait0 = prefetch.wait_s
            shown = None
            with torch.profiler.record_function("fit.steps"):
                for step in range(config.steps_per_epoch):
                    batch = next(prefetch)
                    state, losses, figs = trainer.train_step(
                        state, batch, gen, train=True)
                    # fetching the losses syncs the host with the device
                    if step % config.log_every_steps == 0:
                        shown = _host_losses(losses)
                        log.display(shown, epoch, step, True,
                                    config.steps_per_epoch)
                        log.save_figures([figs["img"], figs["gt"],
                                          figs["pred"], figs["gs"],
                                          figs["mask_edge"]], True)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
            mgr.save(epoch + 1, state)
            t2 = time.perf_counter()
            p = None
            if probe is not None:
                p = probe(state)
                updated = mgr.save_best(epoch + 1, state, p)
                rec = mgr.best_record()
                print(f"probe: {len(probe._batches)}-image mean "
                      f"{probe.metric_name} {p:.4f} "
                      f"{probe.metric_unit}".rstrip()
                      + (" -> new best retained" if updated else
                         f" (best {rec['metric']:.4f} @ epoch "
                         f"{rec['step']})"))
            t3 = time.perf_counter()
            if feed_val is not None:
                for step in range(config.steps_per_epoch // 10):
                    batch = _next_batch(feed_val, config.batch_size,
                                        device=dev, **wires)
                    state, losses, figs = trainer.train_step(
                        state, batch, gen, train=False)
                    log.display(_host_losses(losses), epoch, step, False,
                                config.steps_per_epoch // 10)
                    log.save_figures([figs["img"], figs["gt"],
                                      figs["pred"]], False)
            t4 = time.perf_counter()
            if stats is not None:
                stats.setdefault("epochs", []).append(dict(
                    epoch=epoch + 1, steps=config.steps_per_epoch,
                    step_s=t1 - t0, wait_s=prefetch.wait_s - wait0,
                    save_s=t2 - t1, probe_s=t3 - t2, val_s=t4 - t3,
                    probe=p, losses=shown))
            print(f"\n*****Time for epoch {epoch + 1} is "
                  f"{int(time.perf_counter() - t0)} sec*****")
    finally:
        if prefetch is not None:
            prefetch.close()
        # a train Dataset's iterator owns a pool of parse processes:
        # release it
        for it in (feed, feed_val):
            try:
                getattr(it, "close", lambda: None)()
            except ValueError:        # still running in a stuck worker
                pass
        mgr.close()
    return state
