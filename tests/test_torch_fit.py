"""The port's training loop (train/loop.py): `fit` with its checkpoints,
resume, val pass and best-checkpoint probes, the batch prefetcher and the
compact wires, on the CPU at 32 px, n_res=2, f32 (the JAX package's
tests/test_trainer.py:121-148 and :243-271, for the port)."""

import os
import shutil

import numpy as np
import pytest
import torch

from blindshadowremoval_tpu_torch.config import get_config
from blindshadowremoval_tpu_torch.data.dataset import Dataset
from blindshadowremoval_tpu_torch.train import loop
from blindshadowremoval_tpu_torch.train.trainer import Trainer
from blindshadowremoval_tpu_torch.utils.checkpoint import CheckpointManager
from chip_smoke import synthetic_ucb_tree

TF_REF = os.path.join(os.path.dirname(__file__), "goldens", "tf_ref")
S = 32
CFG = dict(img_size=S, n_res=2, batch_size=1, compute_dtype="float32",
           vgg_dtype="float32", steps_per_epoch=10, max_epoch=1,
           img_log_freq=10)


@pytest.fixture(autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _sample(rng, s=S):
    """One parsed sample of the host-map wire (2 views)."""
    return {
        "img_dark": rng.uniform(size=(2, s, s, 3)).astype(np.float32),
        "gt": rng.uniform(size=(2, s, s, 3)).astype(np.float32),
        "mask": (rng.uniform(size=(2, s, s, 1)) > 0.7).astype(np.float32),
        "uv": rng.uniform(size=(2, s, s, 3)).astype(np.float32),
        "reg": rng.uniform(-0.02, 0.02, (2, s, s, 6)).astype(np.float32),
        "face": rng.uniform(size=(2, s, s, 1)).astype(np.float32)}


class FakeDataset:
    def __init__(self, seed=0):
        self.seed = seed

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        while True:
            yield _sample(rng)


def _cfg(tmp_path, **kw):
    return get_config("train", **{**CFG, **kw},
                      checkpoint_dir=str(tmp_path / "ckpt"))


def test_fit_assembles_batches_and_checkpoints(tmp_path):
    """fit stacks batch_size samples (2 views each) a step, runs the val
    pass (steps // 10 steps, train=False) and checkpoints each epoch."""
    cfg = _cfg(tmp_path, batch_size=2)
    seen = []
    trainer = Trainer(cfg, device="cpu")
    step = trainer.train_step

    def spy(state, batch, gen, train=True):
        seen.append((train, batch["gt"].shape))
        return step(state, batch, gen, train=train)

    trainer.train_step = spy
    stats = {}
    state = loop.fit(cfg, FakeDataset(), dataset_val=FakeDataset(1),
                     trainer=trainer, stats=stats)
    assert state.step == cfg.steps_per_epoch
    assert seen.count((True, (4, S, S, 3))) == cfg.steps_per_epoch
    assert seen[-1] == (False, (4, S, S, 3))           # the val pass
    assert all(torch.isfinite(p).all() for p in state.gen.parameters())
    assert CheckpointManager(cfg.checkpoint_dir).latest_step() == 1
    (ep,) = stats["epochs"]
    assert ep["epoch"] == 1 and ep["steps"] == 10 and ep["probe"] is None
    assert 0.0 <= ep["wait_s"] <= ep["step_s"]
    log = os.path.join(cfg.checkpoint_dir, "log.txt")
    assert os.path.isfile(log)
    assert os.path.isfile(os.path.join(cfg.checkpoint_dir,
                                       "epoch-1-Train-1.png"))


def test_fit_resumes_from_the_saved_epoch(tmp_path):
    cfg = _cfg(tmp_path)
    first = loop.fit(cfg, FakeDataset(), device="cpu")
    saved = {k: v.clone() for k, v in first.gen.state_dict().items()}
    mgr = CheckpointManager(cfg.checkpoint_dir)
    restored, epoch = mgr.restore_latest(
        Trainer(cfg, device="cpu").init_state(seed=9))
    assert epoch == 1 and restored.step == 10
    for k, v in restored.gen.state_dict().items():
        assert torch.equal(v, saved[k]), k
    # max_epoch raised: one more epoch, from the saved one
    more = get_config("train", **{**CFG, "max_epoch": 2},
                      checkpoint_dir=cfg.checkpoint_dir)
    second = loop.fit(more, FakeDataset(2), device="cpu")
    assert second.step == 20
    assert mgr.all_steps() == [1, 2]
    assert any(not torch.equal(v, saved[k])
               for k, v in second.gen.state_dict().items())
    # nothing left to do: a third call restores and returns
    third = loop.fit(more, FakeDataset(3), device="cpu")
    assert third.step == 20


def test_fit_reads_a_training_tree(tmp_path):
    """The device wires end to end: a training tree through Dataset, the
    uint8 wire, device geometry and device darkening."""
    src = os.path.join(TF_REF, "sfw_gsc_synth", "vid0")
    for ident, frames in (("id0", (0, 1)), ("id1", (2, 3))):
        os.makedirs(tmp_path / "train" / ident)
        for f in frames:
            for ext in ("png", "npy"):
                shutil.copy(os.path.join(src, f"{f}.{ext}"),
                            tmp_path / "train" / ident / f"{f}.{ext}")
    cfg = _cfg(tmp_path, data_dirs=(str(tmp_path / "train" / "*"),),
               data_dirs_val=(str(tmp_path / "train" / "*"),),
               device_geometry=True, device_darken=True,
               compact_ingress=True, ingress_u8=True)
    state = loop.fit(cfg, Dataset(cfg, "train", workers=2),
                     Dataset(cfg, "val", seed=1, workers=2), device="cpu")
    assert state.step == 10
    assert all(torch.isfinite(p).all() for p in state.gen.parameters())


def test_select_best_with_the_ucb_probe(tmp_path):
    root = synthetic_ucb_tree(str(tmp_path / "ucb"), n_images=2)
    cfg = _cfg(tmp_path, max_epoch=2, data_dirs_test=(
        os.path.join(root, "input", "*"),), part_mask_root=root)
    stats = {}
    loop.fit(cfg, FakeDataset(), select_best=True, probe_images=2,
             device="cpu", stats=stats)
    probes = [e["probe"] for e in stats["epochs"]]
    assert len(probes) == 2 and all(np.isfinite(probes))
    rec = CheckpointManager(cfg.checkpoint_dir).best_record()
    assert rec["metric"] == max(probes)
    assert rec["step"] == 1 + int(np.argmax(probes))
    assert os.listdir(os.path.join(cfg.checkpoint_dir, "best")) == [
        f"{rec['step']}.pt"]


def test_select_best_with_the_sfw_probe(tmp_path):
    cfg = _cfg(tmp_path, data_dirs_test=(
        os.path.join(TF_REF, "sfw_gsc_synth", "*"),))
    stats = {}
    loop.fit(cfg, FakeDataset(), select_best=True, probe_images=1,
             probe_metric="auc", device="cpu", stats=stats)
    (ep,) = stats["epochs"]
    assert 0.0 <= ep["probe"] <= 1.0
    assert CheckpointManager(cfg.checkpoint_dir).best_record() == {
        "step": 1, "metric": ep["probe"]}


def test_select_best_refuses_a_misconfigured_probe(tmp_path):
    cfg = _cfg(tmp_path, data_dirs_test=())
    with pytest.raises(ValueError, match="data_dirs_test"):
        loop.fit(cfg, FakeDataset(), select_best=True, device="cpu")
    with pytest.raises(ValueError, match="probe_metric"):
        loop.fit(cfg, FakeDataset(), select_best=True, probe_metric="ssim",
                 device="cpu")


def test_batch_prefetcher_orders_surfaces_and_closes():
    """Batches in feed order; a feed error raised on the consumer; close()
    releases a worker parked on a full queue; the u8 wire arrives as
    uint8."""
    samples = [{"gt": np.full((2, 4, 4, 3), i, np.float32)} for i in range(6)]

    def feed():
        yield from samples
        raise RuntimeError("feed exhausted")

    pf = loop._BatchPrefetcher(feed(), 1, compact=False, u8=False, depth=1)
    for i in range(6):
        assert float(next(pf)["gt"][0, 0, 0, 0]) == float(i)
    with pytest.raises(RuntimeError, match="feed exhausted"):
        next(pf)
    pf.close()

    def endless():
        while True:
            yield {"gt": np.full((2, 4, 4, 3), 0.5, np.float32),
                   "uv": np.zeros((2, 4, 4, 3), np.float32)}

    pf2 = loop._BatchPrefetcher(endless(), 2, compact=True, u8=True, depth=1)
    b = next(pf2)
    assert b["gt"].dtype == torch.uint8 and b["gt"].shape == (4, 4, 4, 3)
    assert int(b["gt"][0, 0, 0, 0]) == 128
    assert b["uv"].dtype == torch.float32        # only the [0,1] planes
    pf2.close()
    assert not pf2._thread.is_alive()


def test_compact_wires_clamp_and_quantize():
    """The compact wire clamps gt/img_dark/mask to [0, 1] (CTM fits reach
    past it) and quantizes at 1/65535 (u16) or 1/255 (u8)."""
    rng = np.random.default_rng(0)
    s = _sample(rng)
    for k in ("gt", "img_dark"):
        s[k] = s[k] * 1.55 - 0.25
    for u8, dtype, scale in ((False, torch.uint16, 65535.0),
                             (True, torch.uint8, 255.0)):
        b = loop._next_batch(iter([dict(s)]), 1, compact=True, u8=u8)
        plain = loop._next_batch(iter([dict(s)]), 1)
        for k in loop._COMPACT_KEYS:
            assert b[k].dtype == dtype
            np.testing.assert_allclose(
                b[k].numpy().astype(np.float32) / scale,
                np.clip(s[k], 0, 1), rtol=0, atol=0.5 / scale)
            assert plain[k].dtype == torch.float32
        assert b["uv"].dtype == torch.float32
