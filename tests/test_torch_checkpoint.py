"""The port's checkpoints (utils/checkpoint.py over TrainState.state_dict)
and the generator-only consumers' helpers (Trainer.shared,
init_generator_vars), on the CPU at 32 px, n_res=2, f32."""

import json
import os

import numpy as np
import pytest
import torch

from blindshadowremoval_tpu_torch.config import get_config
from blindshadowremoval_tpu_torch.models import build_generator
from blindshadowremoval_tpu_torch.train.trainer import (
    Trainer,
    init_generator_vars,
)
from blindshadowremoval_tpu_torch.utils.checkpoint import CheckpointManager

S = 32
CFG = dict(img_size=S, n_res=2, batch_size=1, compute_dtype="float32",
           vgg_dtype="float32")


@pytest.fixture(autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    b = {"img_dark": rng.uniform(size=(2, S, S, 3)),
         "gt": rng.uniform(size=(2, S, S, 3)),
         "mask": (rng.uniform(size=(2, S, S, 1)) > 0.7) * 1.0,
         "uv": rng.uniform(size=(2, S, S, 3)),
         "reg": rng.uniform(-0.02, 0.02, (2, S, S, 6)),
         "face": rng.uniform(size=(2, S, S, 1))}
    return {k: torch.from_numpy(v.astype(np.float32)) for k, v in b.items()}


def _stepped(steps=2, **overrides):
    trainer = Trainer(get_config("train", **{**CFG, **overrides}),
                      device="cpu")
    state = trainer.init_state(seed=0)
    gen = torch.Generator().manual_seed(1)
    for i in range(steps):
        state, _, _ = trainer.train_step(state, _batch(i), gen)
    return trainer, state


def _assert_same_state(a, b):
    assert a.step == b.step
    for name in ("gen", "disc", "vgg"):
        sa, sb = getattr(a, name).state_dict(), getattr(b, name).state_dict()
        assert sa.keys() == sb.keys()
        for k in sa:
            assert torch.equal(sa[k], sb[k]), f"{name} {k}"
    for mod, oa, ob in ((a.gen, a.gen_opt, b.gen_opt),
                        (a.disc, a.disc_opt, b.disc_opt)):
        pb = dict(zip([n for n, _ in mod.named_parameters()],
                      ob.param_groups[0]["params"]))
        for (name, p) in mod.named_parameters():
            sa, sb = oa.state[p], ob.state[pb[name]]
            for key in ("step", "exp_avg", "exp_avg_sq"):
                assert torch.equal(sa[key], sb[key]), f"{name} {key}"
        assert oa.param_groups[0]["lr"] == ob.param_groups[0]["lr"]


@pytest.mark.parametrize("decay", [1.0, 0.5])
def test_checkpoint_round_trip(tmp_path, decay):
    """Save, restore into a fresh state: weights, statistics, both Adam
    states, the step and the learning-rate staircase equal, bitwise; the
    next step then equals the uninterrupted run's."""
    kw = dict(lr_decay_factor=decay, lr_decay_epochs=1, steps_per_epoch=1)
    trainer, state = _stepped(**kw)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.latest_step() is None
    mgr.save(2, state)
    assert mgr.latest_step() == 2
    restored, step = mgr.restore_latest(trainer.init_state(seed=7))
    assert step == 2
    _assert_same_state(state, restored)
    # one more step on each: the same losses and parameters
    out = [trainer.train_step(s, _batch(9), torch.Generator().manual_seed(4))
           for s in (state, restored)]
    for k in out[0][1]:
        assert torch.equal(out[0][1][k], out[1][1][k]), k
    _assert_same_state(out[0][0], out[1][0])
    if decay != 1.0:
        assert restored.gen_opt.param_groups[0]["lr"] == pytest.approx(
            1e-4 * 0.5 ** 3)


def test_rolling_max_to_keep(tmp_path):
    _, state = _stepped(steps=1)
    mgr = CheckpointManager(str(tmp_path), max_to_keep=3)
    for step in range(1, 7):
        mgr.save(step, state)
    assert mgr.all_steps() == [4, 5, 6]
    assert sorted(f for f in os.listdir(tmp_path)
                  if f.endswith(".pt")) == ["4.pt", "5.pt", "6.pt"]
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_save_best_keeps_the_maximum_across_managers(tmp_path):
    trainer, state = _stepped(steps=1)
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.best_record() is None
    assert mgr.restore_best(state) == (state, 0)
    assert mgr.save_best(1, state, 18.5)
    state2, _, _ = trainer.train_step(state, _batch(3),
                                      torch.Generator().manual_seed(0))
    snapshot = {k: v.clone() for k, v in state2.gen.state_dict().items()}
    assert not mgr.save_best(2, state2, 18.0)       # worse: kept the old
    assert mgr.save_best(3, state2, 19.25)           # better: replaced
    assert not mgr.save_best(4, state2, 19.25)       # a tie keeps the record
    # the record survives a new manager (a restarted run)
    mgr2 = CheckpointManager(str(tmp_path))
    assert mgr2.best_record() == {"step": 3, "metric": 19.25}
    with open(tmp_path / "best_metric.json") as f:
        assert json.load(f)["step"] == 3
    assert not mgr2.save_best(5, state2, 19.0)
    assert os.listdir(tmp_path / "best") == ["3.pt"]
    restored, step = mgr2.restore_best(trainer.init_state(seed=3))
    assert step == 3
    for k, v in restored.gen.state_dict().items():
        assert torch.equal(v, snapshot[k]), k


def test_restore_eval_ignores_the_optimizer(tmp_path):
    """A checkpoint trained with the LR staircase gives its generator to a
    constant-LR config; the whole state refuses to load there."""
    _, state = _stepped(steps=1, lr_decay_factor=0.9, lr_decay_epochs=1,
                        steps_per_epoch=1)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state)
    const_cfg = get_config("train", **CFG)
    sd, step = CheckpointManager(str(tmp_path)).restore_eval()
    assert step == 1
    gen = build_generator(const_cfg, sd, "cpu")
    for k, v in state.gen.state_dict().items():
        assert torch.equal(gen.state_dict()[k], v), k
    with pytest.raises(ValueError, match="schedule"):
        mgr.restore_latest(Trainer(const_cfg, device="cpu").init_state())


def test_empty_directory_gives_the_template(tmp_path):
    trainer = Trainer(get_config("train", **CFG), device="cpu")
    template = trainer.init_state(seed=0)
    mgr = CheckpointManager(str(tmp_path / "new"))
    assert mgr.restore_latest(template) == (template, 0)
    assert mgr.restore_eval() == (None, 0)
    sd = {"x": torch.zeros(1)}
    assert mgr.restore_eval(sd) == (sd, 0)
    assert mgr.latest_step() is None and mgr.all_steps() == []


def test_trainer_shared_caches_by_config_value():
    cfg_a = get_config("train", **CFG)
    cfg_b = get_config("train", **CFG)
    assert cfg_a is not cfg_b
    t1 = Trainer.shared(cfg_a, device="cpu")
    assert Trainer.shared(cfg_b, device="cpu") is t1
    assert Trainer.shared(get_config("train", **{**CFG, "batch_size": 2}),
                          device="cpu") is not t1
    vgg = {"w": torch.zeros(1)}
    t2 = Trainer.shared(cfg_a, vgg, device="cpu")
    assert t2 is not t1 and Trainer.shared(cfg_a, vgg, device="cpu") is t2


def test_init_generator_vars_is_the_trainers_start():
    cfg = get_config("train", **CFG)
    gen, sd = init_generator_vars(cfg, seed=4)
    state = Trainer(cfg, device="cpu").init_state(seed=4)
    assert type(gen) is type(state.gen)
    for k, v in state.gen.state_dict().items():
        assert torch.equal(sd[k], v), k
