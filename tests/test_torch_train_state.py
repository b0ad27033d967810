"""A JAX training state carried into the port
(models/weights.py:train_state_from_jax): JAX takes two steps, the port
loads its state, and each takes one more step on the same batch, on the
CPU in f32 at 32 px, n_res=2, with the step's randomness pinned as in
tests/test_torch_train_step.py.  Held: the loaded state equal to the
converted one bitwise, the third step's losses and Adam's moments (both
first and second) after it, with and without the LR staircase."""

import jax
import numpy as np
import pytest
import torch

from blindshadowremoval_tpu.config import get_config as jax_config
from blindshadowremoval_tpu.train import trainer as jtrainer
from blindshadowremoval_tpu_torch.config import get_config
from blindshadowremoval_tpu_torch.models.weights import (
    discriminator_from_jax,
    from_jax_variables,
    train_state_from_jax,
)
from blindshadowremoval_tpu_torch.train import trainer as ttrainer
from test_torch_train_step import CFG, _batch, _check_moments, _pinned

# the staircase at every step, so the third step runs at lr / 4
DECAY = dict(lr_decay_factor=0.5, lr_decay_epochs=1, steps_per_epoch=1)


@pytest.fixture(autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _assert_bitwise(got, want, path="state"):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _assert_bitwise(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and torch.equal(got, want), path
    else:
        assert got == want, path


def _jax_run(overrides):
    """Three pinned JAX steps: (state after 2, state after 3, losses of
    the third), numpy leaves."""
    img, mask_sv = _pinned()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrainer, "compose_shadow_image",
                   lambda key, mask, gt, dark, face: (img, mask_sv, None))
        mp.setattr(jtrainer.Trainer, "_saturation_aug",
                   lambda self, key, gt, dark: (gt, dark))
        mp.setattr(jtrainer.Trainer, "_mirror_consistency",
                   lambda self, key, x: x)
        trainer = jtrainer.Trainer(jax_config("train", **CFG, **overrides))
        state = jax.tree.map(np.asarray, jax.jit(trainer._init_state)(
            jax.random.PRNGKey(0)))
        for i in range(2):
            state, _, _ = trainer.train_step(
                state, _batch(seed=i), jax.random.PRNGKey(i), train=True)
        two = jax.tree.map(np.asarray, state)
        three, losses, _ = trainer.train_step(
            two, _batch(seed=5), jax.random.PRNGKey(5), train=True)
    return two, jax.tree.map(np.asarray, three), {
        k: float(v) for k, v in losses.items()}


@pytest.mark.parametrize("overrides", [{}, DECAY], ids=["constant", "decay"])
def test_jax_state_continues_in_the_port(overrides, monkeypatch):
    two, three, jax_losses = _jax_run(overrides)
    payload = train_state_from_jax(two)
    assert payload["step"] == 2
    assert payload["gen_opt"]["count"] == payload["disc_opt"]["count"] == 2
    assert payload["lr_count"] == (2 if overrides else None)

    img, mask_sv = _pinned()
    monkeypatch.setattr(
        ttrainer, "compose_shadow_image",
        lambda gen, mask, gt, dark, face: (torch.tensor(img),
                                           torch.tensor(mask_sv), None))
    monkeypatch.setattr(ttrainer.Trainer, "_saturation_aug",
                        lambda self, gen, gt, dark: (gt, dark))
    monkeypatch.setattr(ttrainer.Trainer, "_mirror_consistency",
                        lambda self, gen, x: x)
    trainer = ttrainer.Trainer(get_config("train", **CFG, **overrides),
                               device="cpu")
    state = trainer.init_state(seed=3)
    state.load_state_dict(payload)
    assert state.step == 2
    # the loaded state is the converted one, bit for bit: G, D and VGG
    # parameters and statistics, both Adam states, the counts
    _assert_bitwise(state.state_dict(), payload)
    assert state.gen_opt.param_groups[0]["lr"] == pytest.approx(
        1e-4 * (0.25 if overrides else 1.0))
    state, losses, _ = trainer.train_step(
        state, {k: torch.tensor(v) for k, v in _batch(seed=5).items()},
        torch.Generator().manual_seed(0))
    assert state.step == 3
    for name, v in losses.items():
        if name == "gen":
            continue
        # f32 losses of the third step's forward: measured at most 2.2e-6
        # relative (disc_real, with the staircase)
        np.testing.assert_allclose(float(v), jax_losses[name], rtol=3e-6,
                                   atol=1e-6, err_msg=name)
    # gen = -sum of the mean fake logits of D's scales, and while every
    # logit exceeds -1, disc_fake = scales - gen: the two share their
    # rounding (2.5e-6 apart on each side of both, measured), and gen's
    # small size (~0.1 against disc_fake's ~2.9) makes that 2.2e-5 of
    # gen.  So gen is held to 3e-6 of disc_fake's size
    np.testing.assert_allclose(float(losses["gen"]), jax_losses["gen"],
                               rtol=0,
                               atol=3e-6 * abs(jax_losses["disc_fake"]))
    # Adam's moments after the third step, within the pinned step's
    # limit: the first (mu, exp_avg) and the second (nu, exp_avg_sq)
    for module, opt, jopt, params, stats, convert, label in (
            (state.gen, state.gen_opt, three.gen_opt_state,
             three.gen_params, three.gen_stats, from_jax_variables, "G"),
            (state.disc, state.disc_opt, three.disc_opt_state,
             three.disc_params, three.disc_stats, discriminator_from_jax,
             "D")):
        for key, jkey in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
            got = {n: opt.state[p][key] for n, p in module.named_parameters()}
            _check_moments(got, getattr(jopt[0], jkey), params, stats,
                           convert, f"{label} {key}")
