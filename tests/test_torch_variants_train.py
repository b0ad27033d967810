"""One GAN train step of the TSM and RGB variants (train/trainer.py)
against one JAX step, on the CPU, in f32, at 32 px with n_res=2 and one
sample (2 views), pinned as tests/test_torch_train_step.py pins the GSC
step: a fixed (img, mask_sv), no saturation jitter, no mirror swap.  The
TSM step runs once with each value of the ShareLayer gate: JAX draws it
from `jax.random.split(key, 4)[3]`, so the JAX step takes a key that gives
the value, and the port's `share_gate` is forced to it.

Limits, from the JAX step's own sensitivity: the generator input (the
pinned image) times 1 + 1e-6 noise moves JAX's adversarial loss `gen` (a
mean of random-init discriminator logits, ~0.03) by 1.1e-5 (TSM) and
6.4e-5 (RGB) relative, and JAX's first moments by up to 1.6e-2 with the
ShareLayer on (the RGB half's BatchNorms over 2 views of a 4x4
bottleneck), 2.9e-4 with it off and 5.2e-4 for RGB."""

import jax
import numpy as np
import pytest
import torch

from blindshadowremoval_tpu.config import get_config as jax_config
from blindshadowremoval_tpu.train import trainer as jtrainer
from blindshadowremoval_tpu_torch.config import get_config
from blindshadowremoval_tpu_torch.models.generator_tsm import TSMGenerator
from blindshadowremoval_tpu_torch.models.weights import (
    discriminator_from_jax,
    from_jax_variables,
    vgg_from_jax,
)
from blindshadowremoval_tpu_torch.train import trainer as ttrainer
from test_torch_train_step import (
    CFG,
    S,
    _batch,
    _check_moments,
    _moments,
    _pinned,
    _tensors,
)


def _key_with_gate(share: bool) -> jax.Array:
    """The first PRNGKey(i) whose step draws this share gate
    (train/trainer.py:316-320)."""
    for i in range(100):
        key = jax.random.PRNGKey(i)
        if bool(jax.random.uniform(jax.random.split(key, 4)[3]) > 0.5) == share:
            return key
    raise AssertionError("no key draws the gate")


def _jax_step(variant, key, train=True):
    """The pinned JAX step of `variant` from a fresh init: (initial state,
    new state, losses), numpy leaves and floats."""
    img, mask_sv = _pinned()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrainer, "compose_shadow_image",
                   lambda key, mask, gt, dark, face: (img, mask_sv, None))
        mp.setattr(jtrainer.Trainer, "_saturation_aug",
                   lambda self, key, gt, dark: (gt, dark))
        mp.setattr(jtrainer.Trainer, "_mirror_consistency",
                   lambda self, key, x: x)
        trainer = jtrainer.Trainer(jax_config("train", variant=variant,
                                              **CFG))
        state = jax.tree.map(np.asarray, jax.jit(trainer._init_state)(
            jax.random.PRNGKey(0)))
        new_state, losses, _ = trainer.train_step(state, _batch(), key,
                                                  train=train)
    return (state, jax.tree.map(np.asarray, new_state),
            {k: float(v) for k, v in losses.items()})


@pytest.fixture(scope="module")
def jax_steps():
    return {
        ("tsm", True): _jax_step("tsm", _key_with_gate(True)),
        ("tsm", False): _jax_step("tsm", _key_with_gate(False)),
        ("tsm", "val"): _jax_step("tsm", _key_with_gate(False), train=False),
        ("rgb", None): _jax_step("rgb", jax.random.PRNGKey(1)),
    }


def _port(variant, state, monkeypatch, share=None):
    img, mask_sv = _pinned()
    monkeypatch.setattr(
        ttrainer, "compose_shadow_image",
        lambda gen, mask, gt, dark, face: (torch.tensor(img),
                                           torch.tensor(mask_sv), None))
    monkeypatch.setattr(ttrainer.Trainer, "_saturation_aug",
                        lambda self, gen, gt, dark: (gt, dark))
    monkeypatch.setattr(ttrainer.Trainer, "_mirror_consistency",
                        lambda self, gen, x: x)
    if share is not None:
        monkeypatch.setattr(ttrainer.Trainer, "share_gate",
                            lambda self, gen, train: torch.tensor(share))
    trainer = ttrainer.Trainer(get_config("train", variant=variant, **CFG),
                               vgg_weights=vgg_from_jax(state.vgg_params),
                               device="cpu")
    tstate = trainer.init_state(
        gen_state=from_jax_variables({"params": state.gen_params,
                                      "batch_stats": state.gen_stats}),
        disc_state=discriminator_from_jax({"params": state.disc_params,
                                           "batch_stats": state.disc_stats}))
    return trainer, tstate


def _check_losses(losses, want):
    assert set(losses) == set(want) == set(ttrainer.LOSS_NAMES)
    for name, v in losses.items():
        # f32 losses of one forward: the GSC step's bar, but for the
        # adversarial term (measured 3.1e-5 TSM, 1.2e-4 RGB; see above)
        rtol = 5e-4 if name == "gen" else 3e-5
        np.testing.assert_allclose(float(v), want[name], rtol=rtol,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("variant,share,limit", [
    ("tsm", True, 5e-2),     # the JAX step's own noise: 1.6e-2
    ("tsm", False, 1e-3),
    ("rgb", None, 1e-3),
])
def test_variant_step_matches_jax(jax_steps, monkeypatch, variant, share,
                                  limit):
    """Losses, Adam's first moments of both networks (relative Frobenius
    error per tensor below `limit`) and the new BatchNorm statistics."""
    state, new_state, jax_losses = jax_steps[(variant, share)]
    trainer, tstate = _port(variant, state, monkeypatch, share)
    tstate, losses, figs = trainer.train_step(
        tstate, _tensors(_batch()), torch.Generator().manual_seed(0))
    assert tstate.step == 1 and figs["pred"].shape == (2, S, S, 3)
    _check_losses(losses, jax_losses)
    _check_moments(_moments(tstate.gen, tstate.gen_opt),
                   new_state.gen_opt_state[0].mu, new_state.gen_params,
                   new_state.gen_stats, from_jax_variables, "G", limit)
    _check_moments(_moments(tstate.disc, tstate.disc_opt),
                   new_state.disc_opt_state[0].mu, new_state.disc_params,
                   new_state.disc_stats, discriminator_from_jax, "D", limit)
    want = from_jax_variables({"params": new_state.gen_params,
                               "batch_stats": new_state.gen_stats})
    sd = tstate.gen.state_dict()
    for name in want:
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[name].numpy(), want[name].numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=name)


def test_tsm_val_step_shares_and_matches_jax(jax_steps, monkeypatch):
    """The val pass runs the ShareLayer whatever the gate would draw (JAX's
    key here draws False)."""
    state, _, jax_val = jax_steps[("tsm", "val")]
    trainer, tstate = _port("tsm", state, monkeypatch)
    assert trainer.share_gate(torch.Generator(), train=False) is True
    tstate, losses, _ = trainer.train_step(
        tstate, _tensors(_batch()), torch.Generator().manual_seed(0),
        train=False)
    assert tstate.step == 0
    _check_losses(losses, jax_val)


def test_share_gate_draws_from_the_step_generator():
    trainer = ttrainer.Trainer(get_config("train", variant="tsm", **CFG),
                               device="cpu")
    draws = [bool(trainer.share_gate(torch.Generator().manual_seed(i), True))
             for i in range(40)]
    assert draws == [bool(torch.rand((), generator=torch.Generator(
        ).manual_seed(i)) > 0.5) for i in range(40)]
    assert 5 < sum(draws) < 35
    tstate = trainer.init_state(seed=0)
    assert isinstance(tstate.gen, TSMGenerator)


def test_unpinned_variant_steps_move_both_networks():
    """Each variant's step with its own randomness (the TSM gate drawn):
    finite losses, and both networks move."""
    for variant in ("tsm", "rgb"):
        trainer = ttrainer.Trainer(get_config("train", variant=variant,
                                              **CFG), device="cpu")
        tstate = trainer.init_state(seed=0)
        g0 = [p.detach().clone() for p in tstate.gen.parameters()]
        d0 = [p.detach().clone() for p in tstate.disc.parameters()]
        for seed in range(2):
            tstate, losses, _ = trainer.train_step(
                tstate, _tensors(_batch(seed)),
                torch.Generator().manual_seed(seed))
            assert all(np.isfinite(float(v)) for v in losses.values())
        for before, module in ((g0, tstate.gen), (d0, tstate.disc)):
            assert any(not torch.equal(a, b) for a, b in
                       zip(before, module.parameters()))
