"""One full GAN train step of the port (train/trainer.py) against one JAX
step, on the CPU, in f32, at 32 px with n_res=2 and one sample (2 views).

Randomness is pinned on both sides in the test process only: the shadow
compositor returns a fixed (img, mask_sv), and the saturation jitter and
the mirror swap are the identity.  The JAX package is not edited.  Both
start from the JAX-initialized generator, discriminators and VGG.  Held:
the eight losses, Adam's first moments of both networks (after one step
every update is about +-lr, so the parameters alone say little), and the
new BatchNorm statistics.
"""

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
    vgg_from_jax,
)
from blindshadowremoval_tpu_torch.train import trainer as ttrainer

S = 32
CFG = dict(img_size=S, n_res=2, batch_size=1, compute_dtype="float32",
           vgg_dtype="float32")


def _batch(seed=0, s=S, b2=2):
    rng = np.random.default_rng(seed)
    return {
        "img_dark": rng.uniform(size=(b2, s, s, 3)).astype(np.float32),
        "gt": rng.uniform(size=(b2, s, s, 3)).astype(np.float32),
        "mask": (rng.uniform(size=(b2, s, s, 1)) > 0.7).astype(np.float32),
        "uv": rng.uniform(size=(b2, s, s, 3)).astype(np.float32),
        "reg": rng.uniform(-0.02, 0.02, (b2, s, s, 6)).astype(np.float32),
        "face": rng.uniform(size=(b2, s, s, 1)).astype(np.float32),
    }


def _pinned(seed=1, s=S, b2=2):
    """A fixed (img, mask_sv): a soft blob of shadow over a random image."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:s, :s] / s
    blob = np.exp(-((yy - 0.5) ** 2 + (xx - 0.4) ** 2) / 0.05)
    mask_sv = np.repeat(blob[None, :, :, None], b2, 0) * np.array(
        [0.6, 0.5, 0.4])
    img = rng.uniform(size=(b2, s, s, 3)) * (1.0 - 0.5 * mask_sv)
    return img.astype(np.float32), mask_sv.astype(np.float32)


@pytest.fixture(scope="module")
def jax_step():
    """The JAX step, pinned, and its initial state (numpy leaves)."""
    img, mask_sv = _pinned()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrainer, "compose_shadow_image",
                   lambda key, mask, gt, dark, face: (img, mask_sv, None))
        mp.setattr(jtrainer.Trainer, "_saturation_aug",
                   lambda self, key, gt, dark: (gt, dark))
        mp.setattr(jtrainer.Trainer, "_mirror_consistency",
                   lambda self, key, x: x)
        trainer = jtrainer.Trainer(jax_config("train", **CFG))
        state = jax.tree.map(np.asarray, jax.jit(trainer._init_state)(
            jax.random.PRNGKey(0)))
        new_state, losses, _ = trainer.train_step(
            state, _batch(), jax.random.PRNGKey(1), train=True)
        _, val_losses, _ = trainer.train_step(
            state, _batch(), jax.random.PRNGKey(2), train=False)
    return (state, jax.tree.map(np.asarray, new_state),
            {k: float(v) for k, v in losses.items()},
            {k: float(v) for k, v in val_losses.items()})


def _port(state, monkeypatch, **overrides):
    img, mask_sv = _pinned()
    monkeypatch.setattr(
        ttrainer, "compose_shadow_image",
        lambda gen, mask, gt, dark, face: (torch.tensor(img),
                                           torch.tensor(mask_sv), None))
    monkeypatch.setattr(ttrainer.Trainer, "_saturation_aug",
                        lambda self, gen, gt, dark: (gt, dark))
    monkeypatch.setattr(ttrainer.Trainer, "_mirror_consistency",
                        lambda self, gen, x: x)
    trainer = ttrainer.Trainer(get_config("train", **{**CFG, **overrides}),
                               vgg_weights=vgg_from_jax(state.vgg_params),
                               device="cpu")
    tstate = trainer.init_state(
        gen_state=from_jax_variables({"params": state.gen_params,
                                      "batch_stats": state.gen_stats}),
        disc_state=discriminator_from_jax({"params": state.disc_params,
                                           "batch_stats": state.disc_stats}))
    return trainer, tstate


def _tensors(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


def _moments(module, opt):
    """{name: exp_avg} of a torch module's parameters."""
    return {n: opt.state[p]["exp_avg"] for n, p in module.named_parameters()}


def _check_moments(got, jax_mu, jax_params, stats, convert, label,
                   limit=1e-3):
    want = convert({"params": jax.tree.map(np.asarray, jax_mu),
                    "batch_stats": stats})
    top = max(float(want[n].abs().max()) for n in got)
    for name, m in got.items():
        w = want[name]
        if float(w.abs().max()) < 1e-5 * top:
            # a bias feeding a train-mode BatchNorm: its gradient is zero in
            # exact arithmetic, rounding noise on both sides
            assert float(m.abs().max()) < 1e-5 * top, f"{label} {name}"
            continue
        # one f32 step of ~80 layers with train-mode BatchNorm over 2 (G)
        # or 4 (D) views, XLA and ATen summing in other orders: measured
        # at most 1.1e-4 relative (Frobenius)
        err = float((m - w).norm() / w.norm())
        assert err < limit, f"{label} {name}: relative error {err:.2e}"


def test_train_step_matches_jax(jax_step, monkeypatch):
    state, new_state, jax_losses, _ = jax_step
    trainer, tstate = _port(state, monkeypatch)
    before = {n: p.detach().clone() for n, p in tstate.disc.named_parameters()}
    tstate, losses, figs = trainer.train_step(
        tstate, _tensors(_batch()), torch.Generator().manual_seed(0))
    assert tstate.step == 1
    assert set(losses) == set(jax_losses) == set(ttrainer.LOSS_NAMES)
    for name, v in losses.items():
        # f32 losses of one forward: measured within 3e-6 relative
        np.testing.assert_allclose(float(v), jax_losses[name], rtol=3e-5,
                                   atol=1e-6, err_msg=name)
    # Adam's first moments are 0.1 * the step's gradients (optax mu,
    # torch exp_avg)
    jmu_g = new_state.gen_opt_state[0].mu
    jmu_d = new_state.disc_opt_state[0].mu
    _check_moments(_moments(tstate.gen, tstate.gen_opt), jmu_g,
                   new_state.gen_params, new_state.gen_stats,
                   from_jax_variables, "G")
    _check_moments(_moments(tstate.disc, tstate.disc_opt), jmu_d,
                   new_state.disc_params, new_state.disc_stats,
                   discriminator_from_jax, "D")
    # the new BatchNorm statistics of both networks
    for module, convert, params, stats in (
            (tstate.gen, from_jax_variables, new_state.gen_params,
             new_state.gen_stats),
            (tstate.disc, discriminator_from_jax, new_state.disc_params,
             new_state.disc_stats)):
        want = convert({"params": params, "batch_stats": stats})
        sd = module.state_dict()
        for name in want:
            if name.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(sd[name].numpy(),
                                           want[name].numpy(), rtol=1e-4,
                                           atol=1e-6, err_msg=name)
    # both networks moved
    assert any(not torch.equal(p, before[n])
               for n, p in tstate.disc.named_parameters())
    assert figs["pred"].shape == (2, S, S, 3)


def test_val_step_matches_jax_and_updates_nothing(jax_step, monkeypatch):
    state, _, _, jax_val = jax_step
    trainer, tstate = _port(state, monkeypatch)
    sd_g = {k: v.clone() for k, v in tstate.gen.state_dict().items()}
    sd_d = {k: v.clone() for k, v in tstate.disc.state_dict().items()}
    tstate, losses, _ = trainer.train_step(
        tstate, _tensors(_batch()), torch.Generator().manual_seed(0),
        train=False)
    for name, v in losses.items():
        np.testing.assert_allclose(float(v), jax_val[name], rtol=3e-5,
                                   atol=1e-6, err_msg=name)
    assert tstate.step == 0
    for sd, module in ((sd_g, tstate.gen), (sd_d, tstate.disc)):
        for k, v in module.state_dict().items():
            torch.testing.assert_close(v, sd[k], rtol=0, atol=0, msg=k)


def test_compact_ingress_matches_f32(jax_step, monkeypatch):
    state = jax_step[0]
    batch = _batch()
    out = {}
    for wire, scale, dtype in (("f32", None, None),
                               ("u16", 65535.0, np.uint16),
                               ("u8", 255.0, np.uint8)):
        trainer, tstate = _port(state, monkeypatch)
        b = dict(batch)
        if scale is not None:
            for k in ("gt", "img_dark", "face", "uv"):
                b[k] = np.rint(np.clip(batch[k], 0, 1) * scale).astype(dtype)
        _, out[wire], _ = trainer.train_step(
            tstate, {k: torch.from_numpy(v) for k, v in b.items()},
            torch.Generator().manual_seed(0))
    for name in ttrainer.LOSS_NAMES:
        f32 = float(out["f32"][name])
        # quantization 1/65535 and 1/255 of [0, 1] planes; the adversarial
        # terms ride unbounded random-init discriminator logits
        tol = 0.15 if name in ("gen", "disc_real", "disc_fake") else 3e-2
        np.testing.assert_allclose(float(out["u16"][name]), f32, rtol=1e-3,
                                   atol=1e-4, err_msg=name)
        np.testing.assert_allclose(float(out["u8"][name]), f32, rtol=tol,
                                   atol=3e-2, err_msg=name)


def test_staircase_lr_decay(jax_step, monkeypatch):
    trainer, tstate = _port(jax_step[0], monkeypatch, lr_decay_factor=0.5,
                            lr_decay_epochs=1, steps_per_epoch=2)
    lrs = []
    for _ in range(5):
        lrs.append(tstate.gen_opt.param_groups[0]["lr"])
        tstate, _, _ = trainer.train_step(tstate, _tensors(_batch()),
                                          torch.Generator().manual_seed(0))
    # optax.exponential_decay(staircase=True) on the count of updates made
    np.testing.assert_allclose(lrs, [1e-4, 1e-4, 5e-5, 5e-5, 2.5e-5])
    assert tstate.disc_opt.param_groups[0]["lr"] == pytest.approx(2.5e-5)


def test_unpinned_step_on_device_geometry_batch():
    """The step with its own randomness, on a device-geometry batch (the
    "lm" branch), with remat: finite losses, both networks move."""
    from blindshadowremoval_tpu_torch.data.dataset import _geometry_primitives
    from blindshadowremoval_tpu_torch.geometry.landmarks import LM_REF

    rng = np.random.default_rng(3)
    views = [_geometry_primitives(LM_REF + rng.normal(0, 0.005, LM_REF.shape))
             for _ in range(2)]
    batch = {k: torch.from_numpy(np.stack([v[k] for v in views]))
             for k in views[0]}
    base = _batch(4)
    batch.update({k: torch.from_numpy(base[k])
                  for k in ("gt", "img_dark", "mask")})
    trainer = ttrainer.Trainer(get_config("train", **CFG, remat=True),
                               device="cpu")
    tstate = trainer.init_state(seed=0)
    g0 = [p.detach().clone() for p in tstate.gen.parameters()]
    gen = torch.Generator().manual_seed(0)
    tstate, losses, figs = trainer.train_step(tstate, batch, gen)
    assert all(np.isfinite(float(v)) for v in losses.values())
    assert any(not torch.equal(a, b) for a, b in
               zip(g0, tstate.gen.parameters()))
    assert figs["img"].shape == (2, S, S, 3)


def test_step_refuses_what_is_not_ported():
    trainer = ttrainer.Trainer(get_config("train", **CFG), device="cpu")
    tstate = trainer.init_state(seed=0)
    batch = _tensors(_batch())
    del batch["img_dark"]
    with pytest.raises(NotImplementedError, match="ROADMAP C1"):
        trainer.train_step(tstate, batch, torch.Generator())
    with pytest.raises(NotImplementedError, match="ROADMAP C5"):
        get_config("train", compact_ingress=True, ingress_u8=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        ttrainer.Trainer(get_config("train", **CFG))


def test_train_preset_matches_jax_defaults():
    port, ref = get_config("train"), jax_config("train")
    assert port.mode == "train" and port.device_geometry is False
    for name in ("img_size", "n_res", "variant", "compute_dtype",
                 "vgg_dtype", "batch_size", "learning_rate",
                 "lr_decay_factor", "lr_decay_epochs", "steps_per_epoch",
                 "n_layer_d", "remat", "compact_ingress", "ingress_u8",
                 "device_darken", "device_geometry", "mode", "fold_bn",
                 "egress_dtype"):
        assert getattr(port, name) == getattr(ref, name), name
