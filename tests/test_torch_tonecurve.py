"""The port's tone curve (ops/tonecurve.py) and the device-darken wire
(data/synthesis.py:derive_darkened_views, the train step's branch) against
the JAX package, on the CPU at 32 px, with the JAX draws replayed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blindshadowremoval_tpu.data.synthesis import (
    derive_darkened_views as jax_derive,
)
from blindshadowremoval_tpu.ops import tonecurve as jtone
from blindshadowremoval_tpu_torch.config import get_config
from blindshadowremoval_tpu_torch.data.synthesis import (
    darkened_views_from_draws,
    derive_darkened_views,
)
from blindshadowremoval_tpu_torch.ops import tonecurve as ttone
from blindshadowremoval_tpu_torch.train import trainer as ttrainer

S = 32
# The port forms and solves the 3x3 normal equations in f64, the JAX
# package in f32 (Precision.HIGHEST).  Against a numpy f64 solve the
# port's CTMs sit within 6e-8 and JAX's within 3.8e-5 (measured on these
# inputs, 9 images), so the two packages' outputs differ by JAX's own
# rounding: CTMs within 5e-5, images within 2e-5 (measured 1.4e-5).
TOL = 2e-5
TOL_CTM = 5e-5


@pytest.fixture(autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _jax_gains(key, sigma=0.3):
    """The two gain triples jax's face_darken draws from `key`."""
    k1, k2 = jax.random.split(key)
    return tuple(np.asarray(0.5 + jax.random.uniform(
        k, (3,), minval=-sigma, maxval=sigma)) for k in (k1, k2))


def _images(seed, n=3, s=S):
    rng = np.random.default_rng(seed)
    # a smooth face-like ramp with texture: the CTM fits are well posed
    yy, xx = np.mgrid[:s, :s] / s
    base = np.stack([0.6 * yy + 0.2, 0.5 * xx + 0.3, 0.4 + 0.2 * yy * xx], -1)
    return np.clip(base[None] + rng.uniform(-0.15, 0.15, (n, s, s, 3)), 0,
                   1).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_face_darken_matches_jax(seed):
    imgs = _images(seed)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(imgs))
    g1, g2 = (np.stack(g) for g in zip(*(_jax_gains(k) for k in keys)))
    aug, dark, ctm = ttone.face_darken_from_draws(
        torch.from_numpy(imgs), torch.from_numpy(g1), torch.from_numpy(g2))
    for i, key in enumerate(keys):
        ja, jd, jc = jtone.face_darken(key, jnp.asarray(imgs[i]))
        np.testing.assert_allclose(aug[i].numpy(), np.asarray(ja), atol=TOL)
        np.testing.assert_allclose(dark[i].numpy(), np.asarray(jd), atol=TOL)
        np.testing.assert_allclose(ctm[i].numpy(), np.asarray(jc),
                                   atol=TOL_CTM)
        # the port's darkening CTM is the exact least-squares solution
        a = imgs[i].reshape(-1, 3).astype(np.float64)
        b = ttone.apply_tone_curve(torch.from_numpy(imgs[i:i + 1]),
                                   torch.from_numpy(g2[i:i + 1])).numpy()
        b = b.reshape(-1, 3).astype(np.float64)
        ata = a.T @ a
        exact = np.linalg.solve(ata + (1e-6 * np.trace(ata) / 3 + 1e-12)
                                * np.eye(3), a.T @ b).T
        np.testing.assert_allclose(ctm[i].numpy(), exact, atol=1e-6)


def test_tone_curve_and_ctm_match_jax():
    imgs = _images(5, n=2)
    gain = np.array([[0.21, 0.5, 0.79], [0.3, 0.7, 0.45]], np.float32)
    out = ttone.apply_tone_curve(torch.from_numpy(imgs),
                                 torch.from_numpy(gain)).numpy()
    for i in range(2):
        want = np.asarray(jtone.apply_tone_curve(jnp.asarray(imgs[i]),
                                                 jnp.asarray(gain[i])))
        np.testing.assert_allclose(out[i], want, atol=1e-6)
        ctm = ttone.get_ctm_ls(torch.from_numpy(imgs[i:i + 1]),
                               torch.from_numpy(out[i:i + 1]))[0].numpy()
        np.testing.assert_allclose(
            ctm, np.asarray(jtone.get_ctm_ls(jnp.asarray(imgs[i]),
                                             jnp.asarray(want))),
            atol=TOL_CTM)


def test_derive_darkened_views_matches_jax():
    """One draw a mirrored pair, the odd view the flip of its pair, the
    pair clamped to [0, 1]; gains replayed from jax's per-pair keys."""
    even = _images(7, n=2) * 1.3 - 0.1        # CTM excursions past [0, 1]
    gt_raw = np.stack([even, even[:, :, ::-1]], 1).reshape(4, S, S, 3)
    key = jax.random.PRNGKey(11)
    jgt, jdark = (np.asarray(x) for x in jax.jit(jax_derive)(
        key, jnp.asarray(gt_raw)))
    g1, g2 = (np.stack(g) for g in zip(*(
        _jax_gains(k) for k in jax.random.split(key, 2))))
    gt, dark = darkened_views_from_draws(
        torch.from_numpy(g1), torch.from_numpy(g2), torch.from_numpy(gt_raw))
    np.testing.assert_allclose(gt.numpy(), jgt, atol=TOL)
    np.testing.assert_allclose(dark.numpy(), jdark, atol=TOL)
    assert gt.min() >= 0.0 and gt.max() <= 1.0
    np.testing.assert_array_equal(gt[1::2].numpy(), gt[0::2].flip(2).numpy())
    # the sampler: gains in 0.5 +- 0.3, one draw a pair
    gen = torch.Generator().manual_seed(0)
    a, b = derive_darkened_views(gen, torch.from_numpy(gt_raw))
    assert a.shape == b.shape == gt_raw.shape
    d1, d2 = ttone.draw_face_darken(torch.Generator().manual_seed(0), 500,
                                    "cpu")
    for d in (d1, d2):
        assert d.shape == (500, 3)
        assert 0.2 <= float(d.min()) and float(d.max()) <= 0.8


def test_near_constant_crop_stays_finite():
    """A flat crop makes A^T A rank 1: the scale-relative ridge keeps the
    solve finite, as the reference's lstsq is."""
    flat = np.full((1, S, S, 3), 0.4, np.float32)
    flat[0, 0, 0] += 1e-4
    g = torch.tensor([[0.25, 0.5, 0.75]])
    aug, dark, ctm = ttone.face_darken_from_draws(torch.from_numpy(flat),
                                                  g, g)
    for x in (aug, dark, ctm):
        assert torch.isfinite(x).all()
    # the fit still reproduces the flat crop's tone
    want = ttone.apply_tone_curve(torch.from_numpy(flat), g)
    np.testing.assert_allclose(dark.numpy().mean(), want.numpy().mean(),
                               rtol=1e-3)
    assert all(np.isfinite(np.asarray(x)).all() for x in jtone.face_darken(
        jax.random.PRNGKey(0), jnp.asarray(flat[0])))


def test_bright_inputs_give_no_nan():
    """Pixels above 0.5 evaluate the low branch outside its domain; the
    select (not a blend) keeps its inf out of the result."""
    x = torch.linspace(0.0, 1.0, S * S * 3).reshape(1, S, S, 3)
    for g in ([0.2, 0.2, 0.2], [0.8, 0.8, 0.8], [0.2, 0.5, 0.8]):
        out = ttone.apply_tone_curve(x, torch.tensor([g]))
        assert torch.isfinite(out).all()
        aug, dark, _ = ttone.face_darken_from_draws(
            x, torch.tensor([g]), torch.tensor([g]))
        assert torch.isfinite(aug).all() and torch.isfinite(dark).all()


def test_train_step_takes_a_device_darken_batch():
    """The device_darken wire: a batch with raw crops and no img_dark runs
    the step; the pair comes from derive_darkened_views."""
    cfg = get_config("train", img_size=S, n_res=2, batch_size=1,
                     compute_dtype="float32", vgg_dtype="float32",
                     device_darken=True)
    trainer = ttrainer.Trainer(cfg, device="cpu")
    state = trainer.init_state(seed=0)
    rng = np.random.default_rng(0)
    gt = _images(3, n=1)
    batch = {"gt": np.concatenate([gt, gt[:, :, ::-1]]),
             "mask": (rng.uniform(size=(2, S, S, 1)) > 0.7).astype(
                 np.float32),
             "uv": rng.uniform(size=(2, S, S, 3)).astype(np.float32),
             "reg": rng.uniform(-0.02, 0.02, (2, S, S, 6)).astype(
                 np.float32),
             "face": rng.uniform(size=(2, S, S, 1)).astype(np.float32)}
    state, losses, figs = trainer.train_step(
        state, {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in batch.items()}, torch.Generator().manual_seed(0))
    assert state.step == 1
    assert all(torch.isfinite(v) for v in losses.values())
    assert figs["gt"].shape == (2, S, S, 3)
