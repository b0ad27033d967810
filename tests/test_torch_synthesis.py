"""Port's shadow synthesis (ops/perlin.py, ops/svblur.py, ops/ssscatter.py,
data/synthesis.py) against the JAX package.

The port's cores take their random draws as inputs.  These tests replay the
JAX package's PRNG key splits to recover the exact draws a JAX call makes,
feed them to the port, and compare the outputs: the deterministic parts
must agree to float rounding.  The port's own draws (a torch.Generator) can
only agree in distribution, which the last test checks.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blindshadowremoval_tpu.data.synthesis import compose_shadow_image
from blindshadowremoval_tpu.ops.ssscatter import apply_ss_shadow_map
from blindshadowremoval_tpu.ops.svblur import spatially_varying_blur
from blindshadowremoval_tpu_torch.data import synthesis as tsyn
from blindshadowremoval_tpu_torch.ops import perlin as tperlin
from blindshadowremoval_tpu_torch.ops import ssscatter as tss
from blindshadowremoval_tpu_torch.ops import svblur as tsv

# the JAX ops package re-exports a function named `perlin` over the module
jperlin = importlib.import_module("blindshadowremoval_tpu.ops.perlin")

S = 64


# ------------------------------------------------- JAX draws, replayed
def _u(key, lo=0.0, hi=1.0):
    return np.float32(jax.random.uniform(key, (), minval=lo, maxval=hi))


def _angles(key, reso, octaves):
    """The angles perlin_collection(key, size, (reso, reso), octaves)
    draws, one [r+1, r+1] array per octave."""
    keys = jax.random.split(key, octaves)
    return [np.asarray(2.0 * jnp.pi * jax.random.uniform(
        keys[i], (reso * 2 ** i + 1, reso * 2 ** i + 1)))
        for i in range(octaves)]


def _brightness_draws(key, min_val):
    k1, k2 = jax.random.split(key)
    return {"min_val": np.float32(min_val), "pers": _u(k1, 0.05, 0.25),
            "angles": _angles(k2, 2, 2)}


def _sv_draws(key):
    k1, k2 = jax.random.split(key)
    return {"pers": _u(k1, 0.05, 0.25), "angles": _angles(k2, 2, 1)}


def _perlin_mask_draws(key):
    k1, k2, k3, k4, k5, k6 = jax.random.split(key, 6)
    return {"pers": _u(k1, 0.05, 0.85), "angles": _angles(k2, 4, 4),
            "disc_r": np.int64(jax.random.randint(k3, (), 1, 12)),
            "sv_size": np.int64(jax.random.randint(k4, (), 1, 3)),
            "use_sv": bool(jax.random.uniform(k5) > 0.5),
            "sv": _sv_draws(k6)}


def _ss_draws(key):
    k1, k2 = jax.random.split(key)
    keys = jax.random.split(k2, 6)
    return {"scale": _u(k1, 1.0, 15.0),
            "rgain": np.array([_u(k, 1.1, 1.5) for k in keys], np.float32)}


def _compose_draws(key):
    k1, k2, k3, k4, k5, k6, k7 = jax.random.split(key, 7)
    low = bool(jax.random.uniform(k5) > 0.5)
    return {"keep_ext": bool(jax.random.uniform(k1) > 0.4),
            "perlin": _perlin_mask_draws(k2),
            "use_ss": bool(jax.random.uniform(k3) > 0.25),
            "ss": _ss_draws(k4),
            "brightness": _brightness_draws(k6 if low else k7,
                                            0.3 if low else 0.5)}


def _stack(draws):
    """Per-sample draw dicts -> one batched dict of tensors."""
    first = draws[0]
    if isinstance(first, dict):
        return {k: _stack([d[k] for d in draws]) for k in first}
    if isinstance(first, list):
        return [_stack([d[i] for d in draws]) for i in range(len(first))]
    return torch.from_numpy(np.stack([np.asarray(d) for d in draws]))


# ------------------------------------------------------------- tests
@pytest.mark.parametrize("reso", [2, 4, 32])
def test_perlin_octave(reso):
    key = jax.random.PRNGKey(reso)
    ref = np.asarray(jperlin.perlin(key, (S, S), (reso, reso)))
    # perlin draws from `key` itself (perlin_collection splits first)
    angles = [np.asarray(2.0 * jnp.pi * jax.random.uniform(
        key, (reso + 1, reso + 1)))]
    out = tperlin.perlin(_stack([angles[0]]), (S, S))[0].numpy()
    # cos/sin and the fade polynomial in f32 on both sides
    np.testing.assert_allclose(out, ref, atol=2e-6)


def test_perlin_collection():
    key = jax.random.PRNGKey(3)
    ref = np.asarray(jperlin.perlin_collection(key, (S, S), (4, 4), 4,
                                               jnp.float32(0.6)))
    out = tperlin.perlin_collection(
        [torch.tensor(a)[None] for a in _angles(key, 4, 4)], (S, S),
        torch.tensor([0.6]))[0].numpy()
    np.testing.assert_allclose(out, ref, atol=4e-6)


@pytest.mark.parametrize("min_val", [0.3, 0.5])
def test_brightness_mask(min_val):
    key = jax.random.PRNGKey(11)
    ref = np.asarray(jperlin.brightness_mask(key, (S, S), min_val=min_val))
    out = tperlin.brightness_mask(_stack([_brightness_draws(key, min_val)]),
                                  (S, S))[0].numpy()
    np.testing.assert_allclose(out, ref, atol=2e-6)


def test_spatially_varying_blur(rng):
    key = jax.random.PRNGKey(5)
    img = (rng.uniform(size=(S, S, 1)) > 0.5).astype(np.float32)
    ref = np.asarray(spatially_varying_blur(key, jnp.asarray(img), 2))
    out = tsv.spatially_varying_blur(_stack([_sv_draws(key)]),
                                     torch.from_numpy(img)[None],
                                     torch.tensor([2]))[0].numpy()
    np.testing.assert_allclose(out, ref, atol=4e-6)


def _keys_covering(n, draw, flags):
    """A seed whose n keys (one split) take both values of every flag."""
    for seed in range(100):
        keys = jax.random.split(jax.random.PRNGKey(seed), n)
        draws = [draw(k) for k in keys]
        if all(len({f(d) for d in draws}) == 2 for f in flags):
            return keys, draws
    raise AssertionError("no covering seed")


def test_render_perlin_mask_both_branches():
    keys, draws = _keys_covering(4, _perlin_mask_draws,
                                 [lambda d: d["use_sv"]])
    out = tperlin.render_perlin_mask(_stack(draws), (S, S)).numpy()
    for i, k in enumerate(keys):
        ref = np.asarray(jperlin.render_perlin_mask(k, (S, S)))
        # the 0.15 threshold sees the same noise to ~1e-6, so the same
        # binary mask; the blurs then differ at float rounding
        np.testing.assert_allclose(out[i], ref, atol=1e-5,
                                   err_msg=f"sample {i}, sv "
                                           f"{draws[i]['use_sv']}")


def test_apply_ss_shadow_map(rng):
    # 64 px, so the widest levels' reflect pads (64, 96) exceed the image
    key = jax.random.PRNGKey(9)
    mask = (rng.uniform(size=(S, S, 1)) > 0.6).astype(np.float32)
    ref = np.asarray(apply_ss_shadow_map(key, jnp.asarray(mask)))
    out = tss.apply_ss_shadow_map(_stack([_ss_draws(key)]),
                                  torch.from_numpy(mask)[None])[0].numpy()
    np.testing.assert_allclose(out, ref, atol=4e-6)


def test_compose_shadow_image_matches_jax(rng):
    b = 6
    flags = [lambda d: d["keep_ext"], lambda d: d["use_ss"],
             lambda d: d["brightness"]["min_val"] < 0.4,
             lambda d: d["perlin"]["use_sv"]]
    # the keys vmap hands each sample are split(key, b)
    for seed in range(200):
        key = jax.random.PRNGKey(seed)
        draws = [_compose_draws(k) for k in jax.random.split(key, b)]
        if all(len({f(d) for d in draws if d is not None}) == 2
               for f in flags[:3]) and any(
                   not d["keep_ext"] and d["perlin"]["use_sv"]
                   for d in draws):
            break
    else:
        raise AssertionError("no seed covers every branch")
    mask = (rng.uniform(size=(b, S, S, 1)) > 0.5).astype(np.float32)
    face = rng.uniform(size=(b, S, S, 1)).astype(np.float32)
    gt = rng.uniform(size=(b, S, S, 3)).astype(np.float32)
    dark = (0.5 * gt).astype(np.float32)
    ref = jax.jit(compose_shadow_image)(key, *map(jnp.asarray,
                                                  (mask, gt, dark, face)))
    out = tsyn.compose_from_draws(_stack(draws), *map(
        torch.from_numpy, (mask, gt, dark, face)))
    for name, a, r in zip(("img", "mask_sv", "mask_edge"), out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=2e-5,
                                   err_msg=name)


def test_port_draws_match_in_distribution():
    gen = torch.Generator().manual_seed(0)
    n = 4000
    d = tsyn.draw_compose(gen, n, "cpu")
    # the gates' probabilities (synthesis.py:79-95, perlin.py:103-108),
    # within ~4 standard errors at n = 4000
    for got, p in ((d["keep_ext"], 0.6), (d["use_ss"], 0.75),
                   (d["brightness"]["min_val"] == 0.3, 0.5),
                   (d["perlin"]["use_sv"], 0.5)):
        assert abs(got.float().mean().item() - p) < 0.035
    pm, ss, br = d["perlin"], d["ss"], d["brightness"]
    assert set(pm["disc_r"].unique().tolist()) == set(range(1, 12))
    assert set(pm["sv_size"].unique().tolist()) == {1, 2}
    for t, lo, hi in ((pm["pers"], 0.05, 0.85), (pm["sv"]["pers"], 0.05, 0.25),
                      (br["pers"], 0.05, 0.25), (ss["scale"], 1.0, 15.0),
                      (ss["rgain"], 1.1, 1.5)):
        assert lo <= t.min().item() and t.max().item() < hi
        assert abs(t.mean().item() - (lo + hi) / 2) < 0.02 * (hi - lo) + 1e-3
    assert [a.shape[1:] for a in pm["angles"]] == [(5, 5), (9, 9), (17, 17),
                                                   (33, 33)]
    assert [a.shape[1:] for a in br["angles"]] == [(3, 3), (5, 5)]
    img, mask_sv, edge = tsyn.compose_shadow_image(
        torch.Generator().manual_seed(1), torch.zeros(4, 32, 32, 1),
        torch.rand(4, 32, 32, 3), torch.rand(4, 32, 32, 3),
        torch.ones(4, 32, 32, 1))
    assert img.shape == mask_sv.shape == edge.shape == (4, 32, 32, 3)
    assert 0.0 <= img.min().item() and img.max().item() <= 1.0
