"""The train step's models and losses in the port against the JAX package:
losses (train/losses.py), the discriminators (models/discriminator.py),
VGG-19 (models/vgg.py), train-mode BatchNorm with Flax's running update,
the generator's train-mode forward and gradient, and mixed precision
(f32 parameters and statistics, bf16 compute)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blindshadowremoval_tpu.models import blocks as jb
from blindshadowremoval_tpu.models.discriminator import (
    MultiScaleDiscriminators as JaxDiscs,
)
from blindshadowremoval_tpu.models.generator import GSCGenerator as JaxGSC
from blindshadowremoval_tpu.models.vgg import VGG19Features as JaxVGG
from blindshadowremoval_tpu.models.vgg import preprocess as jax_preprocess
from blindshadowremoval_tpu.train import losses as jl
from blindshadowremoval_tpu_torch.config import get_config
from blindshadowremoval_tpu_torch.models import blocks as tb
from blindshadowremoval_tpu_torch.models import build_generator
from blindshadowremoval_tpu_torch.models.discriminator import (
    MultiScaleDiscriminators,
)
from blindshadowremoval_tpu_torch.models.generator import GSCGenerator
from blindshadowremoval_tpu_torch.models.vgg import (
    VGG19Features,
    load_weights_npz,
    preprocess,
)
from blindshadowremoval_tpu_torch.models.weights import (
    block_from_jax,
    discriminator_from_jax,
    from_jax_variables,
    vgg_from_jax,
)
from blindshadowremoval_tpu_torch.train import losses as tl


def _t(x):
    return torch.tensor(np.asarray(x, np.float32))


def _np(tree):
    return jax.tree.map(np.array, tree)


# --------------------------------------------------------------- losses
@pytest.fixture
def images(rng):
    s = 32
    pred = rng.uniform(size=(2, s, s, 3)).astype(np.float32)
    gt = rng.uniform(size=(2, s, s, 3)).astype(np.float32)
    gs = rng.uniform(size=(2, s, s, 1)).astype(np.float32)
    mask_bi = (rng.uniform(size=(2, s, s, 3)) > 0.6).astype(np.float32)
    mask_edge = (rng.uniform(size=(2, s, s, 1)) > 0.8).astype(np.float32)
    return pred, gt, gs, mask_bi, mask_edge


@pytest.mark.parametrize("name", ["l1_loss", "l2_loss", "l1_loss_yuv",
                                  "l2_loss_yuv", "l1_loss_hsv"])
@pytest.mark.parametrize("masked", [False, True])
def test_pixel_losses(images, name, masked):
    pred, gt, _, mask_bi, _ = images
    args = (pred, gt) + ((mask_bi,) if masked else ())
    ref = float(getattr(jl, name)(*map(jnp.asarray, args)))
    out = float(getattr(tl, name)(*map(_t, args)))
    # f32 sums over 6k pixels in another order
    np.testing.assert_allclose(out, ref, rtol=2e-6)


def test_hinge_and_perceptual_losses(rng):
    logits = rng.normal(size=(2, 4, 4, 1)).astype(np.float32)
    for y in (1.0, -1.0):
        np.testing.assert_allclose(float(tl.hinge_loss(_t(logits), y)),
                                   float(jl.hinge_loss(jnp.asarray(logits), y)),
                                   rtol=1e-6)
    real = [rng.normal(size=(2, 8, 8, c)).astype(np.float32) for c in (4, 8)]
    fake = [rng.normal(size=(2, 8, 8, c)).astype(np.float32) for c in (4, 8)]
    np.testing.assert_allclose(
        float(tl.style_content_loss_pair(list(map(_t, real)),
                                         list(map(_t, fake)))),
        float(jl.style_content_loss_pair(list(map(jnp.asarray, real)),
                                         list(map(jnp.asarray, fake)))),
        rtol=1e-6)


@pytest.mark.parametrize("scale", [1, 2, 4, 8, 16])
def test_get_img_grad(images, scale):
    pred = images[0]
    np.testing.assert_allclose(
        tl.get_img_grad(_t(pred), scale).numpy(),
        np.asarray(jl.get_img_grad(jnp.asarray(pred), scale)), atol=2e-6)


def test_gradient_and_reconstruction_losses(images):
    pred, gt, gs, mask_bi, mask_edge = images
    gray = gt[..., :1]
    np.testing.assert_allclose(
        float(tl.multi_scale_gradient_loss(*map(_t, (pred, gt, mask_bi,
                                                     mask_edge)))),
        float(jl.multi_scale_gradient_loss(*map(jnp.asarray, (
            pred, gt, mask_bi, mask_edge)))), rtol=2e-6)
    for a, b in zip(
            tl.reconstruction_losses(*map(_t, (gs, pred, gt, gray, mask_bi,
                                                mask_edge))),
            jl.reconstruction_losses(*map(jnp.asarray, (
                gs, pred, gt, gray, mask_bi, mask_edge)))):
        np.testing.assert_allclose(float(a), float(b), rtol=2e-6)


def test_gradient_loss_backward_through_the_resizes(images):
    # the gradient loss's backward runs the resize matrices transposed
    pred, gt, _, mask_bi, mask_edge = images
    args = (gt, mask_bi, mask_edge)
    ref = jax.grad(lambda p: jl.multi_scale_gradient_loss(
        p, *map(jnp.asarray, args)))(jnp.asarray(pred))
    x = _t(pred).requires_grad_()
    tl.multi_scale_gradient_loss(x, *map(_t, args)).backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=1e-5)


# --------------------------------------------------- BatchNorm, train mode
def _randomize_stats(variables, rng):
    """Non-trivial running statistics, so the update is visible."""
    def walk(node):
        for name, child in node.items():
            if name.startswith("BatchNorm_"):
                c = child["mean"].shape
                child["mean"] = rng.normal(0, 0.1, c).astype(np.float32)
                child["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            elif isinstance(child, dict):
                walk(child)
    variables = _np(variables)
    walk(variables.get("batch_stats", {}))
    return variables


@pytest.mark.parametrize("stride,b,s", [(1, 2, 8), (2, 4, 2)])
def test_conv_block_train_mode_running_update(rng, stride, b, s):
    # (4, 2x2, stride 2) leaves one pixel per view: 4 values per channel,
    # where the unbiased variance would be 4/3 of the biased one
    x = rng.normal(size=(b, s, s, 5)).astype(np.float32)
    flax_block = jb.ConvBlock(6, ksize=3, stride=stride)
    variables = _randomize_stats(flax_block.init(jax.random.PRNGKey(0),
                                                 jnp.asarray(x)), rng)
    ref, new = flax_block.apply(variables, jnp.asarray(x), train=True,
                                mutable=["batch_stats"])
    block = tb.ConvBlock(5, 6, ksize=3, stride=stride)
    block.load_state_dict(block_from_jax(variables["params"],
                                         variables["batch_stats"], "conv"))
    block.train()
    out = block(_t(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), atol=2e-5)
    stats = new["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(block.bn.running_mean.numpy(),
                               np.asarray(stats["mean"]), atol=1e-6)
    np.testing.assert_allclose(block.bn.running_var.numpy(),
                               np.asarray(stats["var"]), rtol=1e-5)


def test_frozen_stats_keeps_running_statistics(rng):
    block = tb.ConvBlock(3, 4).train()
    before = block.bn.running_var.clone()
    x = torch.tensor(rng.normal(size=(2, 3, 8, 8)).astype(np.float32))
    with tb.frozen_stats(block):
        y = block(x)
    torch.testing.assert_close(block.bn.running_var, before, rtol=0, atol=0)
    assert block.bn.update_stats
    torch.testing.assert_close(y, block(x), rtol=0, atol=0)   # batch stats
    assert not torch.equal(block.bn.running_var, before)


# -------------------------------------------------------- discriminators
@pytest.mark.parametrize("train", [False, True])
def test_discriminators_match_jax(rng, train):
    x = rng.uniform(size=(4, 32, 32, 6)).astype(np.float32)
    jd = JaxDiscs()
    variables = _randomize_stats(jax.jit(jd.init)(jax.random.PRNGKey(1),
                                                  jnp.asarray(x)), rng)
    if train:
        ref, new = jd.apply(variables, jnp.asarray(x), train=True,
                            mutable=["batch_stats"])
    else:
        ref = jd.apply(variables, jnp.asarray(x))
    disc = MultiScaleDiscriminators()
    disc.load_state_dict(discriminator_from_jax(variables))
    disc.train(train)
    with torch.no_grad():
        out = disc(_t(x))
    for (r, f), (jr, jf) in zip(out, ref):
        np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=3e-5)
        np.testing.assert_allclose(f.numpy(), np.asarray(jf), atol=3e-5)
    if train:
        got = discriminator_from_jax({"params": variables["params"],
                                      "batch_stats": new["batch_stats"]})
        sd = disc.state_dict()
        for name in got:
            if name.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(sd[name].numpy(),
                                           got[name].numpy(), rtol=1e-4,
                                           atol=1e-6, err_msg=name)


# ------------------------------------------------------------------ VGG
def test_vgg_matches_jax(rng):
    x = rng.uniform(size=(2, 32, 32, 3)).astype(np.float32)
    jv = JaxVGG(dtype=jnp.float32)
    params = _np(jax.jit(jv.init)(jax.random.PRNGKey(2),
                                  jnp.asarray(x)))["params"]
    ref = jv.apply({"params": params}, jax_preprocess(jnp.asarray(x)))
    vgg = VGG19Features()
    vgg.load_state_dict(vgg_from_jax(params))
    np.testing.assert_allclose(preprocess(_t(x)).numpy(),
                               np.asarray(jax_preprocess(jnp.asarray(x))),
                               atol=1e-5)
    with torch.no_grad():
        out = vgg(preprocess(_t(x)))
    assert len(out) == 5
    for a, b in zip(out, ref):
        scale = float(np.abs(np.asarray(b)).max())
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   atol=2e-5 * scale)
    assert not any(p.requires_grad for p in vgg.parameters())


def test_vgg_load_weights_npz(tmp_path, rng):
    vgg = VGG19Features()
    arrays = {}
    for name, mod in vgg.convs.items():
        o, i, kh, kw = mod.weight.shape
        arrays[f"{name}/kernel"] = rng.normal(size=(kh, kw, i, o)).astype(
            np.float32)
        arrays[f"{name}/bias"] = rng.normal(size=(o,)).astype(np.float32)
    arrays["block5_conv2/kernel"] = np.zeros((3, 3, 512, 512), np.float32)
    np.savez(tmp_path / "vgg.npz", **arrays)
    sd = load_weights_npz(str(tmp_path / "vgg.npz"))
    vgg.load_state_dict(sd)
    k = arrays["block2_conv1/kernel"]
    np.testing.assert_array_equal(vgg.convs["block2_conv1"].weight.numpy(),
                                  k.transpose(3, 2, 0, 1))


# ------------------------------------------------------------- generator
@pytest.fixture(scope="module")
def gen_setup():
    s, b = 32, 2
    rng = np.random.default_rng(0)
    img = rng.uniform(size=(b, s, s, 3)).astype(np.float32)
    uv = rng.uniform(size=(b, s, s, 3)).astype(np.float32)
    reg = np.zeros((b, s, s, 6), np.float32)
    jg = JaxGSC(n_res=2)
    variables = _randomize_stats(jax.jit(jg.init)(
        jax.random.PRNGKey(0), img, uv, reg), rng)
    return jg, variables, img, uv, reg


def _weighted_sum(outs, weights):
    return sum((o * w).sum() for o, w in zip(outs, weights))


def test_generator_train_forward_and_grad_match_jax(gen_setup):
    jg, variables, img, uv, reg = gen_setup
    rng = np.random.default_rng(1)
    weights = [rng.normal(size=(2, 32, 32, c)).astype(np.float32)
               for c in (1, 3, 3, 1)]

    def loss(params):
        outs, new = jg.apply({"params": params,
                              "batch_stats": variables["batch_stats"]},
                             img, uv, reg, train=True,
                             mutable=["batch_stats"])
        return _weighted_sum(outs, weights), (outs, new)

    (ref_loss, (ref_outs, new)), ref_grads = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(variables["params"])

    gen = GSCGenerator(n_res=2).train()
    gen.load_state_dict(from_jax_variables(variables))
    outs = gen(_t(img), _t(uv), _t(reg))
    total = _weighted_sum(outs, map(_t, weights))
    total.backward()
    for a, b in zip(outs, ref_outs):
        # f32; train-mode BatchNorm over 32 values a channel at the 4x4
        # bottleneck amplifies the convolutions' summation-order noise:
        # measured 9e-5 on outputs of up to ~3
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=2e-4)
    np.testing.assert_allclose(float(total.detach()), float(ref_loss),
                               rtol=1e-4)
    want = from_jax_variables({"params": _np(ref_grads),
                               "batch_stats": variables["batch_stats"]})
    got = {n: p.grad for n, p in gen.named_parameters()}
    top = max(float(want[n].abs().max()) for n in got)
    for name, g in got.items():
        w = want[name]
        if float(w.abs().max()) < 1e-5 * top:
            # a bias feeding a train-mode BatchNorm (or phi/g's, which the
            # softmax or the next BatchNorm cancels): zero in exact
            # arithmetic, rounding noise on both sides
            assert float(g.abs().max()) < 1e-5 * top, name
            continue
        # f32 through ~45 layers forward and backward, XLA and ATen summing
        # in other orders, amplified by train-mode BatchNorm over 2 views:
        # measured at most 1.6e-3 relative (Frobenius)
        err = float((g - w).norm() / w.norm())
        assert err < 5e-3, f"{name}: relative error {err:.2e}"
    stats = from_jax_variables({"params": variables["params"],
                                "batch_stats": _np(new["batch_stats"])})
    sd = gen.state_dict()
    for name in stats:
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[name].numpy(), stats[name].numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=name)


def test_remat_matches_plain_and_updates_stats_once(gen_setup):
    _, variables, img, uv, reg = gen_setup
    runs = []
    for remat in (False, True):
        gen = GSCGenerator(n_res=2, remat=remat).train()
        gen.load_state_dict(from_jax_variables(variables))
        outs = gen(_t(img), _t(uv), _t(reg))
        sum(o.sum() for o in outs).backward()
        runs.append((gen.state_dict(),
                     {n: p.grad for n, p in gen.named_parameters()}))
    (sd0, g0), (sd1, g1) = runs
    for name in sd0:
        torch.testing.assert_close(sd1[name], sd0[name], rtol=0, atol=0,
                                   msg=name)
    for name in g0:
        torch.testing.assert_close(g1[name], g0[name], rtol=1e-5, atol=1e-6,
                                   msg=name)


def test_unfolded_bf16_forward_matches_jax():
    s, b = 64, 2
    rng = np.random.default_rng(2)
    img = rng.uniform(size=(b, s, s, 3)).astype(np.float32)
    uv = rng.uniform(size=(b, s, s, 3)).astype(np.float32)
    reg = np.zeros((b, s, s, 6), np.float32)
    jg = JaxGSC(n_res=2, dtype=jnp.bfloat16)
    variables = _randomize_stats(jax.jit(jg.init)(
        jax.random.PRNGKey(3), img, uv, reg), rng)
    ref = jax.jit(jg.apply)(variables, img, uv, reg)
    cfg = get_config(n_res=2, compute_dtype="bfloat16", fold_bn=False)
    model = build_generator(cfg, from_jax_variables(variables), device="cpu")
    for name, buf in model.named_buffers():
        if "running" in name:
            assert buf.dtype == torch.float32, name
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with torch.no_grad():
        outs = model(_t(img), _t(uv), _t(reg))
    for name, a, r in zip(("gs", "con_rgb", "mask22", "dif"), outs, ref):
        a, r = a.float().numpy(), np.asarray(r, np.float32)
        # bf16 activations through ~45 layers: each framework rounds every
        # conv output to bf16 (2^-9 relative) after summing in its own
        # order; outputs of O(1) agree to a few bf16 ulps, 5e-2 at most
        np.testing.assert_allclose(a, r, atol=5e-2, err_msg=name)
        assert np.abs(a - r).mean() < 4e-3, name
