"""The opt-in paths no default uses, against the JAX package on the same
inputs, on the CPU: the phase-packed convs (ops/packed.py, at
tests/test_packed.py's tolerances), the space-to-depth convs and
`ConvBlock(s2d=True)` (models/blocks.py, at tests/test_models.py's), every
generator variant with `s2d_convs`, and `norm="spec"` and `dropout` on
ConvBlock and ConvTBlock against flax."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from blindshadowremoval_tpu.config import get_config as jax_config
from blindshadowremoval_tpu.models import blocks as jb
from blindshadowremoval_tpu.ops import packed as jp
from blindshadowremoval_tpu.train.trainer import (
    build_generator as jax_build_generator,
)
from blindshadowremoval_tpu_torch.config import VARIANTS, get_config
from blindshadowremoval_tpu_torch.models import blocks as tb
from blindshadowremoval_tpu_torch.models import build_generator
from blindshadowremoval_tpu_torch.models.weights import (
    block_from_jax,
    from_jax_variables,
)
from blindshadowremoval_tpu_torch.ops import packed as tp

NCHW = (0, 3, 1, 2)
NHWC = (0, 2, 3, 1)


@pytest.fixture(autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _t(x, perm=None):
    """numpy (NHWC / HWIO as JAX holds it) -> a torch tensor, permuted."""
    return torch.from_numpy(np.ascontiguousarray(
        x if perm is None else x.transpose(perm)))


def _conv_weight(w):
    """JAX HWIO conv kernel -> nn.Conv2d's [out, in, kh, kw]."""
    return _t(w, (3, 2, 0, 1))


def _convt_weight(w):
    """JAX's [3, 3, in, out] kernel of lax.conv_transpose -> the
    nn.ConvTranspose2d weight of the same map (flipped: torch applies it as
    the gradient of a conv)."""
    return _t(w[::-1, ::-1], (2, 3, 0, 1))


def _nhwc(t):
    return t.permute(*NHWC).numpy()


def _same(x, w):
    return lax.conv_general_dilated(
        x, w, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))


# ------------------------------------------- ops/packed.py (test_packed.py)
def test_pack_unpack_roundtrip():
    rng = np.random.default_rng(0)
    x = _rand(rng, 2, 8, 10, 5)
    packed = tp.pack_image(_t(x, NCHW))
    np.testing.assert_array_equal(_nhwc(tp.unpack_image(packed, 5)), x)
    # the phase-aligned channel order of the JAX package's packing
    np.testing.assert_array_equal(_nhwc(packed),
                                  np.asarray(jp.pack_image(jnp.asarray(x))))


def test_convt_packed_matches_conv_transpose():
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 16, 12, 7)
    w = _rand(rng, 3, 3, 7, 9)
    ref = lax.conv_transpose(x, w, (2, 2), "SAME",
                             dimension_numbers=("NHWC", "HWIO", "NHWC"))
    pk = tp.convt_packed_kernel(_convt_weight(w))
    np.testing.assert_array_equal(
        pk.numpy(), np.asarray(jp.convt_packed_kernel(jnp.asarray(w))
                               ).transpose(3, 2, 0, 1))
    got = _nhwc(tp.unpack_image(tp.convt_packed(_t(x, NCHW), pk), 9))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    # and the port's own transposed conv (models/blocks.py:ConvTBlock)
    block = tb.ConvTBlock(7, 9, norm=None).eval()
    with torch.no_grad():
        block.conv.weight.copy_(_convt_weight(w))
        block.conv.bias.zero_()
        direct = tb.conv(_t(x, NCHW), block.conv)[..., :32, :24]
    np.testing.assert_allclose(got, _nhwc(direct), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k", [3, 5, 7])
def test_conv_same_packed_matches_same_conv(k):
    rng = np.random.default_rng(k)
    x = _rand(rng, 2, 16, 12, 6)
    w = _rand(rng, k, k, 6, 4)
    ref = _same(x, w)
    pk = tp.conv_same_packed_kernel(_conv_weight(w))
    np.testing.assert_array_equal(
        pk.numpy(), np.asarray(jp.conv_same_packed_kernel(jnp.asarray(w))
                               ).transpose(3, 2, 0, 1))
    got = _nhwc(tp.unpack_image(
        tp.conv_same_packed(tp.pack_image(_t(x, NCHW)), pk), 4))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_conv1x1_packed_matches_1x1():
    rng = np.random.default_rng(9)
    x = _rand(rng, 2, 16, 12, 6)
    w = _rand(rng, 1, 1, 6, 5)
    ref = _same(x, w)
    got = _nhwc(tp.unpack_image(
        tp.conv1x1_packed(tp.pack_image(_t(x, NCHW)), _conv_weight(w)), 5))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_tile_phase_matches_elementwise_affine():
    rng = np.random.default_rng(3)
    x = _rand(rng, 1, 8, 8, 6)
    scale, bias = _rand(rng, 6), _rand(rng, 6)
    ref = x * scale + bias
    tile = [tp.tile_phase(torch.from_numpy(v))[None, :, None, None]
            for v in (scale, bias)]
    got = _nhwc(tp.unpack_image(tp.pack_image(_t(x, NCHW)) * tile[0]
                                + tile[1], 6))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        tp.tile_phase(torch.from_numpy(scale)).numpy(),
        np.asarray(jp.tile_phase(jnp.asarray(scale))))


def test_concat_packed_matches_jax():
    rng = np.random.default_rng(4)
    a, b = _rand(rng, 2, 4, 6, 12), _rand(rng, 2, 4, 6, 8)
    got = tp.concat_packed(_t(a, NCHW), 3, _t(b, NCHW), 2)
    ref = jp.concat_packed(jnp.asarray(a), 3, jnp.asarray(b), 2)
    np.testing.assert_array_equal(_nhwc(got), np.asarray(ref))
    # = the packing of the unpacked channel concat
    whole = torch.cat([tp.unpack_image(_t(a, NCHW), 3),
                       tp.unpack_image(_t(b, NCHW), 2)], dim=1)
    np.testing.assert_array_equal(got.numpy(), tp.pack_image(whole).numpy())


# ------------------------------------ space-to-depth convs (test_models.py)
def test_s2d_functions_match_jax():
    rng = np.random.default_rng(5)
    w = _rand(rng, 7, 7, 3, 8)
    np.testing.assert_array_equal(
        tb.s2d_kernel(_conv_weight(w)).numpy(),
        np.asarray(jb.s2d_kernel(jnp.asarray(w))).transpose(3, 2, 0, 1))
    x = _rand(rng, 2, 10, 12, 3)
    packed = tb.s2d_pack(_t(x, NCHW), 7)
    np.testing.assert_array_equal(
        _nhwc(packed), np.asarray(jb.s2d_pack(jnp.asarray(x), 7)))
    y2 = _rand(rng, 2, 5, 6, 12)
    np.testing.assert_array_equal(
        _nhwc(tb.d2s_unpack(_t(y2, NCHW), 3)),
        np.asarray(jb.d2s_unpack(jnp.asarray(y2), 3)))


def test_space_to_depth_conv_exact():
    """space_to_depth_conv equals JAX's direct stride-1 SAME conv (its
    pieces equal JAX's bit for bit: test_s2d_functions_match_jax)."""
    rng = np.random.default_rng(0)
    for k, cin, cout, s in ((7, 3, 32, 32), (7, 64, 2, 64), (3, 3, 3, 16),
                            (5, 5, 7, 24)):
        x = _rand(rng, 2, s, s, cin)
        w = _rand(rng, k, k, cin, cout)
        b = _rand(rng, cout)
        ref = np.asarray(_same(x, w) + b)
        out = _nhwc(tb.space_to_depth_conv(
            _t(x, NCHW), _conv_weight(w), torch.from_numpy(b),
            torch.float32))
        assert np.abs(out - ref).max() < 1e-4, (k, cin, cout)
    with pytest.raises(ValueError, match="odd k and even H, W"):
        tb.space_to_depth_conv(torch.zeros(1, 3, 9, 8), torch.zeros(4, 3, 3, 3),
                               torch.zeros(4), torch.float32)


def test_s2d_convblock_param_tree_compatible():
    """The s2d block keeps the direct conv's state_dict keys, and its output
    matches the plain ConvBlock with the same state and JAX's s2d block."""
    rng = np.random.default_rng(1)
    x = _rand(rng, 1, 32, 32, 3)
    v = jb.ConvBlock(8, ksize=7, norm=None, act=False).init(
        jax.random.PRNGKey(0), jnp.asarray(x))
    ref = np.asarray(jb.ConvBlock(8, ksize=7, norm=None, act=False,
                                  s2d=True).apply(v, jnp.asarray(x)))
    sd = block_from_jax(jax.tree.map(np.asarray, v["params"]), {}, "conv")
    plain = tb.ConvBlock(3, 8, ksize=7, norm=None, act=False).eval()
    fast = tb.ConvBlock(3, 8, ksize=7, norm=None, act=False, s2d=True).eval()
    assert set(fast.state_dict()) == set(plain.state_dict()) == set(sd)
    plain.load_state_dict(sd)
    fast.load_state_dict(sd)
    with torch.no_grad():
        a, b = (_nhwc(m(_t(x, NCHW))) for m in (plain, fast))
        # an odd size or a stride takes the direct conv
        odd = _t(_rand(rng, 1, 9, 9, 3), NCHW)
        np.testing.assert_array_equal(fast(odd).numpy(), plain(odd).numpy())
    assert np.abs(a - b).max() < 1e-4
    assert np.abs(b - ref).max() < 1e-4


def _variant_inputs(variant, size=64, views=2, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.uniform(size=(views, size, size, 3)).astype(np.float32)
    uv = rng.uniform(size=(views, size, size, 3)).astype(np.float32)
    reg = rng.uniform(-0.05, 0.05, (views, size, size, 6)).astype(np.float32)
    return img, uv, reg


@pytest.mark.parametrize("variant", VARIANTS)
def test_s2d_generators_match_jax(variant):
    """Every variant with `s2d_convs` against the JAX package's at n_res=2,
    64 px, f32 (tests/test_torch_generator.py's 2e-5), and against the
    port's direct convs on the same weights."""
    kw = dict(variant=variant, img_size=64, n_res=2, compute_dtype="float32")
    cfg = get_config(s2d_convs=True, **kw)
    assert cfg.s2d_convs
    jgen = jax_build_generator(jax_config(s2d_convs=True, **kw))
    img, uv, reg = _variant_inputs(variant)
    fkw = dict(frame=2) if variant == "tsm" else {}
    variables = jax.tree.map(np.asarray, jax.jit(
        lambda k: jgen.init(k, img, uv, reg, **fkw))(jax.random.PRNGKey(0)))
    ref = jgen.apply(variables, img, uv, reg, **fkw)
    sd = from_jax_variables(variables)
    outs = []
    for c in (cfg, get_config(**kw)):
        model = build_generator(c, sd, device="cpu")
        assert model.conv1.s2d == c.s2d_convs
        targs = (torch.from_numpy(img), torch.from_numpy(uv))
        with torch.no_grad():
            out = (model(*targs, torch.from_numpy(reg), **fkw)
                   if variant == "tsm" else model(*targs))
        outs.append([o.numpy() for o in (
            (out,) if variant == "rgb" else out)])
    ref = [np.asarray(r) for r in ((ref,) if variant == "rgb" else ref)]
    for s2d, direct, r in zip(*outs, ref):
        np.testing.assert_allclose(s2d, r, atol=2e-5)
        np.testing.assert_allclose(s2d, direct, atol=2e-5)


# -------------------------------------------------- spectral norm, dropout
def _spec_pair(kind, rng):
    """(flax block, port block, input NHWC, flax variables) with spec norm,
    the flax state carried over by models/weights.py."""
    if kind == "conv":
        fb, pb = jb.ConvBlock(6, ksize=3, norm="spec"), tb.ConvBlock(
            4, 6, ksize=3, norm="spec")
    else:
        fb, pb = jb.ConvTBlock(6, norm="spec"), tb.ConvTBlock(4, 6,
                                                             norm="spec")
    x = _rand(rng, 2, 8, 8, 4)
    v = jax.tree.map(np.asarray, fb.init(jax.random.PRNGKey(3),
                                         jnp.asarray(x)))
    v["params"][next(iter(v["params"]))]["bias"] = _rand(rng, 6)
    pb.load_state_dict(block_from_jax(v["params"], v["batch_stats"], "conv"))
    return fb, pb, x, v


@pytest.mark.parametrize("kind", ["conv", "convt"])
def test_spectral_norm_matches_flax(kind):
    rng = np.random.default_rng(6)
    fb, pb, x, v = _spec_pair(kind, rng)
    assert set(pb.state_dict()) == {"conv.weight", "conv.bias", "sn.u",
                                    "sn.sigma"}
    sn = v["batch_stats"]["SpectralNorm_0"]
    u0 = pb.sn.u.clone()
    # eval: one power iteration from the stored u, nothing stored
    ref = np.asarray(fb.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        got = _nhwc(pb.eval()(_t(x, NCHW)))
    np.testing.assert_allclose(got, ref, atol=2e-5)
    torch.testing.assert_close(pb.sn.u, u0, rtol=0, atol=0)
    # train: the new u and sigma stored, twice in a row
    for _ in range(2):
        ref, upd = fb.apply(v, jnp.asarray(x), train=True,
                            mutable=["batch_stats"])
        with torch.no_grad():
            got = _nhwc(pb.train()(_t(x, NCHW)))
        np.testing.assert_allclose(got, np.asarray(ref), atol=2e-5)
        v = {**v, "batch_stats": jax.tree.map(np.asarray,
                                              upd["batch_stats"])}
        sn = v["batch_stats"]["SpectralNorm_0"]
        for key, value in sn.items():
            mine = getattr(pb.sn, key.rsplit("/", 1)[-1])
            np.testing.assert_allclose(mine.numpy(), value, rtol=1e-5,
                                       atol=1e-7, err_msg=key)
    # sigma carries the gradient, u and v do not: the weight's gradient
    # through the normalized kernel, against JAX's
    def loss(params):
        out = fb.apply({"params": params, "batch_stats": v["batch_stats"]},
                       jnp.asarray(x))
        return jnp.sum(out ** 2)

    grad = jax.grad(loss)(v["params"])
    pb.load_state_dict(block_from_jax(v["params"], v["batch_stats"], "conv"))
    pb.eval()
    pb.zero_grad()
    (pb(_t(x, NCHW)) ** 2).sum().backward()
    want = grad[next(iter(grad))]["kernel"]
    want = (_conv_weight(np.asarray(want)) if kind == "conv"
            else _convt_weight(np.asarray(want)))
    torch.testing.assert_close(pb.conv.weight.grad, want, rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("kind", ["conv", "convt"])
def test_dropout_matches_flax(kind):
    """Eval: no dropout, as flax's deterministic=True.  Train: flax's rate
    0.3 and 1/0.7 scaling of what is kept (the draws differ by framework:
    held by distribution)."""
    rng = np.random.default_rng(7)
    if kind == "conv":
        fb = jb.ConvBlock(16, ksize=3, norm=None, dropout=True)
        pb = tb.ConvBlock(4, 16, ksize=3, norm=None, dropout=True)
    else:
        fb = jb.ConvTBlock(16, norm=None, dropout=True)
        pb = tb.ConvTBlock(4, 16, norm=None, dropout=True)
    x = _rand(rng, 2, 16, 16, 4)
    v = jax.tree.map(np.asarray, fb.init(jax.random.PRNGKey(0),
                                         jnp.asarray(x)))
    pb.load_state_dict(block_from_jax(v["params"], {}, "conv"))
    ref = np.asarray(fb.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        plain = pb.eval()(_t(x, NCHW))
        np.testing.assert_allclose(_nhwc(plain), ref, atol=2e-5)
        torch.manual_seed(0)
        dropped = pb.train()(_t(x, NCHW))
    flax_train = np.asarray(fb.apply(v, jnp.asarray(x), train=True,
                                     rngs={"dropout": jax.random.PRNGKey(1)}))
    for out, base in ((_nhwc(dropped), _nhwc(plain)), (flax_train, ref)):
        kept = out != 0
        assert abs(1.0 - kept.mean() - tb.DROPOUT_RATE) < 0.02
        np.testing.assert_allclose(out[kept], base[kept] / 0.7, rtol=1e-6)
