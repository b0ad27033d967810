"""The port's int8 output head (ops/quant.py, ops/calibration.py, the int8
path of models/blocks.py:ConvBlock and the generators' int8 options)
against the JAX package on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blindshadowremoval_tpu.config import get_config as jax_config
from blindshadowremoval_tpu.models.generator import GSCGenerator as JaxGSC
from blindshadowremoval_tpu.models.generator_tsm import TSMGenerator as JaxTSM
from blindshadowremoval_tpu.ops import calibration as jax_calibration
from blindshadowremoval_tpu.ops import quant as jax_quant
from blindshadowremoval_tpu_torch.config import get_config
from blindshadowremoval_tpu_torch.models import build_generator
from blindshadowremoval_tpu_torch.models.blocks import ConvBlock
from blindshadowremoval_tpu_torch.models.weights import from_jax_variables
from blindshadowremoval_tpu_torch.ops import calibration, quant

OUT_NAMES = ("gs", "con_rgb", "mask22", "dif")
C_IN = 16
SCALES = {"dynamic": 0.0, "dynamic negative": -1.0, "scalar": 2.5,
          "per channel": tuple(float(b) for b in np.random.default_rng(7)
                               .uniform(1.0, 3.0, C_IN))}


@pytest.fixture(autouse=True)
def two_threads():
    """Six test workers share the machine: a wide thread pool in each
    costs more than it saves."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _conv_inputs(k=7, cout=2, seed=0):
    """NHWC x, HWIO w and a bias, as the JAX package takes them: the
    head's 7x7 kernel to 2 channels on 16 input channels."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 1.0, (2, 15, 14, C_IN)).astype(np.float32)
    x[0, 3, 4, 5] = 4.0     # beyond the scalar and per-channel bounds
    w = (0.1 * rng.normal(size=(k, k, C_IN, cout))).astype(np.float32)
    b = rng.normal(size=(cout,)).astype(np.float32)
    return x, w, b


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _oihw(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


def _jax_codes(x, w, static_scale, stride):
    """JAX int8_conv's codes, kernel and int32 accumulators, by the steps
    of ops/quant.py:int8_conv (JAX computes them inside one function)."""
    xf, w = jnp.asarray(x, jnp.float32), jnp.asarray(w, jnp.float32)
    if isinstance(static_scale, tuple):
        x_scale = jnp.asarray(static_scale, jnp.float32) / 127.0 + 1e-12
        xq = jnp.clip(jnp.round(xf / x_scale), -127, 127).astype(jnp.int8)
        wq, _ = jax_quant.quantize_weight(w * x_scale[None, None, :, None])
    else:
        if static_scale > 0.0:
            x_scale = jnp.asarray(static_scale / 127.0, jnp.float32)
        else:
            x_scale = jnp.max(jnp.abs(xf), axis=(1, 2, 3),
                              keepdims=True) / 127.0 + 1e-12
        xq = jnp.clip(jnp.round(xf / x_scale), -127, 127).astype(jnp.int8)
        wq, _ = jax_quant.quantize_weight(w)
    acc = jax.lax.conv_general_dilated(
        xq, wq, (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    return np.asarray(xq), np.asarray(wq), np.asarray(acc)


def test_quantize_weight_matches_jax():
    w = _conv_inputs()[1]
    wq_j, s_j = (np.asarray(a) for a in jax_quant.quantize_weight(
        jnp.asarray(w)))
    wq, s = quant.quantize_weight(_oihw(w))
    assert wq.dtype == torch.int8
    np.testing.assert_array_equal(wq.numpy().transpose(2, 3, 1, 0), wq_j)
    np.testing.assert_array_max_ulp(s.numpy(), s_j, maxulp=1)


@pytest.mark.parametrize("mode", list(SCALES))
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("with_bias", [True, False])
def test_int8_conv_matches_jax(mode, stride, with_bias):
    """Identical int8 codes and int32 accumulators, outputs within 1 f32
    ulp of JAX's, in every activation mode, stride and bias."""
    x, w, b = _conv_inputs()
    scale = SCALES[mode]
    xq_j, wq_j, acc_j = _jax_codes(x, w, scale, stride)
    xq, wq, out_scale = quant.quantize_activations(_nchw(x), _oihw(w), scale)
    np.testing.assert_array_equal(xq.numpy().transpose(0, 2, 3, 1), xq_j)
    np.testing.assert_array_equal(wq.numpy().transpose(2, 3, 1, 0), wq_j)
    acc = quant.int8_accumulate(xq, wq, stride)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy().transpose(0, 2, 3, 1), acc_j)
    # and the plain version (an exact f64 convolution of the codes)
    assert torch.equal(quant.int8_accumulate_reference(xq, wq, stride), acc)

    bias = b if with_bias else None
    want = np.asarray(jax_quant.int8_conv(
        jnp.asarray(x), jnp.asarray(w),
        None if bias is None else jnp.asarray(bias), stride, "SAME", scale))
    got = quant.int8_conv(_nchw(x), _oihw(w),
                          None if bias is None else torch.from_numpy(bias),
                          stride, scale)
    assert got.dtype == torch.float32
    np.testing.assert_array_max_ulp(got.numpy().transpose(0, 2, 3, 1), want,
                                    maxulp=1)


@pytest.mark.parametrize("mode", ["dynamic", "scalar", "per channel"])
@pytest.mark.parametrize("stride", [1, 2])
def test_int8_conv_gradients_match_jax_vjp(mode, stride):
    """The straight-through backward: the float convolution's gradients,
    within 1e-6 (of the largest) of jax.vjp's through JAX's int8_conv."""
    x, w, b = _conv_inputs(k=3, cout=4, seed=1)
    scale = SCALES[mode]
    g = np.random.default_rng(2).normal(
        size=(2, -(-15 // stride), -(-14 // stride), 4)).astype(np.float32)
    _, vjp = jax.vjp(lambda x_, w_, b_: jax_quant.int8_conv(
        x_, w_, b_, stride, "SAME", scale), jnp.asarray(x), jnp.asarray(w),
        jnp.asarray(b))
    want = [np.asarray(a) for a in vjp(jnp.asarray(g))]
    xt, wt = _nchw(x).requires_grad_(), _oihw(w).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    quant.int8_conv(xt, wt, bt, stride, scale).backward(_nchw(g))
    got = [xt.grad.numpy().transpose(0, 2, 3, 1),
           wt.grad.numpy().transpose(2, 3, 1, 0), bt.grad.numpy()]
    for name, a, e in zip(("dx", "dw", "db"), got, want):
        err = np.abs(a - e).max() / np.abs(e).max()
        assert err <= 1e-6, (name, err)


def _jax_variables(cls, size=64, n_res=2, seed=0):
    """JAX variables at n_res=2 with the BatchNorms' affine and running
    statistics drawn away from their init (so the bounds differ by
    channel, and some channel falls to the floor)."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(size=(2, size, size, 3)).astype(np.float32)
    kw = dict(frame=2) if cls is JaxTSM else {}
    v = jax.jit(lambda k: cls(n_res=n_res).init(
        k, img, img, np.zeros((2, size, size, 6), np.float32), **kw))(
        jax.random.PRNGKey(seed))
    v = jax.tree.map(np.asarray, v)

    def draw(path, a):
        keys = [getattr(p, "key", "") for p in path]
        if "BatchNorm_0" not in keys:
            return a
        if keys[-1] == "scale":
            out = rng.uniform(0.3, 1.5, a.shape)
            out[0] = 1e-4       # a collapsed channel: the floor bound
            return out.astype(np.float32)
        if keys[-1] in ("bias", "mean"):
            return rng.normal(0.0, 0.3, a.shape).astype(np.float32)
        return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)   # var

    return jax.tree_util.tree_map_with_path(draw, v)


@pytest.fixture(scope="module")
def gsc_vars():
    return _jax_variables(JaxGSC)


def test_head_input_bounds_and_calibration_match_jax(gsc_vars):
    sd = from_jax_variables(gsc_vars)
    want = jax_calibration.head_input_bounds(gsc_vars)
    got = calibration.head_input_bounds(sd)
    assert isinstance(got, tuple) and got == want
    assert got[0] == 0.05 or min(got) >= 0.05
    for kw in (dict(int8_head=True), dict(int8_head_split=True),
               dict(int8_head=True, int8_head_scale=1.5),
               dict(int8_head=False)):
        ref = jax_calibration.calibrate_config(jax_config(**kw), gsc_vars)
        port = calibration.calibrate_config(get_config(**kw), sd)
        assert port.int8_head_scale == ref.int8_head_scale, kw
    # rgb has no int8 head: the config stays as it is in both packages
    rgb = jax_calibration.calibrate_config(
        dataclasses.replace(jax_config(variant="rgb"), int8_head=True),
        gsc_vars)
    assert rgb.int8_head_scale == 0.0
    port_rgb = get_config(variant="rgb")
    assert calibration.calibrate_config(port_rgb, sd) is port_rgb


def test_split_head_block_is_exact_on_the_gain_channel():
    """int8_channels=(1,): channel 0 is the plain conv exactly, channel 1
    JAX's int8 conv within 1 ulp; the parameters are the plain conv's."""
    x, w, b = _conv_inputs(seed=3)
    block = ConvBlock(C_IN, 2, ksize=7, norm=None, act=False, int8=True,
                      int8_scale=2.5, int8_channels=(1,))
    plain = ConvBlock(C_IN, 2, ksize=7, norm=None, act=False)
    assert block.state_dict().keys() == plain.state_dict().keys()
    with torch.no_grad():
        for m in (block, plain):
            m.conv.weight.copy_(_oihw(w))
            m.conv.bias.copy_(torch.from_numpy(b))
        y, y0 = block(_nchw(x)), plain(_nchw(x))
    ch1 = np.asarray(jax_quant.int8_conv(
        jnp.asarray(x), jnp.asarray(w[..., 1:]), jnp.asarray(b[1:]),
        static_scale=2.5))
    np.testing.assert_allclose(y[:, 0].numpy(), y0[:, 0].numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_max_ulp(y[:, 1:].numpy().transpose(0, 2, 3, 1),
                                    ch1, maxulp=1)


def _head_step(sd, scale, head_in):
    """One code step of the head's input, on its output, per output
    channel: max over (input channel, tap) of |w| * bound_c / 127 (a code
    that flips at a .5 boundary moves an output by at most this).  The
    dynamic mode's bound is the largest |head input| of any sample."""
    w = sd["head.conv.weight"].numpy()
    if not isinstance(scale, tuple):
        bound = scale if scale > 0 else float(head_in.abs().max())
        scale = [bound] * w.shape[1]
    s = np.asarray(scale)
    return (np.abs(w) * (s / 127.0)[None, :, None, None]).max(axis=(1, 2, 3))


def _run_capturing_head_input(model, *args):
    """The model's outputs (numpy) and its head's input."""
    seen = []
    hook = model.head.register_forward_pre_hook(
        lambda mod, inp: seen.append(inp[0]))
    try:
        with torch.no_grad():
            out = [o.numpy() for o in model(*args)]
    finally:
        hook.remove()
    return out, seen[0]


@pytest.mark.parametrize("variant,kw", [
    ("gsc", dict(int8_head=True)),
    ("gsc", dict(int8_head_split=True)),
    ("gsc", dict(int8_head=True, int8_head_scale=-1.0)),
    ("tsm", dict(int8_head=True)),
])
def test_int8_generators_match_jax(variant, kw, gsc_vars):
    """The int8 GSC (full and split head) and TSM generators at 64 px,
    n_res=2, f32, calibrated from the checkpoint, against JAX's on the
    same weights and inputs.  A head input that differs by f32 rounding
    can flip one code at a .5 boundary, which moves a head channel by at
    most one code step; every output is held within the steps of both
    head channels (gs, mask22 and dif take the head through tanh and sums
    with |d/dh| <= 1 for an input in [0, 1]) plus 2e-4, the f32 network's
    own difference from JAX's on these drawn BatchNorms (up to 1.01e-4
    measured on con_rgb).  And the int8 head must move the outputs away
    from the float head's, or the test would hold nothing."""
    jvars = gsc_vars if variant == "gsc" else _jax_variables(JaxTSM)
    sd = from_jax_variables(jvars)
    cfg = calibration.calibrate_config(
        get_config(variant=variant, img_size=64, n_res=2,
                   compute_dtype="float32", **kw), sd)
    jcfg = jax_calibration.calibrate_config(jax_config(
        variant=variant, img_size=64, n_res=2, compute_dtype="float32",
        **kw), jvars)
    assert cfg.int8_head_scale == jcfg.int8_head_scale
    jkw = dict(int8_head=cfg.int8_head, int8_head_scale=jcfg.int8_head_scale)
    if variant == "gsc":
        jkw["int8_head_split"] = cfg.int8_head_split
    jgen = (JaxGSC if variant == "gsc" else JaxTSM)(n_res=2, **jkw)

    rng = np.random.default_rng(5)
    img = rng.uniform(size=(2, 64, 64, 3)).astype(np.float32)
    uv = rng.uniform(size=(2, 64, 64, 3)).astype(np.float32)
    reg = rng.uniform(-0.05, 0.05, (2, 64, 64, 6)).astype(np.float32)
    extra = dict(frame=2) if variant == "tsm" else {}
    want = [np.asarray(o) for o in jax.jit(
        lambda v: jgen.apply(v, img, uv, reg, **extra))(jvars)]

    model = build_generator(cfg, sd, "cpu")
    assert model.head.int8
    args = (torch.from_numpy(img), torch.from_numpy(uv))
    if variant == "tsm":
        args += (torch.from_numpy(reg), 2)
    got, head_in = _run_capturing_head_input(model, *args)
    step = _head_step(sd, cfg.int8_head_scale, head_in).sum()
    for name, a, e in zip(OUT_NAMES, got, want):
        assert a.shape == e.shape, name
        err = float(np.abs(a - e).max())
        assert err <= step + 2e-4, (name, err, step)
    float_cfg = dataclasses.replace(cfg, int8_head=False,
                                    int8_head_split=False)
    plain, _ = _run_capturing_head_input(
        build_generator(float_cfg, sd, "cpu"), *args)
    assert np.abs(plain[0] - got[0]).max() > 1e-3


def test_int8_head_folded_keeps_f32_weights_and_matches_unfolded(gsc_vars):
    """A folded int8 model keeps its head's weights f32 (they are
    quantized from f32, as the JAX package's are), and gives the unfolded
    model's outputs in f32."""
    sd = from_jax_variables(gsc_vars)
    cfg = calibration.calibrate_config(get_config(
        img_size=64, n_res=2, compute_dtype="float32", int8_head=True), sd)
    folded = build_generator(dataclasses.replace(cfg, fold_bn=True), sd,
                             "cpu")
    bf16 = build_generator(dataclasses.replace(
        cfg, fold_bn=True, compute_dtype="bfloat16"), sd, "cpu")
    assert bf16.head.conv.weight.dtype == torch.float32
    assert bf16.up3.conv.weight.dtype == torch.bfloat16
    plain = build_generator(cfg, sd, "cpu")
    rng = np.random.default_rng(6)
    img = torch.from_numpy(rng.uniform(size=(2, 64, 64, 3)).astype(np.float32))
    uv = torch.from_numpy(rng.uniform(size=(2, 64, 64, 3)).astype(np.float32))
    a, _ = _run_capturing_head_input(folded, img, uv)
    b, head_in = _run_capturing_head_input(plain, img, uv)
    with torch.no_grad():
        out = bf16(img, uv)
    step = _head_step(sd, cfg.int8_head_scale, head_in).sum()
    for name, x, y in zip(OUT_NAMES, a, b):
        if name != "con_rgb":
            assert float(np.abs(x - y).max()) <= 1e-5 + step, name
    assert all(bool(torch.isfinite(o.float()).all()) for o in out)
