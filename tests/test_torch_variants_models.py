"""The port's TSM and RGB generators (models/generator_tsm.py,
models/generator_rgb.py), their weight mappings and folding, and the
variant configuration, against the JAX package and the TF-reference
goldens tsm_forward.npz and rgb_forward.npz, on the CPU."""

import os

import jax
import numpy as np
import pytest
import torch

from blindshadowremoval_tpu.config import get_config as jax_config
from blindshadowremoval_tpu.models.generator_rgb import RGBGenerator as JaxRGB
from blindshadowremoval_tpu.models.generator_tsm import TSMGenerator as JaxTSM
from blindshadowremoval_tpu.models.tf_checkpoint import (
    generator_mapping as jax_mapping,
    load_weights_dict,
    synthetic_tf_weights as jax_synthetic,
)
from blindshadowremoval_tpu_torch.config import VARIANTS, get_config
from blindshadowremoval_tpu_torch.models import GENERATORS, build_generator
from blindshadowremoval_tpu_torch.models.folding import fold_batch_norm
from blindshadowremoval_tpu_torch.models.generator_rgb import RGBGenerator
from blindshadowremoval_tpu_torch.models.generator_tsm import (
    ShareLayer,
    TSMGenerator,
)
from blindshadowremoval_tpu_torch.models.weights import (
    from_jax_variables,
    generator_mapping,
    load_tf_weights,
    synthetic_tf_weights,
)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens", "tf_ref")
GOLDEN_SIZE = 128      # tools/make_tf_ref_goldens.py's size
INPUT_SEED = 123       # and its input seed
OUT_NAMES = ("gs", "con_rgb", "mask22", "dif")
JAX_CLASSES = {"tsm": JaxTSM, "rgb": JaxRGB}
PORT_CLASSES = {"tsm": TSMGenerator, "rgb": RGBGenerator}


@pytest.fixture(autouse=True)
def two_threads():
    """Six test workers share the machine: a wide thread pool in each
    costs more than it saves."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _inputs(views=4, size=64, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.uniform(size=(views, size, size, 3)).astype(np.float32)
    uv = rng.uniform(size=(views, size, size, 3)).astype(np.float32)
    reg = rng.uniform(-0.05, 0.05, (views, size, size, 6)).astype(np.float32)
    return img, uv, reg


def _jax_variables(variant, n_res, size=64):
    img, uv, reg = _inputs(2, size)
    kw = dict(frame=2) if variant == "tsm" else {}
    v = jax.jit(lambda k: JAX_CLASSES[variant](n_res=n_res).init(
        k, img, uv, reg, **kw))(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, v)


@pytest.fixture(scope="module")
def small():
    """JAX variables of both variants at n_res=2 (random init)."""
    return {v: _jax_variables(v, 2) for v in ("tsm", "rgb")}


def _port(variant, sd, n_res, train=False, **kw):
    model = PORT_CLASSES[variant](n_res=n_res, **kw)
    model.load_state_dict(sd)
    return model.train(train)


def _forward(model, variant, img, uv, reg, **kw):
    with torch.no_grad():
        args = (torch.from_numpy(img), torch.from_numpy(uv))
        if variant == "tsm":
            out = model(*args, torch.from_numpy(reg), **kw)
        else:
            out = (model(*args),)
    return [o.float().numpy() for o in out]


@pytest.mark.parametrize("variant,kw", [
    ("tsm", dict(frame=2, share=True)),
    ("tsm", dict(frame=2, share=False)),
    ("tsm", dict(frame=1, share=True)),
    ("rgb", {}),
])
@pytest.mark.parametrize("train", [False, True])
def test_generator_matches_jax(small, variant, kw, train):
    """One JAX init, both packages, 64 px, n_res=2, eval mode (running
    statistics) and train mode (batch statistics)."""
    variables = small[variant]
    img, uv, reg = _inputs()
    gen = JAX_CLASSES[variant](n_res=2)
    if train:
        ref, _ = gen.apply(variables, img, uv, reg, train=True,
                           mutable=["batch_stats"], **kw)
    else:
        ref = gen.apply(variables, img, uv, reg, **kw)
    ref = ref if variant == "tsm" else (ref,)
    model = _port(variant, from_jax_variables(variables), 2, train)
    out = _forward(model, variant, img, uv, reg, **kw)
    for name, a, b in zip(OUT_NAMES, out, ref):
        b = np.asarray(b)
        # f32 through ~30 layers (and two warps), XLA and ATen summing in
        # other orders: measured at most 3.6e-7 in eval mode.  In train mode
        # BatchNorm's batch statistics over 4 views of an 8x8 bottleneck
        # amplify that noise: measured 6.4e-5 (TSM) and 1.6e-5 (RGB) of the
        # output's largest magnitude (the GSC generator itself: 1.7e-4)
        atol = 2e-4 * float(np.abs(b).max()) if train else 2e-5
        np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=name)


def test_tsm_tensor_gate_equals_bool_gate(small):
    """The train step's 0-d tensor gate selects on the device what the bool
    gate picks on the host, and the gradient flows only through the
    chosen branch (as JAX's lax.cond)."""
    img, uv, reg = _inputs()
    sd = from_jax_variables(small["tsm"])
    for share in (True, False):
        model = _port("tsm", sd, 2, train=True)
        want = _forward(model, "tsm", img, uv, reg, frame=1, share=share)
        got = _forward(model, "tsm", img, uv, reg, frame=1,
                       share=torch.tensor(share))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    x = torch.randn(2, 4, 8, 8, requires_grad=True)
    r = torch.from_numpy(reg[:2])
    layer = ShareLayer()
    for share in (True, False):
        gx, = torch.autograd.grad(layer(x, r, 1, torch.tensor(share)).sum(),
                                  x)
        want, = torch.autograd.grad(layer(x, r, 1, share).sum(), x)
        torch.testing.assert_close(gx, want, rtol=0, atol=0)


def test_share_layer_keeps_the_compute_dtype():
    """The warps run in f32 (the f32 offset field promotes them); only the
    result goes back to bf16 (generator_tsm.py:64-69)."""
    x = torch.randn(4, 6, 8, 8).to(torch.bfloat16)
    reg = torch.empty(4, 32, 32, 6).uniform_(-0.05, 0.05)
    out = ShareLayer()(x, reg, frame=2)
    assert out.dtype == torch.bfloat16 and out.shape == (4, 12, 8, 8)
    # frame=2: both views of a group carry the same statistics before the
    # warp out, so a zero field gives the same max and mean
    same = ShareLayer()(x, torch.zeros_like(reg), frame=2)
    torch.testing.assert_close(same[0], same[1], rtol=0, atol=0)
    torch.testing.assert_close(same[0, :6], torch.maximum(x[0], x[1]),
                               rtol=0, atol=0)


def test_collective_share_layer_is_not_ported():
    """(Named when the collective mode raised.)  It is ported now: the
    generator builds both ShareLayer insertions in collective mode, with
    the local mode's parameters, and refuses to reduce outside a mesh over
    processes (tests/test_torch_distributed.py runs it over ranks)."""
    gen = TSMGenerator(n_res=2, axis_name="frame")
    assert gen.info_share.axis_name == "frame"
    assert gen.state_dict().keys() == TSMGenerator(n_res=2).state_dict().keys()
    x = torch.zeros(2, 32, 32, 3)
    reg = torch.zeros(2, 32, 32, 6)
    with pytest.raises(RuntimeError, match="with mesh:"), torch.no_grad():
        gen.eval()(x, x, reg, frame=1)


def _golden_inputs(variant):
    """tests/test_tf_model_parity.py's inputs: one seeded view, and for TSM
    a second uniform one."""
    rng = np.random.default_rng(INPUT_SEED)
    s = GOLDEN_SIZE
    img = rng.uniform(0.0, 1.0, (1, s, s, 3)).astype(np.float32)
    uv = rng.uniform(0.0, 1.0, (1, s, s, 3)).astype(np.float32)
    reg = rng.uniform(-0.02, 0.02, (1, s, s, 6)).astype(np.float32)
    if variant == "tsm":
        rng = np.random.default_rng(INPUT_SEED + 1)
        img = np.concatenate([img, rng.uniform(0, 1, img.shape)], 0)
        uv = np.concatenate([uv, rng.uniform(0, 1, uv.shape)], 0)
        reg = np.concatenate([reg, rng.uniform(-0.02, 0.02, reg.shape)], 0)
    return img.astype(np.float32), uv.astype(np.float32), \
        reg.astype(np.float32)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("variant", ["tsm", "rgb"])
def test_tf_golden_forward(variant, train):
    """tsm_forward.npz / rgb_forward.npz through the port's TF-name mapping,
    at tests/test_tf_model_parity.py's bars (a 1e-4 floor, widened by 20x
    the TF reference's own eager-vs-graph noise)."""
    golden = np.load(os.path.join(GOLDEN_DIR, f"{variant}_forward.npz"))
    mapping = generator_mapping(variant)
    weights = synthetic_tf_weights(PORT_CLASSES[variant]().state_dict(),
                                   mapping, 0)
    model = _port(variant, load_tf_weights(weights, mapping), 6, train)
    img, uv, reg = _golden_inputs(variant)
    out = _forward(model, variant, img, uv, reg, frame=2, share=True)
    mode = "train" if train else "eval"
    names = OUT_NAMES if variant == "tsm" else ("con",)
    for name, value in zip(names, out):
        tol = max(1e-4, 20.0 * float(golden[f"{mode}_{name}_selfnoise"]))
        err = np.abs(value - golden[f"{mode}_{name}"]).max()
        assert err < tol, f"{name}: max abs err {err} (tol {tol})"


@pytest.mark.parametrize("variant", ["tsm", "rgb"])
def test_mapping_agrees_with_from_jax_variables(variant):
    """The port's synthetic TF weights equal the JAX package's value for
    value, and the TF-name path and the JAX-tree path land on the same
    state_dict (full width, n_res=6)."""
    variables = _jax_variables(variant, 6)
    jw = jax_synthetic(variables, jax_mapping(variant), seed=0)
    mapping = generator_mapping(variant)
    weights = synthetic_tf_weights(PORT_CLASSES[variant]().state_dict(),
                                   mapping, 0)
    assert set(weights) == set(jw)
    for name, value in weights.items():
        np.testing.assert_array_equal(value, jw[name], err_msg=name)
    via_jax = from_jax_variables(jax.tree.map(np.asarray, load_weights_dict(
        jw, variables, jax_mapping(variant))))
    via_tf = load_tf_weights(weights, mapping)
    assert set(via_tf) == set(via_jax) == set(
        PORT_CLASSES[variant]().state_dict())
    for name in via_tf:
        torch.testing.assert_close(via_tf[name], via_jax[name], rtol=0,
                                   atol=0, msg=name)


@pytest.mark.parametrize("variant", ["tsm", "rgb"])
def test_folded_matches_unfolded(small, variant):
    sd = from_jax_variables(small[variant])
    img, uv, reg = _inputs()
    plain = _forward(_port(variant, sd, 2), variant, img, uv, reg, frame=2)
    folded = _forward(fold_batch_norm(_port(variant, sd, 2)), variant, img,
                      uv, reg, frame=2)
    for a, b in zip(folded, plain):
        # exact algebra; f32 rounding of the folded weights only
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


@pytest.mark.parametrize("variant", VARIANTS)
def test_build_generator_builds_the_variant(variant):
    cfg = get_config(variant=variant, n_res=2, compute_dtype="bfloat16",
                     fold_bn=True)
    model = build_generator(cfg, device="cpu")
    assert type(model) is GENERATORS[variant] and not model.training
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    assert not any(isinstance(m, torch.nn.BatchNorm2d)
                   for m in model.modules())


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_f32_forward_turns_cudnn_tf32_off(variant, compute_dtype):
    """An f32-compute forward runs its convolutions with cuDNN's TF32 off
    (PyTorch's default is on; TF32 misses the f32 goldens' bars on the
    card), and restores the setting after; bf16 leaves it alone."""
    model = build_generator(get_config(variant=variant, n_res=2,
                                       compute_dtype=compute_dtype),
                            device="cpu")
    seen = []
    model.conv1.register_forward_hook(
        lambda *_: seen.append(torch.backends.cudnn.allow_tf32))
    model.res[-1].register_forward_hook(
        lambda *_: seen.append(torch.backends.cudnn.allow_tf32))
    img, uv, reg = (torch.from_numpy(a) for a in _inputs(views=2, size=32))
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with torch.no_grad():
            model(img, uv, reg, **(dict(frame=2) if variant == "tsm"
                                   else {}))
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    assert seen == [compute_dtype != "float32"] * 2


@pytest.mark.parametrize("preset", ["in_the_wild", "ucb", "sfw", "sfw_video",
                                    "train"])
def test_presets_match_jax(preset):
    """Each preset's variant, mode and wires equal the JAX package's: the
    SFW presets build the TSM variant, and no preset rasterizes its maps on
    the device unless asked."""
    port, ref = get_config(preset), jax_config(preset)
    for name in ("variant", "mode", "device_geometry", "compact_ingress",
                 "img_size", "n_res", "eval_views", "compute_dtype",
                 "egress_dtype", "fold_bn"):
        assert getattr(port, name) == getattr(ref, name), name
    assert port.device_geometry is False
