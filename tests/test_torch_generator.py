"""Port's GSCGenerator (models/generator.py), BatchNorm folding
(models/folding.py) and weight bridges (models/weights.py) against the JAX
package and the TF-reference goldens in tests/goldens/tf_ref/."""

import os

import jax
import numpy as np
import pytest
import torch

from blindshadowremoval_tpu.models.folding import fold_batch_norm as jax_fold
from blindshadowremoval_tpu.models.generator import GSCGenerator as JaxGSC
from blindshadowremoval_tpu.models.tf_checkpoint import (
    generator_mapping as jax_mapping,
    load_weights_dict,
    synthetic_tf_weights as jax_synthetic,
)
from blindshadowremoval_tpu_torch.config import get_config
from blindshadowremoval_tpu_torch.models import build_generator
from blindshadowremoval_tpu_torch.models.folding import fold_batch_norm
from blindshadowremoval_tpu_torch.models.generator import GSCGenerator
from blindshadowremoval_tpu_torch.models.weights import (
    from_jax_variables,
    generator_mapping,
    load_tf_weights,
    synthetic_tf_weights,
)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens", "tf_ref")
SIZE = 128          # tools/make_tf_ref_goldens.py's size
INPUT_SEED = 123    # and its input seed
OUT_NAMES = ("gs", "con_rgb", "mask22", "dif")


def _inputs(size=SIZE):
    rng = np.random.default_rng(INPUT_SEED)
    img = rng.uniform(0.0, 1.0, (1, size, size, 3)).astype(np.float32)
    uv = rng.uniform(0.0, 1.0, (1, size, size, 3)).astype(np.float32)
    reg = rng.uniform(-0.02, 0.02, (1, size, size, 6)).astype(np.float32)
    return img, uv, reg


@pytest.fixture(scope="module")
def jax_setup():
    """JAX GSCGenerator with the TF-golden weights (synthetic_tf_weights,
    seed 0), as tests/test_tf_model_parity.py builds it."""
    gen = JaxGSC()
    img, uv, reg = _inputs()
    variables = jax.jit(gen.init)(jax.random.PRNGKey(0), img[:, :64, :64],
                                  uv[:, :64, :64], reg[:, :64, :64])
    weights = jax_synthetic(variables, jax_mapping(), seed=0)
    variables = load_weights_dict(weights, variables, jax_mapping())
    return gen, jax.tree.map(np.asarray, variables), weights


def _run(model, img, uv):
    with torch.no_grad():
        outs = model(torch.from_numpy(img), torch.from_numpy(uv))
    return [o.float().numpy() for o in outs]


def _port(state_dict, fold_bn=False):
    model = GSCGenerator(fold_bn=fold_bn).eval()
    model.load_state_dict(state_dict)
    return model


def test_forward_matches_jax_f32(jax_setup):
    gen, variables, _ = jax_setup
    img, uv, reg = _inputs()
    ref = gen.apply(variables, img, uv, reg)
    out = _run(_port(from_jax_variables(variables)), img, uv)
    for name, a, b in zip(OUT_NAMES, out, ref):
        # f32 through ~45 conv layers, summed in another order by XLA and
        # ATen: measured max error 2e-6
        np.testing.assert_allclose(a, np.asarray(b), atol=2e-5, err_msg=name)


def test_synthetic_tf_weights_match_jax(jax_setup):
    _, variables, jax_weights = jax_setup
    mapping = generator_mapping()
    weights = synthetic_tf_weights(GSCGenerator().state_dict(), mapping, 0)
    assert set(weights) == set(jax_weights)
    for name, value in weights.items():
        np.testing.assert_array_equal(value, jax_weights[name], err_msg=name)
    # the TF-name path and the JAX-tree path land on the same state_dict
    via_tf = load_tf_weights(weights, mapping)
    via_jax = from_jax_variables(variables)
    assert set(via_tf) == set(via_jax)
    for name in via_tf:
        torch.testing.assert_close(via_tf[name], via_jax[name], rtol=0,
                                   atol=0, msg=name)


def test_fold_matches_jax_fold(jax_setup):
    gen, variables, _ = jax_setup
    folded = fold_batch_norm(_port(from_jax_variables(variables)))
    ref = _port(from_jax_variables(jax.tree.map(
        np.asarray, jax_fold(variables))), fold_bn=True)
    got, want = folded.state_dict(), ref.state_dict()
    assert set(got) == set(want)
    for name in got:
        # both fold in f32; XLA and ATen round sqrt/divide alike up to 1 ulp
        torch.testing.assert_close(got[name], want[name], rtol=1e-6,
                                   atol=1e-7, msg=name)


def test_folded_matches_unfolded(jax_setup):
    _, variables, _ = jax_setup
    img, uv, _ = _inputs()
    sd = from_jax_variables(variables)
    plain = _run(_port(sd), img, uv)
    folded = _run(fold_batch_norm(_port(sd)), img, uv)
    for name, a, b in zip(OUT_NAMES, folded, plain):
        # folding is exact algebra; f32 rounding of the folded weights only
        np.testing.assert_allclose(a, b, atol=1e-5, err_msg=name)


def test_tf_golden_gsc_forward():
    golden = np.load(os.path.join(GOLDEN_DIR, "gsc_forward.npz"))
    mapping = generator_mapping()
    weights = synthetic_tf_weights(GSCGenerator().state_dict(), mapping, 0)
    img, uv, _ = _inputs()
    out = _run(_port(load_tf_weights(weights, mapping)), img, uv)
    for name, value in zip(OUT_NAMES, out):
        # tests/test_tf_model_parity.py's rule: a 1e-4 floor, widened by
        # 20x the TF reference's own eager-vs-graph noise
        tol = max(1e-4, 20.0 * float(golden[f"eval_{name}_selfnoise"]))
        err = np.abs(value - golden[f"eval_{name}"]).max()
        assert err < tol, f"{name}: max abs err {err} (tol {tol})"


def _psnr(a, b):
    return float(10.0 * np.log10(1.0 / np.mean((a - b) ** 2)))


@pytest.mark.parametrize("overrides,bar", [
    # f32: the in-the-wild north-star bar (tests/test_tf_ref_e2e.py);
    # 77.6 dB on an x86 CPU
    (dict(compute_dtype="float32"), 45.0),
    # bf16 + folded BN + bf16 egress, the serving configuration: bench.py's
    # production bar; 58.1 dB on an x86 CPU
    (dict(compute_dtype="bfloat16", fold_bn=True, egress_dtype="bfloat16"),
     40.0),
])
def test_tf_golden_in_the_wild(overrides, bar):
    golden = np.load(os.path.join(GOLDEN_DIR, "e2e_eval.npz"))
    mapping = generator_mapping()
    weights = synthetic_tf_weights(GSCGenerator().state_dict(), mapping, 0)
    # the goldens lift the RGB head bias so the shadow map has structure
    # (tests/test_tf_ref_e2e.py:58-63)
    weights["generator/clr_conv3/conv/bias"] += 0.5
    model = build_generator(get_config(**overrides),
                            load_tf_weights(weights, mapping), device="cpu")
    img = golden["ffhq_input"].astype(np.float32)[None]
    uv = golden["ffhq_uv"].astype(np.float32)[None]
    pred = np.clip(_run(model, img, uv)[1][0], 0.0, 1.0)
    psnr = _psnr(pred, golden["ffhq_pred"].astype(np.float32))
    assert psnr >= bar, f"{psnr:.2f} dB against the TF reference"


def test_build_generator_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_generator(get_config(compute_dtype="float32", n_res=2))


def test_config_rejects_unported_options():
    # the space-to-depth convs are ported (models/blocks.py)
    assert get_config(s2d_convs=True).s2d_convs
    # meshes over several devices are ported (parallel/): the fields are
    # accepted as JAX accepts them, checked where a mesh is built
    assert get_config(mesh_shape=(2, 1)).mesh_shape == (2, 1)
    assert get_config(mesh_shape=(1, 1)).mesh_axis_names == ("data", "frame")
    # the int8 head is ported (ops/quant.py): both forms build
    assert get_config(int8_head=True).int8_head
    assert get_config(int8_head_split=True, int8_head_scale=2.0).int8_head_split
    with pytest.raises(NotImplementedError, match="float32"):
        get_config(param_dtype="bfloat16")
    with pytest.raises(ValueError, match="bottleneck"):
        get_config(img_size=64, map_size=16)
    assert get_config(img_size=64, map_size=8).map_size == 8
    # the train preset's device-darkening and uint8 wires are ported:
    # both build
    assert get_config("train", device_darken=True).device_darken
    assert get_config("train", compact_ingress=True,
                      ingress_u8=True).ingress_u8
    with pytest.raises(ValueError, match="unknown variant"):
        get_config(variant="vgg")
    # the SFW presets build the TSM variant, as in the JAX package; its
    # collective ShareLayer (frames over devices) builds, and reduces only
    # inside a mesh over processes
    for preset in ("sfw", "sfw_video"):
        assert get_config(preset).variant == "tsm"
    from blindshadowremoval_tpu_torch.models.generator_tsm import ShareLayer
    assert ShareLayer(axis_name="frame").axis_name == "frame"
