"""The TSM and RGB variants' evaluation data, evaluators and services
against the JAX package's (128 px, n_res=2, shared weights), and SFW-TSM
against the TF-reference golden at full width, on the CPU.  The default
configurations of both packages build the same batches and services."""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from blindshadowremoval_tpu.config import get_config as jax_config
from blindshadowremoval_tpu.data.dataset import Dataset as JaxDataset
from blindshadowremoval_tpu.eval import evaluators as jax_ev
from blindshadowremoval_tpu.eval.serving import (
    ShadowRemovalService as JaxService,
)
from blindshadowremoval_tpu.geometry.landmarks import LM_REF
from blindshadowremoval_tpu.models.tf_checkpoint import (
    generator_mapping as jax_mapping,
    load_weights_dict,
    synthetic_tf_weights as jax_synthetic,
)
from blindshadowremoval_tpu.train.trainer import build_generator
from blindshadowremoval_tpu_torch.config import get_config
from blindshadowremoval_tpu_torch.data.dataset import Dataset
from blindshadowremoval_tpu_torch.eval import evaluators
from blindshadowremoval_tpu_torch.eval.serving import ShadowRemovalService
from blindshadowremoval_tpu_torch.models.weights import from_jax_variables
from chip_smoke import golden_weights, synthetic_ucb_tree

TF_REF = os.path.join(os.path.dirname(__file__), "goldens", "tf_ref")
S = 128
N_RES = 2


@pytest.fixture(autouse=True)
def two_threads():
    """Six test workers share the machine: a wide thread pool in each
    costs more than it saves."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def jax_golden_variables(variant: str, n_res: int = N_RES):
    """JAX generator variables of `variant` from the TF-golden weight
    recipe (synthetic_tf_weights seed 0, RGB head bias +0.5 where there is
    one), as numpy."""
    cfg = jax_config("in_the_wild", variant=variant, img_size=S,
                     n_res=n_res, compute_dtype="float32")
    z = np.zeros((2, 64, 64, 3), np.float32)
    zr = np.zeros((2, 64, 64, 6), np.float32)
    kw = dict(frame=2) if variant == "tsm" else {}
    v = jax.jit(lambda k: build_generator(cfg).init(k, z, z, zr, **kw))(
        jax.random.PRNGKey(0))
    mapping = jax_mapping(variant, n_res=n_res)
    weights = jax_synthetic(v, mapping, seed=0)
    if variant != "rgb":
        weights["generator/clr_conv3/conv/bias"] += 0.5
    return jax.tree.map(np.asarray, load_weights_dict(weights, v, mapping))


@pytest.fixture(scope="module")
def weights():
    """{variant: (JAX variables, the port's state_dict)}."""
    out = {}
    for variant in ("tsm", "rgb"):
        v = jax_golden_variables(variant)
        out[variant] = (v, from_jax_variables(v))
    return out


def _kw(tmp_path, **kw):
    return dict(img_size=S, n_res=N_RES, compute_dtype="float32",
                checkpoint_dir=str(tmp_path), **kw)


def _pair(preset, tmp_path, weights, cls, variant, **kw):
    """(port evaluator on the CPU, JAX evaluator) on one configuration."""
    variables, sd = weights[variant]
    kw["variant"] = variant
    ours = getattr(evaluators, cls)(
        get_config(preset, **_kw(tmp_path / "port", **kw)), sd, device="cpu")
    theirs = getattr(jax_ev, cls)(
        jax_config(preset, **_kw(tmp_path / "jax", **kw)), variables)
    return ours, theirs


def _compare_batches(ours, theirs):
    b_ours, box_ours, name_ours = ours
    b_theirs, box_theirs, name_theirs = theirs
    assert name_ours == name_theirs
    np.testing.assert_array_equal(box_ours, box_theirs)
    assert sorted(b_ours) == sorted(b_theirs)
    for k, v in b_theirs.items():
        assert b_ours[k].shape == v.shape and b_ours[k].dtype == v.dtype, k
        if k.endswith("_tris") or k == "lm":
            np.testing.assert_array_equal(b_ours[k], v, err_msg=k)
        else:
            # numpy vs the JAX package's crop and rasterizer: f32 rounding
            np.testing.assert_allclose(b_ours[k], v, rtol=0, atol=1e-5,
                                       err_msg=k)


@pytest.fixture(scope="module")
def ucb_root(tmp_path_factory):
    return synthetic_ucb_tree(str(tmp_path_factory.mktemp("ucb") / "tree"),
                              n_images=3)


@pytest.mark.parametrize("device_geometry", [False, True])
@pytest.mark.parametrize("case", ["sfw tsm", "ucb tsm", "ucb rgb"])
def test_variant_datasets_match_jax(ucb_root, case, device_geometry):
    """The TSM SFW sample (frame + mirrored twin with cmap and label), the
    TSM UCB sample (anchor + mirror) and the RGB UCB sample (anchor + the
    same reference-view draws) equal the JAX package's."""
    preset, variant = case.split()
    kw = dict(variant=variant, img_size=S, eval_views=3,
              device_geometry=device_geometry)
    if preset == "sfw":
        kw["data_dirs_test"] = (os.path.join(TF_REF, "sfw_synth", "*"),)
        dset, views = "sfw", 2
    else:
        kw.update(data_dirs_test=(os.path.join(ucb_root, "input", "*"),),
                  part_mask_root=ucb_root)
        dset, views = None, 2 if variant == "tsm" else 3
    ours = Dataset(get_config(preset, **kw), "test", dset=dset, seed=3)
    theirs = JaxDataset(jax_config(preset, **kw), "test", dset=dset, seed=3)
    assert ours.name_list == theirs.name_list
    for a, b in zip(ours, theirs):
        assert a[0]["img"].shape == (views, S, S, 3)
        if views == 2:   # the twin is the mirror of the anchor
            np.testing.assert_array_equal(a[0]["img"][1],
                                          a[0]["img"][0][:, ::-1])
        _compare_batches(a, b)


@pytest.mark.parametrize("preset", ["in_the_wild", "ucb", "sfw", "sfw_video",
                                    "train"])
def test_default_configs_build_the_same_batches(ucb_root, preset):
    """Each preset at its defaults (only the data, the size and the view
    count set) builds test batches with the same keys in both packages: no
    preset ships device-geometry primitives unless asked.  The service's
    own default is device geometry in both."""
    kw = dict(img_size=64, eval_views=2,
              data_dirs_test=(os.path.join(TF_REF, "sfw_video_synth", "*"),))
    dset = None
    if preset == "ucb":
        kw.update(data_dirs_test=(os.path.join(ucb_root, "input", "*"),),
                  part_mask_root=ucb_root)
    elif preset.startswith("sfw"):
        dset = "sfw"
        if preset == "sfw":
            kw["data_dirs_test"] = (os.path.join(TF_REF, "sfw_synth", "*"),)
    ours = next(iter(Dataset(get_config(preset, **kw), "test", dset=dset)))
    theirs = next(iter(JaxDataset(jax_config(preset, **kw), "test",
                                  dset=dset)))
    assert sorted(ours[0]) == sorted(theirs[0])
    assert "lm" not in ours[0] and "uv" in ours[0]

    def default(cls):
        return {f.name: f.default for f in dataclasses.fields(cls)}

    assert default(ShadowRemovalService)["device_geometry"] is True
    assert default(JaxService)["device_geometry"] is True


def test_sfw_tsm_tf_golden_full_width(tmp_path):
    """tests/test_tf_ref_e2e.py:112-149's bars (|dAUC| <= 1e-3, |dPSNR| <=
    0.05, |dSSIM| <= 0.005, mask_pred >= 40 dB against e2e_eval.npz's
    sfw_*), port only, the sfw preset (TSM, host maps), 256 px, n_res=6."""
    golden = np.load(os.path.join(TF_REF, "e2e_eval.npz"))
    cfg = get_config("sfw", compute_dtype="float32",
                     checkpoint_dir=str(tmp_path), data_dirs_test=(
                         os.path.join(TF_REF, "sfw_synth", "*"),))
    assert cfg.variant == "tsm"
    batch, box, _ = next(iter(Dataset(cfg, "test", dset="sfw")))
    assert batch["img"].shape == (2, 256, 256, 3)
    r = evaluators.SFWEvaluator(cfg, golden_weights("tsm"),
                                device="cpu").run_one(batch, box, "sfw0")
    assert abs(r["auc"] - float(golden["sfw_auc"])) <= 1e-3
    assert abs(r["psnr"] - float(golden["sfw_psnr"])) <= 0.05
    assert abs(r["ssim"] - float(golden["sfw_ssim"])) <= 0.005
    mse = float(np.mean((r["mask_pred"] - golden["sfw_mask_pred"]) ** 2))
    assert 10.0 * np.log10(1.0 / mse) >= 40.0


@pytest.mark.parametrize("variant", ["tsm", "rgb"])
def test_sfw_evaluator_matches_jax(tmp_path, weights, variant):
    kw = dict(data_dirs_test=(os.path.join(TF_REF, "sfw_synth", "*"),))
    ours, theirs = _pair("sfw", tmp_path, weights, "SFWEvaluator", variant,
                         **kw)
    a = ours.run(Dataset(ours.config, "test", dset="sfw"))
    b = theirs.run(JaxDataset(theirs.config, "test", dset="sfw"))
    assert len(a) == len(b) == 1
    a, b = a[0], b[0]
    assert abs(a["auc"] - b["auc"]) <= 1e-4
    assert abs(a["psnr"] - b["psnr"]) <= 0.01
    assert abs(a["ssim"] - b["ssim"]) <= 1e-4
    np.testing.assert_allclose(a["mask_pred"], b["mask_pred"], atol=1e-4)
    np.testing.assert_allclose(a["pred"], b["pred"], atol=1e-4)


def test_sfw_video_tsm_matches_jax(tmp_path, weights):
    """The 10 frames of a video as one TSM group (frame=10)."""
    kw = dict(data_dirs_test=(os.path.join(TF_REF, "sfw_video_synth", "*"),))
    ours, theirs = _pair("sfw_video", tmp_path, weights, "SFWVideoEvaluator",
                         "tsm", **kw)
    batch, box, name = next(iter(Dataset(ours.config, "test", dset="sfw")))
    a = ours.run_one(batch, box, name)
    b = theirs.run_one(batch, box, name)
    assert a["pred"].shape == (10, S, S, 3)
    np.testing.assert_allclose(a["pred"], b["pred"], atol=1e-4)
    np.testing.assert_allclose(a["mask_pred"], b["mask_pred"], atol=1e-4)


@pytest.fixture(scope="module")
def requests():
    rng = np.random.default_rng(0)
    images, lms = [], []
    for i in range(3):
        images.append(rng.uniform(size=(220 + 10 * i, 200, 3)).astype(
            np.float32))
        lms.append((LM_REF * 130 + 35 + rng.normal(scale=1.0, size=(68, 2))
                    ).astype(np.float32))
    return images, lms


@pytest.mark.parametrize("device_geometry", [True, False])
@pytest.mark.parametrize("variant", ["tsm", "rgb"])
def test_service_matches_jax(weights, requests, variant, device_geometry):
    """TSM serves with frame=1 and the ShareLayer on; RGB's shadow map is
    zeros.  Three requests at batch 2: one full batch, one padded tail."""
    variables, sd = weights[variant]
    images, lms = requests
    kw = dict(variant=variant, img_size=S, compute_dtype="float32",
              n_res=N_RES)
    ref = JaxService(jax_config("in_the_wild", **kw), variables,
                     batch_size=2, device_geometry=device_geometry
                     ).remove_shadows(images, lms)
    out = ShadowRemovalService(get_config(**kw), sd, batch_size=2,
                               device="cpu", device_geometry=device_geometry
                               ).remove_shadows(images, lms)
    assert len(out) == len(ref) == 3
    for ours, theirs in zip(out, ref):
        assert ours["pred"].shape == (S, S, 3)
        np.testing.assert_array_equal(ours["box"], theirs["box"])
        # f32 end to end, as tests/test_torch_serving.py
        np.testing.assert_allclose(ours["pred"], theirs["pred"], atol=1e-4)
        np.testing.assert_allclose(ours["mask_pred"],
                                   np.asarray(theirs["mask_pred"]),
                                   atol=1e-4)
        if variant == "rgb":
            assert not ours["mask_pred"].any()
