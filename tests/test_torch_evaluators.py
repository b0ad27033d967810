"""The evaluation slice as a whole: the port's evaluators (eval/evaluators.py)
against the JAX package's at 128 px and n_res=2 with shared weights, on the
CPU.  tests/test_torch_eval_goldens.py holds them to the TF-reference
goldens at full width."""

import os

import jax
import numpy as np
import pytest
import scipy.io
import torch

from blindshadowremoval_tpu.config import get_config as jax_config
from blindshadowremoval_tpu.data.dataset import Dataset as JaxDataset
from blindshadowremoval_tpu.eval import evaluators as jax_ev
from blindshadowremoval_tpu.models.tf_checkpoint import (
    generator_mapping as jax_mapping,
    load_weights_dict,
    synthetic_tf_weights as jax_synthetic,
)
from blindshadowremoval_tpu.train.trainer import build_generator
from blindshadowremoval_tpu_torch.config import get_config
from blindshadowremoval_tpu_torch.data.dataset import Dataset
from blindshadowremoval_tpu_torch.eval import evaluators
from blindshadowremoval_tpu_torch.models.weights import from_jax_variables

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


@pytest.fixture(scope="module")
def variables():
    """JAX GSCGenerator variables at n_res=2 from the TF-golden weight recipe
    (synthetic_tf_weights seed 0, RGB head bias +0.5), as numpy."""
    cfg = jax_config("in_the_wild", img_size=S, n_res=N_RES,
                     compute_dtype="float32")
    z = np.zeros((1, 64, 64, 3), np.float32)
    v = jax.jit(build_generator(cfg).init)(
        jax.random.PRNGKey(0), z, z, np.zeros((1, 64, 64, 6), np.float32))
    mapping = jax_mapping(n_res=N_RES)
    weights = jax_synthetic(v, mapping, seed=0)
    weights["generator/clr_conv3/conv/bias"] += 0.5
    return jax.tree.map(np.asarray, load_weights_dict(weights, v, mapping))


@pytest.fixture(scope="module")
def state_dict(variables):
    return from_jax_variables(variables)


def _kw(tmp_path, **kw):
    return dict(img_size=S, n_res=N_RES, compute_dtype="float32",
                checkpoint_dir=str(tmp_path), **kw)


def _pair(preset, tmp_path, variables, state_dict, cls, **kw):
    """(port evaluator on the CPU, JAX evaluator) on one configuration."""
    ours = getattr(evaluators, cls)(
        get_config(preset, **_kw(tmp_path / "port", **kw)), state_dict,
        device="cpu")
    theirs = getattr(jax_ev, cls)(
        jax_config(preset, **_kw(tmp_path / "jax", **kw)), variables)
    return ours, theirs


def test_sfw_evaluator_matches_jax(tmp_path, variables, state_dict):
    kw = dict(variant="gsc", data_dirs_test=(
        os.path.join(TF_REF, "sfw_gsc_synth", "*"),))
    ours, theirs = _pair("sfw", tmp_path, variables, state_dict,
                         "SFWEvaluator", **kw)
    a = ours.run(Dataset(ours.config, "test", dset="sfw"))
    b = theirs.run(JaxDataset(theirs.config, "test", dset="sfw"))
    assert len(a) == len(b) == 1
    a, b = a[0], b[0]
    assert abs(a["auc"] - b["auc"]) <= 1e-4
    assert abs(a["psnr"] - b["psnr"]) <= 0.01
    assert abs(a["ssim"] - b["ssim"]) <= 1e-4
    np.testing.assert_allclose(a["mask_pred"], b["mask_pred"], atol=1e-4)
    assert os.path.isfile(tmp_path / "port" / "test" / "vid0_0_label-result.png")


def test_sfw_video_evaluator_matches_jax(tmp_path, variables, state_dict):
    kw = dict(variant="gsc", data_dirs_test=(
        os.path.join(TF_REF, "sfw_video_synth", "*"),))
    ours, theirs = _pair("sfw_video", tmp_path, variables, state_dict,
                         "SFWVideoEvaluator", **kw)
    batch, box, name = next(iter(Dataset(ours.config, "test", dset="sfw")))
    a = ours.run_one(batch, box, name, export_bbox_dir=str(tmp_path / "bb"))
    b = theirs.run_one(batch, box, name)
    assert a["pred"].shape == (10, S, S, 3)
    np.testing.assert_allclose(a["pred"], b["pred"], atol=1e-4)
    np.testing.assert_allclose(a["mask_pred"], b["mask_pred"], atol=1e-4)
    (mat,) = os.listdir(tmp_path / "bb")
    np.testing.assert_array_equal(
        scipy.io.loadmat(str(tmp_path / "bb" / mat))["bbox"].reshape(4), box)


@pytest.mark.parametrize("device_geometry", [False, True])
def test_in_the_wild_evaluator_matches_jax(tmp_path, variables, state_dict,
                                           device_geometry):
    kw = dict(eval_views=2, device_geometry=device_geometry, data_dirs_test=(
        os.path.join(TF_REF, "sfw_video_synth", "*"),))
    ours, theirs = _pair("in_the_wild", tmp_path, variables, state_dict,
                         "InTheWildEvaluator", **kw)
    batch, box, name = next(iter(Dataset(ours.config, "test")))
    a = ours.run_one(batch, box, name)
    b = theirs.run_one(batch, box, name)
    assert os.path.isfile(a["result_path"])
    np.testing.assert_allclose(a["pred"], b["pred"], atol=1e-4)
    np.testing.assert_allclose(a["mask_pred"], b["mask_pred"], atol=1e-4)
