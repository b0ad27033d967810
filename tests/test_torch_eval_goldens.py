"""The port's evaluators against the TF-reference goldens at full width
(256 px, n_res=6), port only, on the CPU: SFW-GSC against e2e_sfw_gsc.npz
with the bars of tests/test_tf_ref_e2e.py:186-189, and in-the-wild (A7)
against e2e_eval.npz."""

import os

import numpy as np
import pytest
import torch

from blindshadowremoval_tpu_torch.config import get_config
from blindshadowremoval_tpu_torch.data.dataset import Dataset
from blindshadowremoval_tpu_torch.eval import evaluators
from blindshadowremoval_tpu_torch.models.generator import GSCGenerator
from blindshadowremoval_tpu_torch.models.weights import (
    generator_mapping,
    load_tf_weights,
    synthetic_tf_weights,
)

TF_REF = os.path.join(os.path.dirname(__file__), "goldens", "tf_ref")


@pytest.fixture(autouse=True)
def two_threads():
    """Six test workers share the machine: a wide thread pool in each
    costs more than it saves."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _golden_state_dict():
    mapping = generator_mapping()
    weights = synthetic_tf_weights(GSCGenerator().state_dict(), mapping, 0)
    weights["generator/clr_conv3/conv/bias"] += 0.5
    return load_tf_weights(weights, mapping)


def _psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float32)
                         - np.asarray(b, np.float32)) ** 2))
    return 99.0 if mse == 0 else float(10.0 * np.log10(1.0 / mse))


def test_sfw_gsc_tf_golden_full_width(tmp_path):
    """tests/test_tf_ref_e2e.py:152-189's bars, port only, 256 px, n_res=6."""
    golden = np.load(os.path.join(TF_REF, "e2e_sfw_gsc.npz"))
    cfg = get_config("sfw", variant="gsc", compute_dtype="float32",
                     checkpoint_dir=str(tmp_path), data_dirs_test=(
                         os.path.join(TF_REF, "sfw_gsc_synth", "*"),))
    batch, box, name = next(iter(Dataset(cfg, "test", dset="sfw")))
    assert batch["img"].shape == (10, 256, 256, 3)
    r = evaluators.SFWEvaluator(cfg, _golden_state_dict(),
                                device="cpu").run_one(batch, box, "sfwgsc0")
    assert abs(r["auc"] - float(golden["sfw_gsc_auc"])) <= 1e-3
    assert abs(r["psnr"] - float(golden["sfw_gsc_psnr"])) <= 0.05
    assert abs(r["ssim"] - float(golden["sfw_gsc_ssim"])) <= 0.005
    assert _psnr(r["mask_pred"], golden["sfw_gsc_mask_pred"]) >= 40.0


def test_in_the_wild_tf_golden_full_width(tmp_path):
    """A7: InTheWildEvaluator on the e2e_eval.npz maps, >= 45 dB."""
    golden = np.load(os.path.join(TF_REF, "e2e_eval.npz"))
    batch = {k: golden[f"ffhq_{src}"].astype(np.float32)[None]
             for k, src in (("img", "input"), ("uv", "uv"), ("face", "face"))}
    cfg = get_config(compute_dtype="float32", eval_views=1,
                     device_geometry=False, checkpoint_dir=str(tmp_path))
    r = evaluators.InTheWildEvaluator(cfg, _golden_state_dict(),
                                      device="cpu").run_one(
        batch, np.zeros(4, np.float32), "02165")
    assert _psnr(r["pred"], golden["ffhq_pred"]) >= 45.0
    assert r["mask_pred"].shape == (256, 256, 1)
