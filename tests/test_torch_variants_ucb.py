"""The UCB evaluation of the TSM and RGB variants: the port's UCBEvaluator
against the JAX package's on a synthetic UCB tree of 3 images, at 128 px
and n_res=2 with shared weights, on the CPU (TSM at 256 px: its protocol
takes the 256 px part masks unresized).  TSM: the host-orchestrated
protocol (run_one_tsm) against the fused one, one image and k images a
pass; RGB: the simple face-mask composite (run_one_simple) and the
heuristic pipeline (rgb_heuristics=True)."""

import os

import numpy as np
import pytest
import torch

from blindshadowremoval_tpu.config import get_config as jax_config
from blindshadowremoval_tpu.data.dataset import Dataset as JaxDataset
from blindshadowremoval_tpu.eval import evaluators as jax_ev
from blindshadowremoval_tpu_torch.config import get_config
from blindshadowremoval_tpu_torch.data.dataset import Dataset
from blindshadowremoval_tpu_torch.eval import evaluators
from blindshadowremoval_tpu_torch.eval.postprocess import TSM_PARAMS
from blindshadowremoval_tpu_torch.models.weights import from_jax_variables
from chip_smoke import synthetic_ucb_tree
from test_torch_variants_eval import jax_golden_variables

S = 128
N_RES = 2
UCB_IMAGES = 3


@pytest.fixture(autouse=True)
def two_threads():
    """Six test workers share the machine: a wide thread pool in each
    costs more than it saves."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _evaluators(tmp, root, variant, size):
    """(port UCBEvaluator on the CPU, JAX UCBEvaluator) of `variant` with
    the TF-golden weight recipe."""
    variables = jax_golden_variables(variant)
    kw = dict(variant=variant, img_size=size, n_res=N_RES,
              compute_dtype="float32", eval_views=2, part_mask_root=root,
              data_dirs_test=(os.path.join(root, "input", "*"),))
    ours = evaluators.UCBEvaluator(
        get_config("ucb", checkpoint_dir=str(tmp / "port"), **kw),
        from_jax_variables(variables), device="cpu")
    theirs = jax_ev.UCBEvaluator(
        jax_config("ucb", checkpoint_dir=str(tmp / "jax"), **kw), variables)
    return ours, theirs


def _run(ev, dataset_cls, root, **kw):
    return ev.run(dataset_cls(ev.config, "test"), root, **kw)


@pytest.fixture(scope="module")
def tsm(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tsm")
    root = synthetic_ucb_tree(str(tmp / "tree"), n_images=UCB_IMAGES)
    ours, theirs = _evaluators(tmp, root, "tsm", 256)
    out = {"root": root, "ev": ours}
    for label, kw in (("host", dict(fused=False)), ("fused", {})):
        out[f"port {label}"] = _run(ours, Dataset, root, **kw)
        out[f"jax {label}"] = _run(theirs, JaxDataset, root, **kw)
    return out


def _close(ours, theirs, share=1e-3):
    assert len(ours) == len(theirs) == UCB_IMAGES
    for a, b in zip(ours, theirs):
        assert a["detected"].shape == b["detected"].shape
        # identical in the common case; a map value within f32 rounding of
        # a threshold may move a pixel
        assert np.mean(a["detected"] != b["detected"]) <= share
        assert abs(a["psnr"] - b["psnr"]) <= 0.01
        assert abs(a["ssim"] - b["ssim"]) <= 1e-4


@pytest.mark.parametrize("path", ["host", "fused"])
def test_tsm_ucb_matches_jax(tsm, path):
    _close(tsm[f"port {path}"], tsm[f"jax {path}"])


def test_tsm_ucb_host_equals_fused(tsm):
    """run_one_tsm (anchor + mirror at frame=1, TSM_PARAMS, unresized part
    masks, composite before the resize) against the fused step's "tsm"
    protocol: the same masks."""
    for a, b in zip(tsm["port fused"], tsm["port host"]):
        np.testing.assert_array_equal(a["detected"], b["detected"])
        assert abs(a["psnr"] - b["psnr"]) <= 0.01
        assert abs(a["ssim"] - b["ssim"]) <= 1e-4
        # the fused composite leaves as uint8
        assert np.abs(a["pred"] - b["pred"]).max() <= 0.5 / 255 + 1e-4


@pytest.mark.parametrize("k", [2, 8])
def test_tsm_ucb_images_per_call_equals_per_image(tsm, k):
    """k images a pass (k=2: a full pass and a padded tail; k=8: one pass,
    16 views through the generator at once) equal one image a pass."""
    ev = tsm["ev"]
    batched = _run(ev, Dataset, tsm["root"], images_per_call=k)
    assert len(ev.label_iterations) == -(-UCB_IMAGES // k)
    for a, b in zip(batched, tsm["port fused"]):
        np.testing.assert_array_equal(a["detected"], b["detected"])
        np.testing.assert_array_equal(a["pred"], b["pred"])
        assert abs(a["psnr"] - b["psnr"]) <= 1e-4
        assert abs(a["ssim"] - b["ssim"]) <= 1e-5


def test_tsm_ucb_ships_the_offset_maps(tsm):
    ev = tsm["ev"]
    batch = next(iter(Dataset(ev.config, "test")))[0]
    assert batch["img"].shape[0] == 2   # anchor + mirror
    assert set(ev._ingress(batch)) == {"img", "gt", "uv", "reg"}
    assert ev._protocol(None) == (TSM_PARAMS, "tsm")


@pytest.fixture(scope="module")
def rgb(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("rgb")
    root = synthetic_ucb_tree(str(tmp / "tree"), n_images=UCB_IMAGES)
    ours, theirs = _evaluators(tmp, root, "rgb", S)
    return {"root": root, "ours": ours, "theirs": theirs}


def test_rgb_ucb_simple_matches_jax(rgb):
    """run_one_simple: the raw prediction composited through the rounded
    face(+hair) mask, no heuristics."""
    ours = _run(rgb["ours"], Dataset, rgb["root"])
    theirs = _run(rgb["theirs"], JaxDataset, rgb["root"])
    _close(ours, theirs, share=0.0)
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a["pred"], b["pred"], rtol=0, atol=1e-4)


@pytest.mark.parametrize("path", ["host", "fused"])
def test_rgb_ucb_heuristics_match_jax(rgb, path):
    """rgb_heuristics=True: the heuristic pipeline on the grayscale
    difference of the RGB output."""
    kw = dict(rgb_heuristics=True, fused=path == "fused")
    _close(_run(rgb["ours"], Dataset, rgb["root"], **kw),
           _run(rgb["theirs"], JaxDataset, rgb["root"], **kw))


def test_rgb_ucb_routes(rgb):
    ev = rgb["ours"]
    with pytest.raises(ValueError, match="fused path"):
        _run(ev, Dataset, rgb["root"], images_per_call=2)
    with pytest.raises(ValueError, match="rgb_heuristics"):
        _run(ev, Dataset, rgb["root"], params=TSM_PARAMS)
    batched = _run(ev, Dataset, rgb["root"], rgb_heuristics=True,
                   images_per_call=2)
    fused = _run(ev, Dataset, rgb["root"], rgb_heuristics=True)
    for a, b in zip(batched, fused):
        np.testing.assert_array_equal(a["detected"], b["detected"])
