"""The UCB evaluation as a whole: the port's UCBEvaluator
(eval/evaluators.py) against the JAX package's on a synthetic UCB tree of 3
images, host-orchestrated and fused, and the fused path k images a pass,
at 128 px and n_res=2 with shared weights, on the CPU."""

import os

import jax
import numpy as np
import pytest
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
from chip_smoke import synthetic_ucb_tree

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


@pytest.fixture(scope="module")
def ucb(tmp_path_factory, variables, state_dict):
    """A synthetic UCB tree of 3 images, and the port's and the JAX
    package's results on it: host-orchestrated and fused."""
    tmp = tmp_path_factory.mktemp("ucb")
    root = synthetic_ucb_tree(str(tmp / "tree"), n_images=UCB_IMAGES)
    kw = dict(eval_views=2, part_mask_root=root,
              data_dirs_test=(os.path.join(root, "input", "*"),))
    ours, theirs = _pair("ucb", tmp, variables, state_dict, "UCBEvaluator",
                         **kw)
    out = {"root": root, "ev": ours}
    for label, fused in (("host", False), ("fused", True)):
        out[f"port {label}"] = ours.run(Dataset(ours.config, "test"), root,
                                        fused=fused)
        out[f"jax {label}"] = theirs.run(JaxDataset(theirs.config, "test"),
                                         root, fused=fused)
    return out


@pytest.mark.parametrize("path", ["host", "fused"])
def test_ucb_evaluator_matches_jax(ucb, path):
    ours, theirs = ucb[f"port {path}"], ucb[f"jax {path}"]
    assert len(ours) == len(theirs) == UCB_IMAGES
    for a, b in zip(ours, theirs):
        assert a["detected"].shape == (S, S, 3)
        # identical in the common case; a map value within f32 rounding of
        # a threshold may move a pixel
        assert np.mean(a["detected"] != b["detected"]) <= 1e-3
        assert abs(a["psnr"] - b["psnr"]) <= 0.01
        assert abs(a["ssim"] - b["ssim"]) <= 1e-4


def test_ucb_fused_equals_host(ucb):
    for a, b in zip(ucb["port fused"], ucb["port host"]):
        np.testing.assert_array_equal(a["detected"], b["detected"])
        assert abs(a["psnr"] - b["psnr"]) <= 0.01
        assert abs(a["ssim"] - b["ssim"]) <= 1e-4
        # the fused composite leaves as uint8
        assert np.abs(a["pred"] - b["pred"]).max() <= 0.5 / 255 + 1e-4


def test_ucb_images_per_call_equals_per_image(ucb):
    """k=2 over 3 images: one full pass and one padded tail."""
    ev = ucb["ev"]
    batched = ev.run(Dataset(ev.config, "test"), ucb["root"],
                     images_per_call=2)
    assert len(batched) == UCB_IMAGES and len(ev.label_iterations) == 2
    for a, b in zip(batched, ucb["port fused"]):
        np.testing.assert_array_equal(a["detected"], b["detected"])
        np.testing.assert_array_equal(a["pred"], b["pred"])
        assert abs(a["psnr"] - b["psnr"]) <= 1e-4
        assert abs(a["ssim"] - b["ssim"]) <= 1e-5
    with pytest.raises(ValueError, match="fused"):
        ev.run(Dataset(ev.config, "test"), ucb["root"], fused=False,
               images_per_call=2)


@pytest.mark.parametrize("wire", ["compact_ingress", "device_geometry"])
def test_ucb_fused_wires(ucb, tmp_path, state_dict, wire):
    """uint16 ingress (dequantized on the device) and geometry rasterized on
    the device: the same detected masks as the f32 host-maps run, metrics
    within the 1/65535 quantization's reach."""
    ev = ucb["ev"]
    cfg = get_config("ucb", **_kw(tmp_path, eval_views=2, **{wire: True},
                                  part_mask_root=ucb["root"],
                                  data_dirs_test=ev.config.data_dirs_test))
    other = evaluators.UCBEvaluator(cfg, state_dict, device="cpu")
    batch = next(iter(Dataset(cfg, "test")))[0]
    sent = other._ingress(batch)
    if wire == "compact_ingress":
        assert set(sent) == {"img", "gt", "uv"}
        assert all(t.dtype == torch.uint16 for t in sent.values())
    else:
        assert "uv" not in sent and sent["uv_tris"].dtype == torch.int32
    for a, b in zip(other.run(Dataset(cfg, "test"), ucb["root"]),
                    ucb["port fused"]):
        np.testing.assert_array_equal(a["detected"], b["detected"])
        assert np.abs(a["pred"] - b["pred"]).max() <= 1.5 / 255
        assert abs(a["psnr"] - b["psnr"]) <= 0.01
        assert abs(a["ssim"] - b["ssim"]) <= 1e-4


def test_ucb_name_keyed_masks_refuse_a_mismatch(ucb, tmp_path):
    """run() pairs part masks by file name: a mask directory whose names do
    not follow `<id>_<stem>-result.png` raises instead of pairing by
    position (as tests/test_eval.py checks for the JAX package)."""
    import shutil

    root = str(tmp_path / "tree")
    shutil.copytree(ucb["root"], root)
    ev = ucb["ev"]
    d = os.path.join(root, ev.PART_DIRS["nose"])
    os.rename(os.path.join(d, "id0_0-result.png"),
              os.path.join(d, "something_else.png"))
    cfg = get_config("ucb", **_kw(tmp_path, eval_views=2, part_mask_root=root,
                                  data_dirs_test=(
                                      os.path.join(root, "input", "*"),)))
    with pytest.raises(FileNotFoundError, match="key_masks_by_name"):
        ev.run(Dataset(cfg, "test"), root)
    # on the intact tree the reference's positional pairing reads the same
    # masks as the name-keyed one
    name = Dataset(ev.config, "test").name_list[0]
    by_pos = ev._load_part_masks(ucb["root"], 0)
    by_name = ev._load_part_masks(ucb["root"], 0, sample_name=name)
    for key in ev.PART_DIRS:
        np.testing.assert_array_equal(by_pos[key], by_name[key])


def test_evaluators_refuse_unported_protocols(ucb):
    ev = ucb["ev"]
    with pytest.raises(NotImplementedError, match="ROADMAP D1"):
        ev.run_one_tsm()
    with pytest.raises(NotImplementedError, match="ROADMAP D2"):
        ev.run_one_simple()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            evaluators.SFWEvaluator(get_config(n_res=N_RES))
