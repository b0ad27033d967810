"""The port's train data pipeline against the JAX package's, on the CPU:
the crop augmentation (geometry/crop.py), the host shadow synthesis
(data/synthesis.py: ShadowMaker, shadow_synthesis_host), the train parser
and its pool of parse processes (data/dataset.py), with the same numpy
seeds.  cv2 serves as the oracle of the rotation and the box blur; the
port imports neither cv2 nor the JAX package."""

import gc
import multiprocessing
import os
import shutil
import subprocess
import sys
import threading
import time

import cv2
import numpy as np
import pytest
import torch

from blindshadowremoval_tpu.config import get_config as jax_config
from blindshadowremoval_tpu.data import synthesis as jsyn
from blindshadowremoval_tpu.data.dataset import Dataset as JaxDataset
from blindshadowremoval_tpu.geometry import crop as jcrop
from blindshadowremoval_tpu_torch.config import get_config
from blindshadowremoval_tpu_torch.data import synthesis as tsyn
from blindshadowremoval_tpu_torch.data.dataset import Dataset
from blindshadowremoval_tpu_torch.geometry import crop as tcrop
from blindshadowremoval_tpu_torch.geometry.landmarks import LM_REF
from blindshadowremoval_tpu_torch.geometry.triangulation import (
    generate_face_region,
)
from blindshadowremoval_tpu_torch.ops.filters import box_blur
from blindshadowremoval_tpu_torch.utils.imageio import write_png

FRAMES = os.path.join(os.path.dirname(__file__), "goldens", "tf_ref",
                      "sfw_gsc_synth", "vid0")
S = 64
# cv2.warpAffine (OpenCV 5): an f64 image goes through the fixed-point
# remap (positions rounded to 1/32 pixel), which the port reproduces
# (measured 2.2e-16); an f32 one is sampled at positions placed in f32,
# where the port places them in f64 (measured 6.2e-6 on uniform noise)
ROT_TOL = 2e-5
# the occluder masks: resize (f64 matrices here, f32 in cv2), rotation and
# box blur in other orders: measured below 3e-6
MASK_TOL = 2e-5


@pytest.fixture(autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def fresh_pools(monkeypatch):
    """Both packages' procedural-mask pools start empty (they are
    process-wide)."""
    tsyn.ShadowMaker.reset_pool()
    monkeypatch.setattr(jsyn.ShadowMaker, "_MASK_POOL", [])
    yield
    tsyn.ShadowMaker.reset_pool()


@pytest.fixture(scope="module")
def mask_lib(tmp_path_factory):
    """A library of 4 gray occluder PNGs (soft blobs and bars)."""
    d = tmp_path_factory.mktemp("masks")
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[:120, :100] / 100.0
    for i in range(4):
        cy, cx, r = rng.uniform(0.3, 0.7, 3)
        m = ((yy - cy) ** 2 + (xx - cx) ** 2 < (0.3 * r) ** 2) | (
            np.abs(xx - cx) < 0.05 * (i + 1))
        write_png(str(d / f"m{i}.png"), (m * 255).astype(np.uint8))
    return str(d)


@pytest.fixture(scope="module")
def train_tree(tmp_path_factory):
    """Two identities of two frames each (the sfw_gsc_synth faces)."""
    root = tmp_path_factory.mktemp("train")
    for ident, frames in (("id0", (0, 1)), ("id1", (2, 3))):
        os.makedirs(root / ident)
        for f in frames:
            for ext in ("png", "npy"):
                shutil.copy(os.path.join(FRAMES, f"{f}.{ext}"),
                            root / ident / f"{f}.{ext}")
    return str(root)


# ------------------------------------------------------------ crop
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("deg", [-9.7, 0.0, 3.3, 45.0, 187.0])
@pytest.mark.parametrize("shape", [(64, 80, 3), (57, 57), (40, 31, 1)])
def test_rotate_center_matches_cv2(deg, shape, dtype):
    x = np.random.default_rng(1).uniform(size=shape).astype(dtype)
    out = tcrop.rotate_center(x, deg)
    ref = jcrop.rotate_center(x, deg)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    assert np.abs(out - ref).max() <= (ROT_TOL if dtype == np.float32
                                       else 1e-12)


@pytest.mark.parametrize("deg", [-7.5, 4.0])
def test_rotate_image_and_landmarks_matches_jax(deg):
    img = np.random.default_rng(2).uniform(size=(48, 60, 3))
    lm = np.load(os.path.join(FRAMES, "5.npy")) * 0.2
    out_img, out_lm = tcrop.rotate_image_and_landmarks(img, lm, deg)
    ref_img, ref_lm = jcrop.rotate_image_and_landmarks(img, lm, deg)
    np.testing.assert_array_equal(out_lm, ref_lm)
    assert out_lm.dtype == ref_lm.dtype
    np.testing.assert_allclose(out_img, ref_img, rtol=0, atol=1e-12)


@pytest.mark.parametrize("seed", range(6))
def test_face_crop_augmented_matches_jax(seed):
    img = cv2.cvtColor(cv2.imread(os.path.join(FRAMES, "5.png")),
                       cv2.COLOR_BGR2RGB) / 255.0
    lm = np.load(os.path.join(FRAMES, "5.npy"))
    r_t, r_j = np.random.default_rng(seed), np.random.default_rng(seed)
    out = tcrop.face_crop_and_resize(img, lm, S, aug=True, rng=r_t)
    ref = jcrop.face_crop_and_resize(img, lm, S, aug=True, rng=r_j)
    np.testing.assert_array_equal(out[3], ref[3])                  # box
    for a, b in zip(out[1:3], ref[1:3]):                         # landmarks
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    # a crop of the rotated image, resampled: the rotation's tolerance
    np.testing.assert_allclose(out[0], ref[0], rtol=0, atol=ROT_TOL)
    assert r_t.integers(0, 2 ** 31) == r_j.integers(0, 2 ** 31)


@pytest.mark.parametrize("k", [5, 6, 7, 10, 11, 14])
def test_box_blur_matches_cv2_even_and_odd(k):
    """cv2 anchors an even box at k // 2 with BORDER_REFLECT_101."""
    x = np.random.default_rng(k).uniform(size=(37, 29)).astype(np.float32)
    out = box_blur(torch.from_numpy(x)[None, :, :, None], k)[0, ..., 0]
    assert out.shape == x.shape
    np.testing.assert_allclose(out.numpy(), cv2.blur(x, (k, k)), rtol=0,
                               atol=1e-6)


# ----------------------------------------------------- ShadowMaker
@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("seed", range(6))
def test_shadow_maker_library_matches_jax(mask_lib, seed, gated):
    """With a mask library every draw is numpy's, so one seed gives both
    packages the same occluder (both placements occur over the seeds)."""
    lm = LM_REF.astype(np.float32)
    face = generate_face_region(lm, S) if gated else None
    r_t, r_j = np.random.default_rng(seed), np.random.default_rng(seed)
    t = tsyn.ShadowMaker(face, lm, mask_dir=mask_lib, rng=r_t, size=S)
    j = jsyn.ShadowMaker(face, lm, mask_dir=mask_lib, rng=r_j, size=S)
    assert t.mask_shape == j.mask_shape
    np.testing.assert_array_equal(t.mask_center, j.mask_center)
    np.testing.assert_allclose(t.mask, j.mask, rtol=0, atol=MASK_TOL)
    for time_step in (0.0, 2.5):
        (mt, ft), (mj, fj) = t.compute_mask(time_step), j.compute_mask(
            time_step)
        np.testing.assert_allclose(mt, mj, rtol=0, atol=MASK_TOL)
        assert (ft is None) == (fj is None)
    assert r_t.integers(0, 2 ** 31) == r_j.integers(0, 2 ** 31)


def test_shadow_maker_procedural_pool(fresh_pools):
    """Without a library the masks come from a Perlin pool; the port
    renders them from its own torch draws, seeded from the same numpy
    draw, so the masks differ from JAX's but the numpy streams stay
    aligned.  Checked: shape, range, coverage, the pool and the stream."""
    lm = LM_REF.astype(np.float32)
    covers = []
    for seed in range(8):
        r_t, r_j = np.random.default_rng(seed), np.random.default_rng(seed)
        t = tsyn.ShadowMaker(None, lm, rng=r_t, size=S)
        jsyn.ShadowMaker(None, lm, rng=r_j, size=S)
        assert r_t.integers(0, 2 ** 31) == r_j.integers(0, 2 ** 31)
        canvas, face = t.compute_mask(0.0)
        assert face is None and canvas.shape == (S, S, 1)
        assert canvas.dtype == np.float32
        assert 0.0 <= canvas.min() and canvas.max() <= 1.0 + 1e-6
        covers.append(float((canvas > 0.5).mean()))
    assert len(tsyn.ShadowMaker._MASK_POOL) == 8
    for m in tsyn.ShadowMaker._MASK_POOL:
        assert m.shape == (256, 256) and set(np.unique(m)) <= {0.0, 1.0}
        assert 0.02 < m.mean() < 0.98
    # occluders cover some of the canvas, not all of it, on the whole
    assert 0.02 < np.mean(covers) < 0.95
    tsyn.ShadowMaker.reset_pool()
    assert tsyn.ShadowMaker._MASK_POOL == []


@pytest.mark.parametrize("seed", range(3))
def test_shadow_synthesis_host_matches_jax(mask_lib, seed):
    gt = np.random.default_rng(9).uniform(0.1, 0.9, (S, S, 3)).astype(
        np.float32)
    lm = LM_REF.astype(np.float32)
    # the raw wire (no tone draw): every output agrees
    r_t, r_j = np.random.default_rng(seed), np.random.default_rng(seed)
    out = tsyn.shadow_synthesis_host(gt, lm, 0.0, mask_dir=mask_lib,
                                     rng=r_t, darken=False)
    ref = jsyn.shadow_synthesis_host(gt, lm, 0.0, mask_dir=mask_lib,
                                     rng=r_j, darken=False)
    np.testing.assert_array_equal(out[0], ref[0])
    assert out[1] is None and ref[1] is None
    np.testing.assert_allclose(out[2], ref[2], rtol=0, atol=MASK_TOL)
    np.testing.assert_allclose(out[4], ref[4], rtol=0, atol=1e-5)
    # the host tone curve: its gains are torch's draws, seeded from the
    # same numpy draw; the mask and the stream still agree
    r_t, r_j = np.random.default_rng(seed), np.random.default_rng(seed)
    img, dark, mask, ctm, _ = tsyn.shadow_synthesis_host(
        gt, lm, 0.0, mask_dir=mask_lib, rng=r_t)
    ref = jsyn.shadow_synthesis_host(gt, lm, 0.0, mask_dir=mask_lib,
                                     rng=r_j)
    np.testing.assert_allclose(mask, ref[2], rtol=0, atol=MASK_TOL)
    assert img.shape == dark.shape == gt.shape and ctm.shape == (3, 3)
    assert np.isfinite(img).all() and np.isfinite(dark).all()
    assert r_t.integers(0, 2 ** 31) == r_j.integers(0, 2 ** 31)


# ------------------------------------------------------ train parser
def _configs(tree, mask_lib, **kw):
    kw = dict(img_size=S, data_dirs=(os.path.join(tree, "*"),),
              shadow_mask_dir=mask_lib, **kw)
    return get_config("train", **kw), jax_config("train", **kw)


def _compare_samples(ours, theirs, skip=()):
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        assert ours[k].shape == v.shape and ours[k].dtype == v.dtype, k
        if k in skip:
            continue
        if k.endswith("_tris") or k == "lm":
            np.testing.assert_array_equal(ours[k], v, err_msg=k)
        elif k == "mask":
            np.testing.assert_allclose(ours[k], v, rtol=0, atol=MASK_TOL,
                                       err_msg=k)
        else:
            # gt: a crop of the rotated frame (ROT_TOL); the host maps:
            # f32 rounding of the two rasterizers
            np.testing.assert_allclose(ours[k], v, rtol=0, atol=ROT_TOL,
                                       err_msg=k)


@pytest.mark.parametrize("device_geometry", [False, True])
def test_parse_train_device_darken_matches_jax(train_tree, mask_lib,
                                               device_geometry):
    """device_darken: no tone draw, so every key agrees, in both geometry
    wires, over seeds that rotate and seeds that do not."""
    ours_cfg, jax_cfg = _configs(train_tree, mask_lib, device_darken=True,
                                 device_geometry=device_geometry)
    ours, theirs = Dataset(ours_cfg, "train"), JaxDataset(jax_cfg, "train")
    assert sorted(ours.name_list) == sorted(theirs.name_list)
    for seed in range(4):
        r_t, r_j = np.random.default_rng(seed), np.random.default_rng(seed)
        for d in sorted(ours.name_list):
            a = ours.parse_train(d, rng=r_t)
            b = theirs.parse_train(d, rng=r_j)
            _compare_samples(a, b)
            assert "img_dark" not in a
            assert a["gt"].shape == (2, S, S, 3)
        assert r_t.integers(0, 2 ** 31) == r_j.integers(0, 2 ** 31)


def test_parse_train_host_tone_curve(train_tree, mask_lib):
    """The host tone curve draws its gains from torch: gt and img_dark
    differ from JAX's, the geometry and the mask agree, and the numpy
    streams stay aligned."""
    ours_cfg, jax_cfg = _configs(train_tree, mask_lib)
    ours, theirs = Dataset(ours_cfg, "train"), JaxDataset(jax_cfg, "train")
    for seed in range(3):
        r_t, r_j = np.random.default_rng(seed), np.random.default_rng(seed)
        d = sorted(ours.name_list)[seed % 2]
        a, b = ours.parse_train(d, rng=r_t), theirs.parse_train(d, rng=r_j)
        _compare_samples(a, b, skip=("gt", "img_dark"))
        np.testing.assert_array_equal(a["gt"][1], a["gt"][0][:, ::-1])
        np.testing.assert_array_equal(a["img_dark"][1],
                                      a["img_dark"][0][:, ::-1])
        assert r_t.integers(0, 2 ** 31) == r_j.integers(0, 2 ** 31)


def test_train_and_val_modes_list_their_dirs(train_tree, mask_lib):
    cfg = get_config("train", img_size=S,
                     data_dirs=(os.path.join(train_tree, "id0"),),
                     data_dirs_val=(os.path.join(train_tree, "*"),))
    assert Dataset(cfg, "train").name_list == [
        os.path.join(train_tree, "id0")]
    assert sorted(Dataset(cfg, "val").name_list) == sorted(
        JaxDataset(jax_config("train", data_dirs_val=cfg.data_dirs_val),
                   "val").name_list)


def test_train_iter_yields_and_releases_workers(train_tree, mask_lib):
    """The worker processes live as long as their iterator (the JAX
    package's threads, tests/test_dataset_lifecycle.py), and the samples
    they parse are the train parser's."""
    cfg = get_config("train", img_size=S, device_geometry=True,
                     device_darken=True, shadow_mask_dir=mask_lib,
                     data_dirs=(os.path.join(train_tree, "*"),))
    gc.collect()
    base = threading.active_count()
    for seed in range(2):
        it = iter(Dataset(cfg, "train", seed=seed, workers=2))
        sample = next(it)
        assert sorted(sample) == ["face_pts", "face_tris", "gt", "lm",
                                  "mask", "reg_tris", "uv_tris"]
        assert sample["gt"].shape == (2, S, S, 3)
        assert sample["uv_tris"].dtype == np.int32
        assert len(multiprocessing.active_children()) >= 2
        it.close()
        del it
    gc.collect()
    for _ in range(100):
        if (threading.active_count() <= base
                and not multiprocessing.active_children()):
            break
        time.sleep(0.2)
    assert threading.active_count() <= base, (
        f"{threading.active_count() - base} leaked loader threads")
    assert not multiprocessing.active_children(), "leaked parse workers"


_EXIT_WITH_OPEN_ITERATORS = """
import sys
import torch
from blindshadowremoval_tpu_torch.config import get_config
from blindshadowremoval_tpu_torch.data.dataset import Dataset
if __name__ == "__main__":
    torch.set_num_threads(1)
    cfg = get_config("train", img_size={S}, device_geometry=True,
                     device_darken=True, shadow_mask_dir={masks!r},
                     data_dirs=({dirs!r},))
    closed = iter(Dataset(cfg, "train", workers=2))
    next(closed)
    closed.close()
    left_open = iter(Dataset(cfg, "train", seed=1, workers=2))
    next(left_open)
    sys.exit(3)
"""


def _session_members(sid: int) -> list[str]:
    """Command lines of the live processes of session `sid`."""
    out = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            with open(f"/proc/{pid}/cmdline") as f:
                cmd = f.read().replace("\0", " ")
        except OSError:               # ended while listed
            continue
        if int(fields[3]) == sid and fields[0] != "Z":
            out.append(cmd)
    return out


@pytest.mark.skipif(not os.path.isdir("/proc"), reason="reads /proc")
def test_train_iter_leaves_no_process_at_exit(train_tree, mask_lib,
                                              tmp_path):
    """A program that trains ends with no process of its own left: at its
    exit the executors join the parse workers, even those of an iterator
    left open, and the forkserver and resource tracker are stopped and
    waited for (left alone, each outlives the program a moment)."""
    script = tmp_path / "exit_with_open_iterators.py"
    script.write_text(_EXIT_WITH_OPEN_ITERATORS.format(
        S=S, masks=mask_lib, dirs=os.path.join(train_tree, "*")))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join(
               [repo, os.environ.get("PYTHONPATH", "")])}
    proc = subprocess.Popen([sys.executable, str(script)], cwd=tmp_path,
                            env=env, start_new_session=True)
    try:
        assert proc.wait(timeout=240) == 3
    finally:
        proc.kill()
    assert _session_members(proc.pid) == []


def test_train_iter_workers_draw_their_own_streams(train_tree, mask_lib):
    """Worker k draws from SeedSequence(seed)'s k-th child: its samples
    are the parser's with that Generator, whichever worker ran first."""
    cfg = get_config("train", img_size=S, device_geometry=True,
                     device_darken=True, shadow_mask_dir=mask_lib,
                     data_dirs=(os.path.join(train_tree, "*"),))
    ds = Dataset(cfg, "train", seed=7, workers=2)
    it = iter(ds)
    try:
        got = [next(it) for _ in range(4)]
    finally:
        it.close()
    want = []
    for k in range(2):
        rng = np.random.default_rng(np.random.SeedSequence(7, spawn_key=(k,)))
        for _ in range(4):
            d = ds.name_list[int(rng.integers(0, len(ds.name_list)))]
            want.append(ds.parse_train(d, rng=rng))
    for g in got:
        assert any(all(np.array_equal(g[k], w[k]) for k in g) for w in want)
