"""Port's image codec (utils/imageio.py) against cv2 and PIL, and its test
Dataset (data/dataset.py) against the JAX package's, on the CPU at 128 px.
cv2 and PIL serve as oracles here; the port imports neither."""

import glob
import os
import threading
import time

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from blindshadowremoval_tpu.config import get_config as jax_config
from blindshadowremoval_tpu.data.dataset import Dataset as JaxDataset
from blindshadowremoval_tpu_torch.config import get_config
from blindshadowremoval_tpu_torch.data.dataset import (
    Dataset,
    pack_views,
    prefetch,
    unpack_views,
)
from blindshadowremoval_tpu_torch.utils import imageio
from chip_smoke import synthetic_ucb_tree

TF_REF = os.path.join(os.path.dirname(__file__), "goldens", "tf_ref")
FIXTURE_PNGS = sorted(glob.glob(os.path.join(TF_REF, "**", "*.png"),
                                recursive=True))
S = 128


@pytest.fixture(autouse=True)
def two_threads():
    """The host rasterizer's ops are small at 128 px; across 6 test workers
    a wide thread pool per op costs more than it saves."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("path", FIXTURE_PNGS,
                         ids=lambda p: os.path.relpath(p, TF_REF))
def test_png_reader_matches_cv2_and_pil(path):
    np.testing.assert_array_equal(imageio.imread(path), cv2.imread(path))
    np.testing.assert_array_equal(imageio.imread(path, gray=True),
                                  cv2.imread(path, 0))
    raw = imageio.read_png(path)
    pil = np.asarray(Image.open(path))
    np.testing.assert_array_equal(raw.reshape(pil.shape), pil)


def _noisy_ramp(h=70, w=90):
    rng = np.random.default_rng(0)
    ramp = np.linspace(0, 230, w)[None, :, None] * np.ones((h, 1, 3))
    return np.clip(ramp + rng.integers(0, 25, (h, w, 3)), 0, 255).astype(
        np.uint8)


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA"])
def test_png_reader_all_filters(tmp_path, mode):
    """PIL picks a row filter per row (Sub, Up and Paeth on this noisy
    ramp); every mode decodes to what PIL and cv2 decode."""
    x = _noisy_ramp()
    arr = {"RGB": x, "RGBA": np.concatenate([x, x[..., :1]], 2),
           "L": x[..., 0], "LA": x[..., :2]}[mode]
    path = str(tmp_path / "f.png")
    Image.fromarray(arr, mode).save(path)
    np.testing.assert_array_equal(
        imageio.read_png(path).reshape(arr.shape), arr)
    np.testing.assert_array_equal(imageio.imread(path), cv2.imread(path))
    np.testing.assert_array_equal(imageio.imread(path, gray=True),
                                  cv2.imread(path, 0))


def _encode_png(path, arr, kind):
    """Write arr [H, W, C] uint8 as a PNG whose every row uses filter type
    `kind` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth), per the PNG spec."""
    import struct
    import zlib

    h, w, c = arr.shape
    x = arr.reshape(h, w * c).astype(np.int64)
    rows = []
    for r in range(h):
        up = x[r - 1] if r else np.zeros(w * c, np.int64)
        left = np.concatenate([np.zeros(c, np.int64), x[r, :-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), up[:-c]])
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = up
        elif kind == 3:
            pred = (left + up) // 2
        else:
            p = left + up - upleft
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, upleft))
        rows.append(bytes([kind]) + ((x[r] - pred) % 256).astype(
            np.uint8).tobytes())

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body)))

    colour = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n"
                 + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour,
                                              0, 0, 0))
                 + chunk(b"IDAT", zlib.compress(b"".join(rows)))
                 + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
def test_png_reader_each_filter(tmp_path, kind, channels):
    x = _noisy_ramp()
    arr = np.concatenate([x, x], 2)[..., :channels]
    path = str(tmp_path / "k.png")
    _encode_png(path, arr, kind)
    np.testing.assert_array_equal(imageio.read_png(path), arr)
    np.testing.assert_array_equal(np.asarray(Image.open(path)).reshape(
        arr.shape), arr)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_writer_round_trip(tmp_path, channels):
    x = _noisy_ramp()
    arr = np.concatenate([x, x[..., :1]], 2)[..., :channels]
    path = str(tmp_path / "w.png")
    imageio.write_png(path, arr)
    back = np.asarray(Image.open(path))
    np.testing.assert_array_equal(back.reshape(arr.shape), arr)
    np.testing.assert_array_equal(imageio.read_png(path), arr.reshape(
        arr.shape[:2] + (channels,)))


@pytest.mark.parametrize("dsize", [(234, 234), (300, 280), (128, 128),
                                   (17, 9), (256, 256)])
def test_resize_linear_matches_cv2(dsize):
    rng = np.random.default_rng(0)
    img = rng.uniform(size=(256, 256, 3)).astype(np.float32)
    ref = cv2.resize(img, dsize, interpolation=cv2.INTER_LINEAR)
    out = imageio.resize_linear(img, dsize)
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= 1e-5
    ref2 = cv2.resize(img[..., 0], dsize, interpolation=cv2.INTER_LINEAR)
    assert np.abs(imageio.resize_linear(img[..., 0], dsize)
                  - ref2).max() <= 1e-5


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


@pytest.mark.parametrize("device_geometry", [False, True])
@pytest.mark.parametrize("preset,folder", [("sfw", "sfw_gsc_synth"),
                                           ("sfw_video", "sfw_video_synth")])
def test_dataset_matches_jax(preset, folder, device_geometry):
    kw = dict(variant="gsc", img_size=S, device_geometry=device_geometry,
              data_dirs_test=(os.path.join(TF_REF, folder, "*"),))
    ours = Dataset(get_config(preset, **kw), "test", dset="sfw")
    theirs = JaxDataset(jax_config(preset, **kw), "test", dset="sfw")
    assert ours.name_list == theirs.name_list
    _compare_batches(next(iter(ours)), next(iter(theirs)))


def test_ucb_dataset_draws_the_same_views(tmp_path):
    root = synthetic_ucb_tree(str(tmp_path / "ucb"), n_images=3)
    kw = dict(img_size=S, eval_views=3, device_geometry=True,
              data_dirs_test=(os.path.join(root, "input", "*"),),
              part_mask_root=root)
    ours = Dataset(get_config("ucb", **kw), "test", seed=3)
    theirs = JaxDataset(jax_config("ucb", **kw), "test", seed=3)
    assert ours.name_list == theirs.name_list and len(ours.name_list) == 3
    for a, b in zip(ours, theirs):
        assert a[0]["img"].shape == (3, S, S, 3)
        _compare_batches(a, b)


def test_in_the_wild_dataset_matches_jax():
    kw = dict(img_size=S, eval_views=2, device_geometry=False,
              data_dirs_test=(os.path.join(TF_REF, "sfw_video_synth", "*"),))
    ours = Dataset(get_config(**kw), "test")
    theirs = JaxDataset(jax_config(**kw), "test")
    assert ours.name_list == theirs.name_list
    a, b = next(iter(ours)), next(iter(theirs))
    # gt = the anchor's input (dataset.py:622-623), on every view
    np.testing.assert_array_equal(a[0]["gt"][1], a[0]["img"][0])
    _compare_batches(a, b)


def test_pack_unpack_roundtrip():
    rng = np.random.default_rng(0)
    view = {k: rng.uniform(size=(2, 8, 8, c)).astype(np.float32)
            for k, c in (("img", 3), ("gt", 3), ("uv", 3), ("reg", 6),
                         ("face", 1))}
    packed = pack_views(view)
    assert packed.shape == (2, 8, 8, 16)
    for k, v in unpack_views(packed).items():
        np.testing.assert_array_equal(v, view[k])


def test_video_frame_schedule_and_ucb_gt_path():
    # every branch of the reference's frame-offset table (dataset.py:808-867)
    assert Dataset.video_frame_schedule(1) == [1, 3, 5, 7, 9, 11, 13, 15, 17,
                                               2]
    assert Dataset.video_frame_schedule(3) == [3, 4, 6, 8, 10, 12, 14, 16, 18,
                                               1]
    assert Dataset.video_frame_schedule(5) == [5, 6, 8, 10, 12, 14, 16, 18, 3,
                                               1]
    assert Dataset.video_frame_schedule(7) == [7, 8, 10, 12, 14, 16, 18, 5, 3,
                                               1]
    assert Dataset.video_frame_schedule(50) == [50, 51, 53, 55, 57, 59, 48,
                                                46, 44, 42]
    assert Dataset.video_frame_schedule(101) == [101, 100, 98, 96, 94, 92,
                                                 90, 99, 97, 95]
    for f in (0, 4, 8, 60, 150):
        assert Dataset.video_frame_schedule(f) == \
            JaxDataset.video_frame_schedule(f)
    assert Dataset._ucb_gt_path("UCB/train/input/9156/9156-004.npy") == \
        "UCB/train/gt/9156/9156-004.png"


def test_prefetch_reraises_parser_errors():
    def parse():
        yield 1
        raise ValueError("bad sample")

    got = []
    with pytest.raises(ValueError, match="bad sample"):
        for item in prefetch(parse()):
            got.append(item)
    assert got == [1]


def test_prefetch_stops_producer_on_early_exit():
    produced = []

    def parse():
        for i in range(1000):
            produced.append(i)
            yield i

    before = threading.active_count()
    for item in prefetch(parse(), depth=2):
        if item == 3:
            break
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() == before
    assert len(produced) < 10


def test_unported_parsers_raise(tmp_path):
    """The train and val modes, which raised before the train parser was
    ported, now list their identity folders as the JAX package does
    (tests/test_torch_train_data.py holds their parser against JAX's)."""
    for ident in ("a", "b"):
        os.makedirs(tmp_path / ident)
    kw = dict(data_dirs=(str(tmp_path / "a"),),
              data_dirs_val=(str(tmp_path / "*"),))
    for mode in ("train", "val"):
        ours = Dataset(get_config("train", **kw), mode)
        theirs = JaxDataset(jax_config("train", **kw), mode)
        assert sorted(ours.name_list) == sorted(theirs.name_list)
        assert ours.name_list
