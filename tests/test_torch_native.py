"""The port's native loader (utils/native.py, native/loader.cc): the cases
of tests/test_native.py, and the port's library bit for bit against the
JAX package's on the same crops, flips and batches."""

import time
import warnings

import numpy as np
import pytest

from blindshadowremoval_tpu.utils import native as jax_native
from blindshadowremoval_tpu_torch.utils import native


@pytest.fixture(scope="module")
def jax_loader():
    """The JAX package's native library, loaded.  Its first build writes
    the library in place, so in a run of several pytest workers another
    worker may load it half written; the lost race is retried."""
    for _ in range(10):
        lib = jax_native.get_lib()
        if lib is not None:
            return lib
        jax_native._tried = False
        time.sleep(1.0)
    pytest.fail("the JAX package's native loader did not build")


@pytest.fixture(scope="module")
def libs(jax_loader):
    lib = native.get_lib()
    assert lib is not None, "the port's native loader did not build"
    return lib, jax_loader


def test_library_builds(libs):
    path = native.library_path()
    assert path.is_file() and path.parent == native.BUILD_DIR
    assert path.name.startswith("libbsrloader-")
    # the same source as the JAX package's, compiled with the same flags
    with open(jax_native._SRC, "rb") as f:
        assert native.SOURCE.read_bytes() == f.read()


def test_crop_resize_matches_cv2_interior(rng, libs):
    cv2 = pytest.importorskip("cv2")
    img = rng.uniform(size=(100, 120, 3)).astype(np.float32)
    box = (10, 20, 90, 100)   # fully inside
    ours = native.crop_resize(img, box, 64)
    ref = cv2.resize(img[20:100, 10:90], (64, 64),
                     interpolation=cv2.INTER_LINEAR)
    np.testing.assert_allclose(ours, ref, atol=2e-3)


def test_crop_resize_zero_pads_outside(rng, libs):
    img = rng.uniform(0.5, 1.0, size=(50, 50, 3)).astype(np.float32)
    out = native.crop_resize(img, (-50, -50, 0, 0), 32)  # fully outside
    np.testing.assert_allclose(out, 0.0, atol=1e-7)
    out2 = native.crop_resize(img, (-25, 0, 25, 50), 50)  # half outside
    assert np.allclose(out2[:, :24], 0.0, atol=1e-6)
    assert out2[:, 30:].min() > 0.4


def test_native_matches_numpy_fallback(rng, libs):
    img = rng.uniform(size=(64, 80, 4)).astype(np.float32)
    box = (-10, 5, 70, 85)
    ours = native.crop_resize(img, box, 48)
    ref = native._crop_resize_np(img, box, 48)
    np.testing.assert_allclose(ours, ref, atol=1e-5)


def test_batch_crop_resize(rng, libs):
    imgs = rng.uniform(size=(6, 40, 40, 3)).astype(np.float32)
    boxes = np.array([[0, 0, 40, 40]] * 6, np.int32)
    boxes[3] = [10, 10, 30, 30]
    out = native.batch_crop_resize(imgs, boxes, 32)
    assert out.shape == (6, 32, 32, 3)
    single = native.crop_resize(imgs[3], boxes[3], 32)
    np.testing.assert_allclose(out[3], single, atol=1e-6)
    with pytest.raises(ValueError, match=r"boxes of shape \(6, 4\)"):
        native.batch_crop_resize(imgs, boxes[:5], 32)


def test_hflip(rng, libs):
    img = rng.uniform(size=(8, 9, 3)).astype(np.float32)
    np.testing.assert_allclose(native.hflip(img), img[:, ::-1], atol=0)


@pytest.mark.parametrize("box,size", [((10, 20, 90, 100), 64),
                                      ((-10, 5, 70, 85), 48),
                                      ((-25, -40, 231, 216), 256),
                                      ((3, 7, 10, 14), 32)])
def test_crop_resize_bitwise_against_jax_library(rng, libs, box, size):
    img = rng.uniform(size=(120, 110, 3)).astype(np.float32)
    np.testing.assert_array_equal(native.crop_resize(img, box, size),
                                  jax_native.crop_resize(img, box, size))


def test_batch_and_flip_bitwise_against_jax_library(rng, libs):
    imgs = rng.uniform(size=(5, 90, 70, 3)).astype(np.float32)
    boxes = rng.integers(-20, 40, size=(5, 2))
    side = rng.integers(20, 90, size=(5, 1))
    boxes = np.concatenate([boxes, boxes + side], axis=1).astype(np.int32)
    for threads in (1, 3):
        np.testing.assert_array_equal(
            native.batch_crop_resize(imgs, boxes, 40, n_threads=threads),
            jax_native.batch_crop_resize(imgs, boxes, 40,
                                         n_threads=threads))
    np.testing.assert_array_equal(native.hflip(imgs[0]),
                                  jax_native.hflip(imgs[0]))


def test_without_gxx_falls_back_to_numpy_and_warns_once(rng, monkeypatch,
                                                        tmp_path):
    """g++ absent: the first call warns with the cause, and every function
    runs its numpy version."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))          # no g++ on it
    img = rng.uniform(size=(30, 40, 3)).astype(np.float32)
    with pytest.warns(RuntimeWarning, match="native loader is unavailable"):
        out = native.crop_resize(img, (-5, 0, 35, 40), 16)
    np.testing.assert_array_equal(
        out, native._crop_resize_np(img, (-5, 0, 35, 40), 16))
    with warnings.catch_warnings():
        warnings.simplefilter("error")                 # no second warning
        assert native.get_lib() is None and not list(tmp_path.iterdir())
        np.testing.assert_array_equal(native.hflip(img), img[:, ::-1])
