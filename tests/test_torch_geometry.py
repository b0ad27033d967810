"""Port's host and device geometry (geometry/, ops/image.py,
utils/native.py, data/dataset.py) against the JAX package and
tests/goldens/goldens.npz."""

import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blindshadowremoval_tpu.data.dataset import (
    _geometry_primitives as jax_primitives,
)
from blindshadowremoval_tpu.geometry import landmarks as jax_lm
from blindshadowremoval_tpu.geometry import triangulation as jax_tri
from blindshadowremoval_tpu.geometry.crop import (
    face_crop_and_resize as jax_crop,
)
from blindshadowremoval_tpu.geometry.warp import (
    resize_bilinear as jax_resize,
)
from blindshadowremoval_tpu.ops.image import rgb_to_grayscale as jax_gray
from blindshadowremoval_tpu.utils import native as jax_native
from blindshadowremoval_tpu.utils.native import _crop_resize_np
from blindshadowremoval_tpu_torch.data.dataset import _geometry_primitives
from blindshadowremoval_tpu_torch.geometry import landmarks
from blindshadowremoval_tpu_torch.geometry import triangulation as tri
from blindshadowremoval_tpu_torch.geometry.crop import face_crop_and_resize
from blindshadowremoval_tpu_torch.geometry.warp import resize_bilinear
from blindshadowremoval_tpu_torch.ops.image import rgb_to_grayscale
from blindshadowremoval_tpu_torch.utils.native import _crop_resize_np as np_crop

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "goldens.npz")
S = 64


@pytest.mark.parametrize("name", ["UV_TABLE", "LM_REF", "LM_MIRROR_PERM",
                                  "ANCHOR_POINTS", "LM_SKELETON_EDGES"])
def test_landmark_tables_equal(name):
    ours, ref = getattr(landmarks, name), getattr(jax_lm, name)
    assert ours.dtype == ref.dtype
    np.testing.assert_array_equal(ours, ref)


def test_landmark_helpers(rng):
    lm = rng.uniform(50, 200, (68, 2)).astype(np.float32)
    np.testing.assert_array_equal(landmarks.mirror_landmarks(lm, 256),
                                  jax_lm.mirror_landmarks(lm, 256))
    np.testing.assert_array_equal(landmarks.forehead_points(lm, 0.6),
                                  jax_lm.forehead_points(lm, 0.6))


def test_rgb_to_grayscale(rng):
    x = rng.uniform(size=(2, 8, 8, 3)).astype(np.float32)
    np.testing.assert_allclose(rgb_to_grayscale(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_gray(jnp.asarray(x))),
                               atol=1e-7)


@pytest.mark.parametrize("src,dst", [(256, 32), (32, 256), (100, 256),
                                     (17, 9)])
def test_resize_bilinear(rng, src, dst):
    x = rng.normal(size=(2, src, src, 3)).astype(np.float32)
    out = resize_bilinear(torch.from_numpy(x), (dst, dst)).numpy()
    ref = np.asarray(jax_resize(jnp.asarray(x), (dst, dst)))
    # both two-tap lerps in f32, but the JAX package places the taps in
    # f64 and ATen in f32: exact for the generator's 256 -> 32, ~1e-6
    # relative at a ratio such as 17/9
    np.testing.assert_allclose(out, ref, atol=1e-5)


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


@pytest.mark.parametrize("box", [(10, 20, 90, 100), (-15, -5, 65, 75),
                                 (30, 40, 240, 250)])
def test_crop_resize(rng, box):
    # the numpy versions (the native libraries: tests/test_torch_native.py)
    img = rng.uniform(size=(120, 110, 3)).astype(np.float32)
    np.testing.assert_array_equal(np_crop(img, box, 32),
                                  _crop_resize_np(img, box, 32))


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int64])
def test_face_crop_and_resize(rng, dtype, jax_loader):
    img = rng.uniform(size=(300, 280, 3)).astype(np.float32)
    lm = (jax_lm.LM_REF * 150 + 60 + rng.normal(scale=2, size=(68, 2)))
    lm = lm.astype(dtype)
    ours = face_crop_and_resize(img, lm, S)
    ref = jax_crop(img, lm, S)
    np.testing.assert_array_equal(ours[3], ref[3])          # box
    np.testing.assert_array_equal(ours[1], ref[1])          # landmarks
    np.testing.assert_array_equal(ours[2], ref[2])          # mirrored
    # both resample with their g++ loader (the same source and flags)
    np.testing.assert_array_equal(ours[0], ref[0])


def _face_lms(rng, n=2):
    return [(jax_lm.LM_REF + rng.normal(scale=0.01, size=(68, 2))).astype(
        np.float32) for _ in range(n)]


def test_geometry_primitives(rng):
    lm = _face_lms(rng, 1)[0]
    ours, ref = _geometry_primitives(lm), jax_primitives(lm)
    assert set(ours) == set(ref)
    for key in ours:
        np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)


def test_rasterize_linear(rng):
    pts = np.concatenate([_face_lms(rng, 1)[0], jax_lm.ANCHOR_POINTS])
    t = tri.build_triangulation(pts)
    values = rng.normal(size=(pts.shape[0], 3)).astype(np.float32)
    out = tri.rasterize_linear(torch.from_numpy(t.points)[None],
                               torch.from_numpy(t.triangles)[None],
                               torch.from_numpy(values)[None], S)[0].numpy()
    ref = np.asarray(jax_tri.rasterize_linear(t.points, t.triangles, values,
                                              S))
    # same expression order, first-hit triangle order; anchors cover the
    # square, so no hull-boundary pixel flips: float noise only
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_device_geometry_maps(rng):
    prims = [_geometry_primitives(lm) for lm in _face_lms(rng)]
    keys = ("lm", "face_pts", "uv_tris", "face_tris", "reg_tris")
    stacked = [np.stack([p[k] for p in prims]) for k in keys]
    ours = tri.device_geometry_maps(*map(torch.from_numpy, stacked), S)
    ref = jax_tri.device_geometry_maps(*map(jnp.asarray, stacked), S)
    for key in ("uv", "reg", "face"):
        # measured max error 5e-7; an edge pixel that lands in the other
        # of two adjacent triangles moves by float noise only (the
        # interpolation is continuous across the edge)
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(ref[key]),
                                   atol=1e-5, err_msg=key)


def test_generate_maps_match_goldens():
    g = np.load(GOLDEN)
    lm = g["lm"]
    # the goldens are stored as float16: the tolerance of
    # tests/test_goldens.py
    np.testing.assert_allclose(tri.generate_uv_map(lm, S), g["uv"], atol=2e-3)
    np.testing.assert_allclose(tri.generate_offset_map(lm, landmarks.LM_REF, S),
                               g["off"], atol=2e-3)
    np.testing.assert_allclose(tri.generate_face_region(lm, S), g["face"],
                               atol=2e-3)


def test_generate_maps_match_jax(rng):
    lm = _face_lms(rng, 1)[0]
    for ours, ref in (
            (tri.generate_uv_map(lm, S), jax_tri.generate_uv_map(lm, S)),
            (tri.generate_offset_map(lm, landmarks.LM_REF, S),
             jax_tri.generate_offset_map(lm, jax_lm.LM_REF, S)),
            (tri.generate_face_region(lm, S),
             jax_tri.generate_face_region(lm, S))):
        np.testing.assert_allclose(ours, ref, atol=1e-5)
