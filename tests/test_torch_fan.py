"""Port's 2D-FAN aligner (models/fan.py) against the JAX package's, on the
CPU in f32, with one set of seeded weights carried across
(`synthetic_fan_weights` in the flat npz layout: `variables_from_flat` for
JAX, `fan_from_jax` for the port)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blindshadowremoval_tpu.models import fan as jfan
from blindshadowremoval_tpu_torch.models import fan
from blindshadowremoval_tpu_torch.models.weights import (
    fan_from_jax,
    synthetic_fan_weights,
)

# f32 heatmaps: XLA's and oneDNN's convolutions sum in different orders
# through ~40 (one stack) to ~80 (two) layers; measured 1.5e-6 of maps
# reaching 2.2 (one stack) and 5.2e-6 of maps reaching 6.0 (two)
HM_RTOL = 1e-5
HM_ATOL = 1e-4


@pytest.fixture(autouse=True)
def _threads():
    """Six test workers share the machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def flat1():
    return synthetic_fan_weights(seed=0, num_modules=1)


def _faces(seed=4):
    rng = np.random.default_rng(seed)
    images = [rng.integers(0, 256, (300, 400, 3), dtype=np.uint8),
              rng.integers(0, 256, (500, 280, 3), dtype=np.uint8),
              rng.uniform(0, 1, (256, 256, 3)).astype(np.float32)]
    boxes = [(80, 40, 320, 280), (30, 100, 250, 420), (-20, 10, 230, 270)]
    return images, boxes


@pytest.mark.parametrize("num_modules", [1, 2])
def test_fan_heatmaps_match_jax(num_modules):
    flat = synthetic_fan_weights(seed=1, num_modules=num_modules)
    x = np.random.default_rng(1).uniform(0, 1, (1, 64, 64, 3)).astype(
        np.float32)
    want = jax.jit(jfan.FAN(num_modules=num_modules).apply)(
        jfan.variables_from_flat(flat), x)
    net = fan.build_fan(fan_from_jax(flat), num_modules, device="cpu")
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(want) == num_modules
    for g, w in zip(got, want):
        g = g.permute(0, 2, 3, 1).numpy()
        assert g.shape == w.shape == (1, 16, 16, 68)
        np.testing.assert_allclose(g, np.asarray(w), rtol=HM_RTOL,
                                   atol=HM_ATOL)


def _decode_cases():
    rng = np.random.default_rng(0)
    hm = rng.standard_normal((2, 64, 64, 68)).astype(np.float32)
    hm[0, 0, 5, 0] = 10.0          # maxima on each border: no nudge
    hm[0, 63, 63, 1] = 10.0
    hm[1, 30, 0, 2] = 10.0
    hm[1, 0, 40, 3] = 10.0
    hm[0, 20, 20, 4] = hm[0, 40, 10, 4] = 10.0    # a tie: the first wins
    hm[0, 30, 30, 5] = 10.0                       # equal neighbours: sign 0
    hm[0, 30, 29, 5] = hm[0, 30, 31, 5] = 5.0
    hm[0, 29, 30, 5] = hm[0, 31, 30, 5] = 5.0
    hm[1, 10, 10, 6] = 10.0        # nudges along x only (y neighbours tie)
    hm[1, 10, 11, 6], hm[1, 10, 9, 6] = 6.0, 5.0
    hm[1, 9, 10, 6] = hm[1, 11, 10, 6] = 4.0
    hm[1, 1, 62, 7] = 10.0         # one pixel inside the corner: nudged
    hm[1, 0, 62, 7] = 9.0
    flat = hm.reshape(2, 64 * 64, 68)   # one map's every value equal
    flat[1, :, 8] = 3.0
    return hm


def test_decode_heatmaps_matches_jax():
    hm = _decode_cases()
    want = np.asarray(jfan.decode_heatmaps(jnp.asarray(hm)))
    got = fan.decode_heatmaps(torch.from_numpy(hm).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.numpy(), want)
    assert tuple(got[0, 4].tolist()) == (20.5 + 0.25 * np.sign(
        hm[0, 20, 21, 4] - hm[0, 20, 19, 4]), 20.5 + 0.25 * np.sign(
        hm[0, 21, 20, 4] - hm[0, 19, 20, 4]))
    assert tuple(got[0, 5].tolist()) == (30.5, 30.5)
    assert tuple(got[1, 6].tolist()) == (10.75, 10.5)
    assert tuple(got[1, 8].tolist()) == (0.5, 0.5)


def test_box_to_center_scale_and_coords_match_jax():
    for box in [(10, 20, 110, 140), (80.5, 40.25, 320.0, 280.75)]:
        c, s = fan.box_to_center_scale(box)
        jc, js = jfan.box_to_center_scale(box)
        np.testing.assert_array_equal(c, jc)
        assert s == js
        pts = np.random.default_rng(0).uniform(0, 64, (68, 2)).astype(
            np.float32)
        np.testing.assert_array_equal(
            fan.heatmap_to_image_coords(pts, c, s),
            np.asarray(jfan.heatmap_to_image_coords(jnp.asarray(pts), c, s)))


@pytest.mark.parametrize("which", [0, 1, 2])
def test_crop_for_fan_matches_jax(which):
    images, boxes = _faces()
    c, s = fan.box_to_center_scale(boxes[which])
    got = fan.crop_for_fan(images[which], c, s)
    want = jfan.crop_for_fan(images[which], c, s)       # cv2 f32 bilinear
    # measured 0, 0 and 6e-8
    assert got.shape == want.shape == (256, 256, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("ingress_u8", [False, True])
def test_landmark_aligner_matches_jax(flat1, ingress_u8):
    """Three faces at batch 2 (a padded tail), the window leaving the frame
    for the third; heatmaps and landmarks."""
    images, boxes = _faces()
    jal = jfan.LandmarkAligner(jfan.variables_from_flat(flat1),
                               num_modules=1, batch_size=2,
                               ingress_u8=ingress_u8, warm=False)
    al = fan.LandmarkAligner(fan_from_jax(flat1), num_modules=1,
                             batch_size=2, ingress_u8=ingress_u8,
                             device="cpu")
    want = jal(images, boxes)
    got = al(images, boxes)
    assert len(got) == len(want) == 3
    cs = [fan.box_to_center_scale(b) for b in boxes]
    crops = al.crops(images, cs)
    jcrops = np.stack([jfan.crop_for_fan(im, c, s)
                       for im, (c, s) in zip(images, cs)])
    if ingress_u8:
        jcrops = np.rint(np.clip(jcrops, 0, 1) * 255).astype(np.uint8)
        np.testing.assert_array_equal(crops, jcrops)
    hm = al.heatmaps(torch.from_numpy(crops)).permute(0, 2, 3, 1).numpy()
    jx = jnp.asarray(jcrops, jnp.float32) / (255.0 if ingress_u8 else 1.0)
    jhm = np.asarray(jfan.FAN(num_modules=1).apply(
        jfan.variables_from_flat(flat1), jx)[-1])
    np.testing.assert_allclose(hm, jhm, rtol=HM_RTOL, atol=HM_ATOL)
    for g, w in zip(got, want):
        assert g.shape == (68, 2) and g.dtype == np.float32
        # the same argmax on both sides; the affine's f32 rounding only
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)


def test_landmarks_from_image_matches_jax(flat1):
    images, boxes = _faces(seed=6)
    net = fan.build_fan(fan_from_jax(flat1), 1, device="cpu")
    for img, box in ((images[0], boxes[0]), (images[1], None)):
        want = jfan.landmarks_from_image(jfan.variables_from_flat(flat1),
                                         img, box=box, num_modules=1)
        got = fan.landmarks_from_image(net, img, box=box)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    got = fan.landmarks_from_image(fan_from_jax(flat1), images[1],
                                   num_modules=1, device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_load_fan_npz_round_trip(flat1, tmp_path):
    """The converter's npz layout loads into face_alignment's module names,
    bit for bit."""
    path = tmp_path / "fan.npz"
    np.savez(path, **flat1)
    sd = fan.load_fan_npz(str(path))
    assert sd.keys() == fan.FAN(1).state_dict().keys()
    np.testing.assert_array_equal(
        sd["conv2.downsample.2.weight"].numpy(),
        flat1["params/conv2/down_conv/kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["m0.b1_4.bn1.running_var"].numpy(),
                                  flat1["batch_stats/m0/b1_4/bn1/var"])
