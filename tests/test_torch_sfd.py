"""Port's S3FD detector (models/sfd.py) against the JAX package's, on the CPU
in f32, with one set of seeded weights carried across (`synthetic_sfd_
weights` in the flat npz layout: `variables_from_flat` for JAX,
`sfd_from_jax` for the port)."""

import cv2
import jax
import numpy as np
import pytest
import torch

from blindshadowremoval_tpu.models import sfd as jsfd
from blindshadowremoval_tpu.models.fan import variables_from_flat
from blindshadowremoval_tpu_torch.models import sfd
from blindshadowremoval_tpu_torch.models.weights import (
    sfd_from_jax,
    synthetic_sfd_weights,
)
from blindshadowremoval_tpu_torch.utils.imageio import resize_linear_u8

# f32 heads: XLA's and oneDNN's convolutions sum in different orders
# through 15 trunk layers whose activations reach ~1e2; measured 1.9e-6
# (scores) and 9.2e-6 (box offsets); the boxes at 128 px, 2.6e-4 px
SCORE_ATOL = 2e-5
LOC_ATOL = 1e-4


@pytest.fixture(autouse=True)
def _threads():
    """Six test workers share the machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def flat():
    return synthetic_sfd_weights(seed=0)


@pytest.fixture(scope="module")
def net(flat):
    return sfd.build_s3fd(sfd_from_jax(flat), device="cpu")


def _frame(rng, h, w):
    return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)


@pytest.mark.parametrize("shape", [(128, 128), (256, 256), (96, 160)])
def test_s3fd_heads_match_jax(flat, net, shape):
    x = sfd.preprocess(_frame(np.random.default_rng(1), *shape))
    want = jax.jit(jsfd.S3FD().apply)(variables_from_flat(flat), x[None])
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(2, 0, 1)[None])
    assert len(got) == len(want) == 6
    for (gc, gl), (wc, wl) in zip(got, want):
        gc, gl = gc.permute(0, 2, 3, 1).numpy(), gl.permute(0, 2, 3, 1).numpy()
        assert gc.shape == wc.shape and gl.shape == wl.shape
        np.testing.assert_allclose(gc, np.asarray(wc), rtol=0, atol=SCORE_ATOL)
        np.testing.assert_allclose(gl, np.asarray(wl), rtol=0, atol=LOC_ATOL)


def _shared_heads(seed=0, tied=False):
    """Random softmaxed heads, NHWC for JAX and NCHW for the port; `tied`
    gives every anchor of a scale one score (exact ties)."""
    rng = np.random.default_rng(seed)
    nhwc, nchw = [], []
    for h, w in [(16, 24), (8, 12), (4, 6), (2, 3), (1, 2), (1, 1)]:
        face = (np.full((1, h, w), 0.7, np.float32) if tied
                else rng.uniform(0, 1, (1, h, w)).astype(np.float32))
        conf = np.stack([1 - face, face], axis=-1)
        loc = rng.standard_normal((1, h, w, 4)).astype(np.float32)
        nhwc.append((conf, loc))
        nchw.append((conf.transpose(0, 3, 1, 2), loc.transpose(0, 3, 1, 2)))
    return nhwc, nchw


@pytest.mark.parametrize("tied", [False, True])
def test_decode_order_and_nms_match_jax(tied):
    nhwc, nchw = _shared_heads(tied=tied)
    want = jsfd.decode_detections(nhwc)
    got = sfd.decode_detections(nchw)
    # the same f32 inputs through the same numpy arithmetic
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(sfd.nms(got), jsfd.nms(want))
    np.testing.assert_array_equal(sfd._canonical_order(got[::-1].copy()),
                                  jsfd._canonical_order(want[::-1].copy()))


def test_nms_plus_one_convention():
    a = np.array([[0, 0, 10, 10, 0.9], [10, 0, 20, 10, 0.8]], np.float32)
    inter = 1 * 11
    union = 11 * 11 * 2 - inter
    assert list(sfd.nms(a, inter / union - 1e-6)) == [0]
    assert list(sfd.nms(a, inter / union + 1e-6)) == [0, 1]


# (frame h, w, det_size): upscales, reductions (an exact 2x one, which cv2
# runs as INTER_AREA), a third, and frames narrower than a tap
LETTERBOX_CASES = [(750, 1000, 640), (1080, 1920, 640), (300, 400, 640),
                   (720, 1280, 640), (1024, 768, 640), (50, 120, 128),
                   (128, 128, 256), (481, 641, 256), (7, 9, 128),
                   (1, 5, 64)]


@pytest.mark.parametrize("h,w,det", LETTERBOX_CASES)
def test_letterbox_uint8_bit_equal_to_cv2(h, w, det):
    img = _frame(np.random.default_rng(h * 7 + w), h, w)
    canvas, scale = sfd.letterbox(img, det)
    want, want_scale = jsfd.letterbox(img, det)     # cv2.resize on uint8
    assert canvas.dtype == np.uint8 and scale == want_scale
    np.testing.assert_array_equal(canvas, want)
    nw, nh = max(1, round(w * scale)), max(1, round(h * scale))
    np.testing.assert_array_equal(
        resize_linear_u8(img, (nw, nh)),
        cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR))


def test_letterbox_float_matches_jax():
    img = np.random.default_rng(3).uniform(0, 255, (300, 410, 3))
    canvas, _ = sfd.letterbox(img.astype(np.float32), 128)
    want, _ = jsfd.letterbox(img.astype(np.float32), 128)
    assert canvas.dtype == np.float32
    np.testing.assert_allclose(canvas, want, rtol=0, atol=1e-4)


def _jax_detector(variables, **kw):
    return jsfd.FaceDetector(variables, warm=False, **kw)


@pytest.mark.parametrize("topk", [1024, 64])
def test_face_detector_matches_jax(flat, topk):
    """Mixed frame sizes through one batch shape (a padded tail); with
    topk 1024 the device top-k covers every stride-4 anchor at 128, with 64
    it truncates.  Boxes in the frames' own coordinates."""
    rng = np.random.default_rng(3)
    images = [_frame(rng, 100, 80), _frame(rng, 50, 120), _frame(rng, 128, 128)]
    kw = dict(det_size=128, batch_size=2, filter_threshold=0.0, topk=topk)
    want = _jax_detector(variables_from_flat(flat), **kw)(images)
    got = sfd.FaceDetector(sfd_from_jax(flat), device="cpu", **kw)(images)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.shape == w.shape and len(g) > 0
        np.testing.assert_allclose(g[:, 4], w[:, 4], rtol=0, atol=SCORE_ATOL)
        np.testing.assert_allclose(g[:, :4], w[:, :4], rtol=0, atol=2e-3)


def test_face_detector_exact_ties_match_jax(flat):
    """Zero conf kernels make every anchor of a scale score the same, in
    both frameworks exactly: the top-k keeps the lowest indices (as
    jax.lax.top_k) and NMS breaks the ties by (x1, y1)."""
    tied = dict(flat)
    for key in tied:
        if "_mbox_conf/kernel" in key:
            tied[key] = np.zeros_like(tied[key])
    images = [_frame(np.random.default_rng(4), 90, 128)]
    kw = dict(det_size=128, batch_size=1, filter_threshold=0.0, topk=32)
    want = _jax_detector(variables_from_flat(tied), **kw)(images)[0]
    det = sfd.FaceDetector(sfd_from_jax(tied), device="cpu", **kw)
    got = det(images)[0]
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:, 4], want[:, 4])
    np.testing.assert_allclose(got[:, :4], want[:, :4], rtol=0, atol=2e-3)
    canvas, _ = sfd.letterbox(images[0], 128)
    cands, spans = det.candidates(torch.from_numpy(canvas[None]))
    start = 0
    for k, _ in spans:      # each scale: the first k anchors, in order
        np.testing.assert_array_equal(cands[0, start:start + k, 1].numpy(),
                                      np.arange(k))
        start += k


def test_detect_faces_matches_jax(flat, net):
    img = _frame(np.random.default_rng(2), 64, 96)
    want = jsfd.detect_faces(variables_from_flat(flat), img,
                             filter_threshold=0.0)
    got = sfd.detect_faces(net, img, filter_threshold=0.0)
    assert got.shape == want.shape
    again = sfd.detect_faces(sfd_from_jax(flat), img, filter_threshold=0.0,
                             device="cpu")
    np.testing.assert_array_equal(again, got)
    np.testing.assert_allclose(got[:, 4], want[:, 4], rtol=0, atol=SCORE_ATOL)
    np.testing.assert_allclose(got[:, :4], want[:, :4], rtol=0, atol=2e-3)


def test_load_sfd_npz_round_trip(flat, tmp_path):
    """The converter's npz layout loads into the port, bit for bit."""
    path = tmp_path / "sfd.npz"
    np.savez(path, **flat)
    sd = sfd.load_sfd_npz(str(path))
    ref = sfd_from_jax(flat)
    assert sd.keys() == ref.keys() == sfd.S3FD().state_dict().keys()
    for k in sd:
        assert torch.equal(sd[k], ref[k])
    assert sd["conv1_1.weight"].shape == (64, 3, 3, 3)
    np.testing.assert_array_equal(
        sd["conv1_1.weight"].numpy(),
        flat["params/conv1_1/kernel"].transpose(3, 2, 0, 1))


def test_device_defaults_to_cuda(flat):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sfd.FaceDetector(sfd_from_jax(flat))
