"""Port's raw-photo pipeline (eval/e2e.py) and its host geometry
(geometry/crop.py `pts_load`, `offline_crop`; geometry/triangulation.py
`generate_face_region2`; geometry/landmark_map.py) against the JAX
package, on the CPU in f32: 128 px, n_res=2, the TF-golden weight recipe,
the detector at det_size 128 and a one-stack aligner from seeded weights
carried across."""

import os
import threading
import time

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blindshadowremoval_tpu.config import get_config as jax_config
from blindshadowremoval_tpu.eval import e2e as jax_e2e
from blindshadowremoval_tpu.geometry import crop as jax_crop
from blindshadowremoval_tpu.geometry import landmark_map as jax_lmap
from blindshadowremoval_tpu.geometry import triangulation as jax_tri
from blindshadowremoval_tpu.geometry.landmarks import LM_REF
from blindshadowremoval_tpu.models.fan import variables_from_flat
from blindshadowremoval_tpu.models.tf_checkpoint import (
    generator_mapping,
    load_weights_dict,
    synthetic_tf_weights,
)
from blindshadowremoval_tpu.train.trainer import build_generator
from blindshadowremoval_tpu_torch.config import get_config
from blindshadowremoval_tpu_torch.eval import e2e
from blindshadowremoval_tpu_torch.geometry import crop
from blindshadowremoval_tpu_torch.geometry import landmark_map
from blindshadowremoval_tpu_torch.geometry import triangulation as tri
from blindshadowremoval_tpu_torch.models.weights import (
    fan_from_jax,
    from_jax_variables,
    sfd_from_jax,
    synthetic_fan_weights,
    synthetic_sfd_weights,
)
from blindshadowremoval_tpu_torch.utils.imageio import (
    read_png,
    resize_linear_u8,
    write_png,
)

S = 128
N_RES = 2
FACE = os.path.join(os.path.dirname(__file__), "goldens", "tf_ref",
                    "sfw_synth", "vid0", "0")
# f32 end to end, the tolerance of tests/test_torch_serving.py: the crops
# differ by ~1e-6 (numpy vs cv2 resampling), the maps and the generator by
# float summation order
ATOL = 1e-4


@pytest.fixture(autouse=True)
def _threads():
    """Six test workers share the machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _face_lms(rng, n):
    return [(LM_REF * rng.uniform(30, 50) + rng.uniform(5, 10, 2)
             + rng.normal(scale=0.5, size=(68, 2))).astype(np.float32)
            / 64.0 for _ in range(n)]


def test_pts_load_matches_jax(tmp_path):
    lm = np.random.default_rng(0).uniform(0, 500, (68, 2))
    path = tmp_path / "face.pts"
    path.write_text("version: 1\nn_points:  68\n{\n"
                    + "".join(f"{x:.3f} {y:.3f}\n" for x, y in lm) + "}\n")
    got = crop.pts_load(str(path))
    assert got.shape == (68, 2) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jax_crop.pts_load(str(path)))


def _photo(scale, canvas, offset, seed=0):
    """The SFW-synth face scaled by `scale` and pasted into a noise canvas
    of `canvas` (h, w) at `offset` (x, y); returns (uint8 photo,
    landmarks)."""
    face = read_png(FACE + ".png")
    side = round(face.shape[0] * scale)
    photo = np.random.default_rng(seed).integers(
        0, 256, canvas + (3,), dtype=np.uint8)
    x, y = offset
    photo[y:y + side, x:x + side] = resize_linear_u8(face, (side, side))
    lm = np.load(FACE + ".npy") * (side / face.shape[0]) + [x, y]
    return photo, lm.astype(np.float32)


@pytest.mark.parametrize("case", ["inside", "padded", "float", "too small"])
def test_offline_crop_matches_jax(case):
    photo, lm = {"inside": _photo(1.5, (480, 420), (20, 40)),
                 "padded": _photo(1.5, (400, 400), (0, 0)),
                 "float": _photo(1.2, (330, 330), (10, 5)),
                 "too small": _photo(0.9, (300, 300), (10, 10))}[case]
    if case == "float":
        photo = photo.astype(np.float32) / 255.0
    got = crop.offline_crop(photo, lm, out_size=S)
    want = jax_crop.offline_crop(photo, lm, out_size=S)
    if case == "too small":
        assert got is None and want is None
        return
    assert got[0].shape == want[0].shape == (S, S, 3)
    # cv2's f32 bilinear against the port's, on [0, 255] or [0, 1] values
    np.testing.assert_allclose(got[0], want[0], rtol=0,
                               atol=1e-6 * float(want[0].max()) + 1e-7)
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("size", [64, 128])
def test_generate_face_region2_matches_jax(size):
    lm = _face_lms(np.random.default_rng(size), 1)[0]
    got = tri.generate_face_region2(lm, size)
    want = jax_tri.generate_face_region2(lm, size)
    assert got.shape == (size, size, 1) and got.dtype == np.float32
    # a 45x45 box in f64 running sums against the JAX package's f32
    # separable convolution
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("size", [64, 256])
def test_generate_landmark_map_matches_jax(size):
    lm = _face_lms(np.random.default_rng(size + 1), 1)[0]
    got = landmark_map.generate_landmark_map(lm, size)
    want = jax_lmap.generate_landmark_map(lm, size)
    assert got.shape == (size, size, 1) and got.max() == 255.0
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ pipeline

@pytest.fixture(scope="module")
def variables():
    cfg = jax_config("in_the_wild", img_size=S, compute_dtype="float32",
                     n_res=N_RES)
    z = np.zeros((1, 64, 64, 3), np.float32)
    v = jax.jit(build_generator(cfg).init)(
        jax.random.PRNGKey(0), z, z, np.zeros((1, 64, 64, 6), np.float32))
    mapping = generator_mapping(n_res=N_RES)
    weights = synthetic_tf_weights(v, mapping, seed=0)
    weights["generator/clr_conv3/conv/bias"] += 0.5
    return jax.tree.map(np.asarray, load_weights_dict(weights, v, mapping))


@pytest.fixture(scope="module")
def stage_weights():
    return synthetic_sfd_weights(seed=0), synthetic_fan_weights(seed=0,
                                                                num_modules=1)


STAGES = dict(det_size=S, det_batch=2, fan_batch=2, fan_modules=1,
              min_face=100)


def _pipelines(variables, stage_weights, detector=True):
    sfd_flat, fan_flat = stage_weights
    ours = e2e.DeshadowPipeline(
        get_config(img_size=S, compute_dtype="float32", n_res=N_RES),
        from_jax_variables(variables),
        fan_weights=fan_from_jax(fan_flat),
        sfd_weights=sfd_from_jax(sfd_flat) if detector else None,
        stage_dtype=torch.float32, device="cpu", batch_size=2, **STAGES)
    theirs = jax_e2e.DeshadowPipeline(
        jax_config("in_the_wild", img_size=S, compute_dtype="float32",
                   n_res=N_RES, device_geometry=True),
        variables, fan_variables=variables_from_flat(fan_flat),
        sfd_variables=(variables_from_flat(sfd_flat) if detector
                       else None),
        stage_dtype=jnp.float32, batch_size=2, **STAGES)
    return ours, theirs


@pytest.fixture(scope="module")
def pipelines(variables, stage_weights):
    return _pipelines(variables, stage_weights)


def _photos():
    return [_photo(0.8, (300, 260), (40, 60), seed=1),
            _photo(0.7, (240, 320), (100, 20), seed=2),
            _photo(0.8, (280, 280), (0, 60), seed=3),   # padded crop
            _photo(0.3, (200, 200), (50, 50), seed=4)]  # below min_face


def _assert_results_match(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is None:
            continue
        for key in ("pred", "mask_pred", "out", "crop"):
            np.testing.assert_allclose(g[key], np.asarray(w[key], np.float32),
                                       rtol=0, atol=ATOL, err_msg=key)
        # the crop's landmarks: equal from given landmarks, ~3e-5 apart
        # through the aligner (the boxes differ by ~3e-4 px)
        np.testing.assert_allclose(g["lm"], w["lm"], rtol=0, atol=1e-3)
        np.testing.assert_array_equal(g["crop_box"], w["crop_box"])


def test_pipeline_with_landmarks_matches_jax(pipelines):
    ours, theirs = pipelines
    photos = _photos()
    images, lms = [p for p, _ in photos], [lm for _, lm in photos]
    got = ours(images, landmarks=lms)
    want = theirs(images, landmarks=lms)
    assert [r is None for r in got] == [False, False, False, True]
    _assert_results_match(got, want)
    assert ours.last_times.faces == theirs.last_times.faces == 3
    # the composite gates pred by the clipped face-gated shadow map
    r = got[0]
    m = np.clip(r["mask_pred"], 0, 1)
    np.testing.assert_allclose(
        r["out"], np.clip(r["pred"] * m + r["crop"] * (1 - m), 0, 1),
        atol=1e-6)


def test_pipeline_detect_and_align_matches_jax(pipelines):
    """No landmarks: S3FD boxes, then FAN landmarks, then the crop and the
    service; and `boxes=` skipping detection."""
    ours, theirs = pipelines
    images = [p for p, _ in _photos()[:3]]
    got = ours(images)
    want = theirs(images)
    for g, w in zip(got, want):
        assert g is not None and w is not None
        np.testing.assert_allclose(g["box"], w["box"], rtol=0, atol=2e-3)
    _assert_results_match(got, want)
    boxes = [(30.0, 50.0, 200.0, 230.0), None, (0.0, 40.0, 180.0, 240.0)]
    got = ours(images, boxes=boxes)
    want = theirs(images, boxes=boxes)
    _assert_results_match(got, want)
    assert got[0]["box"] == boxes[0]


def test_pipeline_no_face_yields_none_and_no_detector_raises(
        variables, stage_weights, pipelines):
    ours, theirs = pipelines
    photo, lm = _photo(0.3, (200, 200), (50, 50))
    saved = ours.detector.filter_threshold, theirs.detector.filter_threshold
    ours.detector.filter_threshold = theirs.detector.filter_threshold = 1.01
    try:      # no box clears the filter: no face
        assert ours([photo]) == theirs([photo]) == [None]
    finally:
        ours.detector.filter_threshold, theirs.detector.filter_threshold = \
            saved
    assert ours([photo], landmarks=[lm]) == [None]     # below min_face
    no_det, _ = _pipelines(variables, stage_weights, detector=False)
    with pytest.raises(ValueError, match="sfd_weights"):
        no_det([photo])
    no_det.aligner = None
    with pytest.raises(ValueError, match="fan_weights"):
        no_det([photo], boxes=[(0, 0, 100, 100)])


def _photo_dir(d, n=5):
    """n photos, every other one with its landmarks beside it."""
    os.makedirs(d, exist_ok=True)
    for i in range(n):
        photo, lm = _photo(0.8, (280, 300), (10 + 20 * i, 30), seed=i)
        write_png(os.path.join(d, f"{i}.png"), photo)
        if i % 2:
            np.save(os.path.join(d, f"{i}.npy"), lm)


def test_run_dir_serial_and_overlapped_match_jax(pipelines, tmp_path):
    ours, theirs = pipelines
    _photo_dir(tmp_path / "in")
    s_over = ours.run_dir(str(tmp_path / "in"), str(tmp_path / "over"),
                          batch_files=2)
    s_ser = ours.run_dir(str(tmp_path / "in"), str(tmp_path / "ser"),
                         batch_files=2, overlap=False)
    theirs.run_dir(str(tmp_path / "in"), str(tmp_path / "jax"),
                   batch_files=2, overlap=False)
    for stats in (s_over, s_ser):
        assert stats["written"] == stats["faces"] == stats["images"] == 5
        assert stats["images_per_s_wall"] > 0
    names = sorted(os.listdir(tmp_path / "over"))
    assert len(names) == 15
    assert names == sorted(os.listdir(tmp_path / "ser")) == sorted(
        os.listdir(tmp_path / "jax"))
    for name in names:
        over = (tmp_path / "over" / name).read_bytes()
        assert over == (tmp_path / "ser" / name).read_bytes(), name
        # the JAX package writes through cv2: one uint8 step where a value
        # lies on a truncation edge
        got = read_png(str(tmp_path / "over" / name)).astype(int)
        want = cv2.imread(str(tmp_path / "jax" / name))[..., ::-1]
        assert np.abs(got - want).max() <= 1, name


# ---------------------------------------------------------------- run_dir
# the thread pipeline's error handling, with stub stages

def _stub_pipeline(align_raises=False, deshadowed=None):
    pipe = object.__new__(e2e.DeshadowPipeline)
    pipe._stage_detect = lambda imgs, lms, bxs: (bxs, 0.01)

    def _align(imgs, lms, bxs):
        if align_raises:
            raise ValueError("align boom")
        return lms, 0.01

    def _deshadow(crops, bxs):
        if deshadowed is not None:
            deshadowed.append(len(crops))
        return ([{"out": c, "pred": c, "mask_pred": c[..., :1]}
                 for c in crops], 0.01, len(crops))

    pipe._stage_align = _align
    pipe._stage_crop = lambda imgs, lms: (
        [np.zeros((8, 8, 3), np.float32) for _ in imgs], 0.01)
    pipe._stage_deshadow = _deshadow
    return pipe


def _small_pngs(d, n=3):
    d.mkdir(exist_ok=True)
    for i in range(n):
        write_png(str(d / f"im{i}.png"), np.zeros((8, 8, 3), np.uint8))


@pytest.mark.parametrize("overlap", [True, False])
def test_run_dir_stats_keys_match_across_modes(tmp_path, overlap):
    _small_pngs(tmp_path / "in")
    stats = _stub_pipeline().run_dir(str(tmp_path / "in"),
                                     str(tmp_path / "out"), batch_files=2,
                                     overlap=overlap)
    assert stats["written"] == 3 and stats["images"] == 3
    assert stats["images_per_s_wall"] > 0


def test_run_dir_stage_error_propagates_and_threads_end(tmp_path):
    _small_pngs(tmp_path / "in")
    before = set(threading.enumerate())
    t0 = time.perf_counter()
    with pytest.raises(ValueError, match="align boom"):
        _stub_pipeline(align_raises=True).run_dir(
            str(tmp_path / "in"), str(tmp_path / "out"), batch_files=1)
    assert time.perf_counter() - t0 < 15.0
    assert set(threading.enumerate()) <= before


def test_run_dir_writer_error_stops_before_remaining_chunks(tmp_path,
                                                            monkeypatch):
    """A write failure ends the run before the remaining chunks reach the
    deshadow stage (the JAX package deshadows every chunk first)."""
    _small_pngs(tmp_path / "in", n=8)

    def boom(*a, **k):
        raise RuntimeError("disk full")

    monkeypatch.setattr(e2e, "write_png", boom)
    deshadowed = []
    before = set(threading.enumerate())
    with pytest.raises(RuntimeError, match="disk full"):
        _stub_pipeline(deshadowed=deshadowed).run_dir(
            str(tmp_path / "in"), str(tmp_path / "out"), batch_files=1)
    # the chunk that failed to write, the one in the deshadow stage then,
    # and at most one more that was queued for the writer
    assert 1 <= len(deshadowed) <= 3
    assert set(threading.enumerate()) <= before

    monkeypatch.setattr(cv2, "imwrite", boom)
    jax_pipe = object.__new__(jax_e2e.DeshadowPipeline)
    jax_deshadowed = []
    stub = _stub_pipeline(deshadowed=jax_deshadowed)
    for name in ("_stage_detect", "_stage_align", "_stage_crop",
                 "_stage_deshadow"):
        setattr(jax_pipe, name, getattr(stub, name))
    with pytest.raises(RuntimeError, match="disk full"):
        jax_pipe.run_dir(str(tmp_path / "in"), str(tmp_path / "jax"),
                         batch_files=1)
    assert len(jax_deshadowed) == 8


def test_pipeline_device_defaults_to_cuda(variables):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        e2e.DeshadowPipeline(get_config(img_size=S, n_res=N_RES),
                             from_jax_variables(variables))
