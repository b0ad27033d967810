"""Port's UCB heuristic post-processor (eval/postprocess.py), branch probes
(eval/branch_probes.py) and on-device twin (eval/fused.py) against the JAX
package, on the CPU.

The post-processor's gates fire on narrow bands of mask-derived scalars, so
the cases are synthetic 256 px shadow maps, input intensities and part
masks painted to steer each gate (`apply_rects` edits the part masks); the
union of the branches the cases fire covers GSC_BRANCHES."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from blindshadowremoval_tpu.eval.branch_probes import (
    disable_branch as jax_disable,
)
from blindshadowremoval_tpu.eval.fused import (
    dynamic_resize_matrix as jax_resize_matrix,
    fused_postprocess as jax_fused_postprocess,
    prep_part_inputs as jax_prep,
)
from blindshadowremoval_tpu.eval.postprocess import (
    PostprocessParams as JaxParams,
    ucb_postprocess as jax_postprocess,
)
from blindshadowremoval_tpu_torch.eval import fused
from blindshadowremoval_tpu_torch.eval.branch_probes import (
    PART_KEYS,
    apply_rects,
    disable_branch,
)
from blindshadowremoval_tpu_torch.eval.postprocess import (
    GSC_BRANCHES,
    TSM_PARAMS,
    PostprocessParams,
    composite,
    ucb_postprocess,
)

S = 256
# part-mask rectangles ((rows), (cols)) in PART_KEYS order: the hair band is
# face_hair minus face_no_hair; the forehead lies between row 30 and the brow
BASE_PARTS = (
    ((10, 240), (20, 236)),    # face_hair
    ((30, 232), (40, 216)),    # face_no_hair
    ((170, 195), (95, 165)),   # mouth
    ((120, 160), (115, 145)),  # nose
    ((100, 108), (70, 190)),   # eyebrow
    ((110, 118), (70, 190)),   # eye
    ((108, 120), (65, 195)),   # glasses
)
# a shadow strip below the nose, joined to the nose blob and outside the
# nose's columns: the nose veto cuts it (short reach to row 165, long to 225)
STRIP = (128, 200, 100, 114, 0.5)
# case -> shadow-map paints and input-intensity paints (r0, r1, c0, c1,
# value), the number of below-mouth pixels set to 0.5 (the mouth bands:
# the roi holds 62 x 176 = 10,912 pixels), and part-mask edits
CASES = {
    "thresholds": dict(
        mp=[(10, 240, 20, 40, 0.007), (10, 240, 216, 236, 0.015),
            (50, 60, 90, 170, 0.0), (135, 170, 95, 165, 0.015),
            (170, 195, 95, 165, 0.015), (60, 100, 120, 200, 0.5),
            (205, 212, 60, 67, 0.5)],
        img=[(10, 240, 20, 40, 0.08), (40, 60, 40, 216, 0.3)]),
    "hair_veto": dict(mp=[(40, 160, 216, 236, 0.5), (60, 100, 120, 160, 0.5)]),
    "mouth_band_0": dict(roi=2837),      # frac 0.260
    "mouth_band_1": dict(roi=3344),      # frac 0.306, mean intensity 0.5
    "mouth_band_2": dict(roi=3246),      # frac 0.2975
    "nose_long": dict(mp=[(110, 128, 60, 200, 0.5), STRIP]),    # frac 0.2
    "nose_short": dict(mp=[(110, 128, 60, 200, 0.5), STRIP],
                       img=[(0, 256, 0, 256, 0.1)]),
    "nose_band_1": dict(mp=[(110, 132, 60, 200, 0.5),
                            (132, 133, 115, 118, 0.5), STRIP]),  # 0.3025
    "nose_band_2": dict(mp=[(110, 133, 60, 200, 0.5),
                            (133, 134, 115, 139, 0.5), STRIP]),  # 0.345
    "eyebrow_edge": dict(mp=[(100, 108, 40, 190, 0.5),
                             (60, 100, 120, 200, 0.3)],
                         rects=[(4, 100, 108, 40, 70, 1)]),
}


@functools.lru_cache(maxsize=None)
def _case(name):
    """(mask_pred [S,S,3] f32, input [S,S,3] f32, parts {key: [S,S,3]})."""
    c = CASES[name]
    parts = {}
    for key, ((r0, r1), (c0, c1)) in zip(PART_KEYS, BASE_PARTS):
        m = np.zeros((S, S, 3))
        m[r0:r1, c0:c1] = 1.0
        parts[key] = m
    parts = apply_rects(parts, np.asarray(c.get("rects", []),
                                          np.int32).reshape(-1, 6))
    mp = np.zeros((S, S), np.float32)
    for r0, r1, c0, c1, v in c.get("mp", []):
        mp[r0:r1, c0:c1] = v
    left = c.get("roi", 0)
    for r in range(170, 232):            # raster order through the roi
        take = min(176, left)
        mp[r, 40:40 + take] = 0.5
        left -= take
    img = np.full((S, S), 0.5, np.float32)
    for r0, r1, c0, c1, v in c.get("img", []):
        img[r0:r1, c0:c1] = v
    rng = np.random.default_rng(len(name))
    img3 = np.clip(img[..., None] + rng.uniform(-0.01, 0.01, (S, S, 3)),
                   0.0, 1.0).astype(np.float32)
    return np.repeat(mp[..., None], 3, axis=2), img3, parts


@pytest.fixture(autouse=True)
def one_thread():
    """Label propagation is ~100 small tensor ops; across 6 test workers a
    thread pool per op costs more than it saves."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_params(p: PostprocessParams) -> JaxParams:
    return JaxParams(**dataclasses.asdict(p))


@functools.lru_cache(maxsize=None)
def _run_both(name, params: PostprocessParams):
    mp, img, parts = _case(name)
    args = (mp, img) + tuple(parts[k] for k in PART_KEYS)
    rep_j, rep_t = {}, {}
    det_j, mp_j = jax_postprocess(*args, _jax_params(params), report=rep_j)
    det_t, mp_t = ucb_postprocess(*args, params, report=rep_t, device="cpu")
    return (det_j, mp_j, rep_j), (det_t, mp_t, rep_t)


@pytest.mark.parametrize("name", sorted(CASES))
def test_ucb_postprocess_matches_jax(name):
    (det_j, mp_j, rep_j), (det_t, mp_t, rep_t) = _run_both(
        name, PostprocessParams())
    np.testing.assert_array_equal(det_t, det_j)
    np.testing.assert_array_equal(mp_t, mp_j)
    assert rep_t.keys() == rep_j.keys()
    for key in rep_j:
        assert rep_t[key] == rep_j[key], key


def test_cases_cover_every_branch():
    fired = set()
    for name in CASES:
        _, (_, _, rep) = _run_both(name, PostprocessParams())
        fired |= {b for b in GSC_BRANCHES if rep.get(b)}
    assert fired == set(GSC_BRANCHES)


@pytest.mark.parametrize("name", ["thresholds", "hair_veto", "nose_long",
                                  "nose_band_2"])
def test_ucb_postprocess_tsm_params_match_jax(name):
    (det_j, _, rep_j), (det_t, _, rep_t) = _run_both(name, TSM_PARAMS)
    np.testing.assert_array_equal(det_t, det_j)
    assert rep_t == rep_j


@pytest.mark.parametrize("branch", GSC_BRANCHES)
def test_disable_branch_changes_output_where_jax_does(branch):
    """For each case where the branch fired: the port's output moves under
    disable_branch exactly where the JAX package's does, and the disabled
    outputs agree."""
    cases = [n for n in CASES if _run_both(n, PostprocessParams())[1][2].get(
        branch)]
    assert cases
    for name in cases:
        mp, img, parts = _case(name)
        args = (mp, img) + tuple(parts[k] for k in PART_KEYS)
        (full_j, _, _), (full_t, _, _) = _run_both(name, PostprocessParams())
        off_j = jax_postprocess(*args, jax_disable(JaxParams(), branch))[0]
        off_t = ucb_postprocess(
            *args, disable_branch(PostprocessParams(), branch),
            device="cpu")[0]
        np.testing.assert_array_equal(off_t, off_j)
        assert (np.array_equal(full_t, off_t)
                == np.array_equal(full_j, off_j)), name


def test_composite_clips():
    pred = np.full((4, 4, 3), 1.5, np.float32)
    inp = np.full((4, 4, 3), -0.5, np.float32)
    mask = np.zeros((4, 4, 3), np.float32)
    mask[:2] = 1.0
    out = composite(pred, inp, mask)
    assert out[:2].min() == 1.0 and out[2:].max() == 0.0


def _fused_inputs(name, params):
    mp, img, parts = _case(name)
    pi = fused.prep_part_inputs(parts, params)
    return mp[..., :1], img, parts, pi


@pytest.mark.parametrize("name", sorted(CASES))
def test_fused_postprocess_equals_host(name):
    """The on-device twin gives the host post-processor's detected mask."""
    params = PostprocessParams()
    mp1, img, parts, pi = _fused_inputs(name, params)
    host, _ = ucb_postprocess(np.repeat(mp1, 3, axis=2), img,
                              *(parts[k] for k in PART_KEYS), params,
                              device="cpu")
    pit = fused.PartInputs.stack([pi]).to("cpu")
    kept = fused.fused_postprocess(torch.from_numpy(mp1)[None],
                                   torch.from_numpy(img)[None], pit, params)
    np.testing.assert_array_equal(kept[0].numpy(), host[..., :1])


def test_fused_postprocess_batched_equals_per_image():
    params = PostprocessParams()
    names = sorted(CASES)
    ins = [_fused_inputs(n, params) for n in names]
    report = {}
    batched = fused.fused_postprocess(
        torch.from_numpy(np.stack([i[0] for i in ins])),
        torch.from_numpy(np.stack([i[1] for i in ins])),
        fused.PartInputs.stack([i[3] for i in ins]).to("cpu"), params, report)
    assert report["label_iterations"] > 1
    for j, (mp1, img, _, pi) in enumerate(ins):
        one = fused.fused_postprocess(
            torch.from_numpy(mp1)[None], torch.from_numpy(img)[None],
            fused.PartInputs.stack([pi]).to("cpu"), params)
        torch.testing.assert_close(batched[j], one[0], rtol=0, atol=0,
                                   msg=names[j])


@pytest.mark.parametrize("name", ["thresholds", "mouth_band_1",
                                  "nose_short", "eyebrow_edge"])
def test_fused_postprocess_matches_jax(name):
    params = PostprocessParams()
    mp1, img, parts, pi = _fused_inputs(name, params)
    ref = jax_fused_postprocess(mp1, img, jax_prep(parts, JaxParams()),
                                JaxParams())
    kept = fused.fused_postprocess(
        torch.from_numpy(mp1)[None], torch.from_numpy(img)[None],
        fused.PartInputs.stack([pi]).to("cpu"), params)
    np.testing.assert_array_equal(kept[0].numpy(), np.asarray(ref))


@pytest.mark.parametrize("name", ["thresholds", "eyebrow_edge",
                                  "nose_band_1"])
def test_prep_part_inputs_matches_jax(name):
    _, _, parts = _case(name)
    ours = fused.prep_part_inputs(parts, PostprocessParams())
    theirs = jax_prep(parts, JaxParams())
    for f in dataclasses.fields(fused.PartInputs):
        np.testing.assert_array_equal(getattr(ours, f.name),
                                      np.asarray(getattr(theirs, f.name)),
                                      err_msg=f.name)


@pytest.mark.parametrize("size", [234, 200, 255, 256, 128, 97])
def test_dynamic_resize_matrix_matches_jax(size):
    ours = fused.dynamic_resize_matrix(float(size)).numpy()
    theirs = np.asarray(jax_resize_matrix(np.float32(size)))
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-6)


def test_dynamic_resize_matrix_batched():
    sizes = torch.tensor([234.0, 128.0, 256.0])
    batched = fused.dynamic_resize_matrix(sizes)
    for j, size in enumerate(sizes.tolist()):
        torch.testing.assert_close(batched[j],
                                   fused.dynamic_resize_matrix(size))


@pytest.mark.parametrize("size", [234, 200, 255, 256, 128])
def test_resize_into_box_matches_cv2(size):
    import cv2

    rng = np.random.default_rng(0)
    img = rng.uniform(size=(256, 256, 3)).astype(np.float32)
    ref = cv2.resize(img, (size, size), interpolation=cv2.INTER_LINEAR)
    ref = np.pad(ref, ((0, 256 - size), (0, 256 - size), (0, 0)))
    out = fused.resize_into_box(torch.from_numpy(img),
                                fused.dynamic_resize_matrix(float(size)))
    # the matrix places its taps in f32, as the JAX package does; cv2 in f64
    assert np.abs(out.numpy() - ref).max() < 1e-4
