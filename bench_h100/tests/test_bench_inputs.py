"""The seeded generators repeat exactly for a seed and differ across
seeds, and every seed gets the same amount of work."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from bench_h100.harness import inputs

SEEDS = (7, 2 ** 31 + 11, 3_000_000_001)
POOL = dict(count=6, sizes=[[96, 96], [80, 120], [120, 90]],
            face_px=[220, 320], margin=4, jitter_px=1.5)


def _pool(seed):
    return inputs.photo_pool(seed, POOL["count"], POOL["sizes"],
                             [v * 96 / 512 for v in POOL["face_px"]],
                             POOL["margin"], POOL["jitter_px"], "cpu")


@pytest.mark.parametrize("seed", SEEDS)
def test_photo_pool_repeats(seed):
    (p1, l1), (p2, l2) = _pool(seed), _pool(seed)
    assert all(np.array_equal(a, b) for a, b in zip(p1, p2))
    assert all(np.array_equal(a, b) for a, b in zip(l1, l2))
    assert [p.shape[:2] for p in p1] == [tuple(POOL["sizes"][i % 3])
                                         for i in range(POOL["count"])]
    for photo, lm in zip(p1, l1):
        h, w = photo.shape[:2]
        assert lm.shape == (68, 2) and lm.min() > 0
        assert lm[:, 0].max() < w and lm[:, 1].max() < h


def test_photo_pool_differs_across_seeds():
    (p1, l1), (p2, l2) = _pool(SEEDS[0]), _pool(SEEDS[1])
    assert not np.array_equal(p1[0], p2[0])
    assert not np.array_equal(l1[0], l2[0])


def test_call_order_covers_pool_evenly():
    a = inputs.call_order(SEEDS[1], 3, 64, 256)
    assert np.array_equal(a, inputs.call_order(SEEDS[1], 3, 64, 256))
    assert not np.array_equal(a, inputs.call_order(SEEDS[1], 4, 64, 256))
    assert not np.array_equal(a, inputs.call_order(SEEDS[2], 3, 64, 256))
    assert np.array_equal(np.bincount(a), np.full(64, 4))
    with pytest.raises(ValueError):
        inputs.call_order(1, 0, 64, 100)


def test_schedule_same_gaps_other_order():
    s1 = inputs.poisson_schedule(SEEDS[0], 96.0, 20.0)
    s2 = inputs.poisson_schedule(SEEDS[1], 96.0, 20.0)
    assert np.array_equal(s1, inputs.poisson_schedule(SEEDS[0], 96.0, 20.0))
    assert len(s1) == len(s2) == 1920
    assert not np.array_equal(s1, s2)
    g1, g2 = np.diff(s1, prepend=0.0), np.diff(s2, prepend=0.0)
    assert np.allclose(np.sort(g1), np.sort(g2))
    assert s1[-1] == pytest.approx(20.0) and (g1 > 0).all()
    # the gaps are exponential at the rate: mean 1/rate, CV near 1
    assert g1.mean() == pytest.approx(1 / 96.0, rel=1e-6)
    assert g1.std() / g1.mean() == pytest.approx(1.0, abs=0.05)


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_video_clips_repeat_and_drift(seed):
    c1 = inputs.video_clips(seed, 2, 5, 32, 0.004, 0.002, "cpu")
    c2 = inputs.video_clips(seed, 2, 5, 32, 0.004, 0.002, "cpu")
    for a, b in zip(c1, c2):
        assert np.array_equal(a["img"], b["img"])
        assert np.array_equal(a["lm"], b["lm"])
    step = np.abs(np.diff(c1[0]["lm"].mean(1), axis=0))
    assert step.max() < 0.05           # smooth from frame to frame
    other = inputs.video_clips(seed + 1, 2, 5, 32, 0.004, 0.002, "cpu")
    assert not np.array_equal(c1[0]["lm"], other[0]["lm"])


def test_weights_repeat_and_differ():
    from bench_h100.harness import cells, serve
    from blindshadowremoval_tpu_torch.config import get_config

    config = dict(cells.load("gsc-serve-batch").config, img_size=64, n_res=2)
    cfg = get_config("in_the_wild", img_size=64, n_res=2)
    a = serve.seeded_weights(config, cfg, SEEDS[1], "cpu")
    b = serve.seeded_weights(config, cfg, SEEDS[1], "cpu")
    c = serve.seeded_weights(config, cfg, SEEDS[2], "cpu")
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv1.conv.weight"], c["conv1.conv.weight"])
