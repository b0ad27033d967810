"""The benchmark's seeded inputs, made from `--seed` alone: the request
pool of photos and landmarks, each call's order over it, an open loop's
arrival schedule, and video clips.  The program receives only what these
make.  Every seed gives the same amount of work: the same sizes and the
same set of gaps between arrivals, in another order."""

from __future__ import annotations

import numpy as np
import torch

from bench_h100.reference.landmarks import LM_REF


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2 ** 63, *stream])


def photo_pool(seed: int, count: int, sizes: list, face_px: list,
               margin: float, jitter_px: float, device) -> tuple[list, list]:
    """`count` photos (f32 RGB in [0, 1], [H, W, 3]) cycling through
    `sizes` [(H, W)], made on `device` in one draw and brought to the host,
    and their 68 landmarks: the canonical face scaled to a side drawn from
    `face_px` at 512 px (scaled with the photo's shorter side), placed at
    least `margin` px from the border, each point jittered by a normal of
    `jitter_px`."""
    shapes = [tuple(sizes[i % len(sizes)]) for i in range(count)]
    total = sum(h * w * 3 for h, w in shapes)
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    flat = torch.rand(total, generator=gen, device=device).cpu().numpy()
    rng = _rng(seed, 1)
    photos, lms, ofs = [], [], 0
    for h, w in shapes:
        photos.append(flat[ofs:ofs + h * w * 3].reshape(h, w, 3))
        ofs += h * w * 3
        side = rng.uniform(*face_px) * min(h, w) / 512.0
        x0 = rng.uniform(margin, w - side - margin)
        y0 = rng.uniform(margin, h - side - margin)
        lm = LM_REF * side + np.array([x0, y0]) + rng.normal(
            scale=jitter_px, size=LM_REF.shape)
        lms.append(lm.astype(np.float32))
    return photos, lms


def call_order(seed: int, call: int, pool: int, requests: int) -> np.ndarray:
    """The pool indices of one call's `requests` requests: each photo the
    same number of times (requests / pool), in a seeded order."""
    if requests % pool:
        raise ValueError(f"{requests} requests do not cover a pool of "
                         f"{pool} evenly")
    return _rng(seed, 2, call).permutation(
        np.tile(np.arange(pool), requests // pool))


def poisson_schedule(seed: int, rate: float, seconds: float) -> np.ndarray:
    """Due times (s from the window's start) of an open loop at `rate`
    requests/s over `seconds`: the n = rate x seconds exponential gaps at
    their quantiles (i + 0.5) / n, scaled to sum to `seconds`, in a seeded
    order, so every seed offers the same gaps and the same count."""
    n = int(round(rate * seconds))
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / rate
    gaps *= seconds / gaps.sum()
    return np.cumsum(_rng(seed, 3).permutation(gaps))


def video_clips(seed: int, clips: int, frames: int, size: int, drift: float,
                jitter: float, device) -> list[dict]:
    """`clips` clips of `frames` aligned faces (f32 [F, size, size, 3] in
    [0, 1], made on `device` in one draw) with normalized landmarks that
    drift smoothly: the canonical face moved by a random walk of `drift`
    (fraction of the side) a frame, each point jittered by `jitter`."""
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    imgs = torch.rand((clips, frames, size, size, 3), generator=gen,
                      device=device).cpu().numpy()
    rng = _rng(seed, 4)
    out = []
    for c in range(clips):
        walk = np.cumsum(rng.normal(scale=drift, size=(frames, 1, 2)), 0)
        lm = LM_REF[None] + walk + rng.normal(scale=jitter,
                                              size=(frames,) + LM_REF.shape)
        out.append({"img": imgs[c], "lm": lm.astype(np.float32)})
    return out
