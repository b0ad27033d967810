"""Host crop + resize (port of `blindshadowremoval_tpu/utils/native.py`).

Only the numpy version of `crop_resize` is ported, equal bit for bit to
the JAX package's numpy fallback; the g++-built loader (`native/loader.cc`)
is ROADMAP item C6.  Sampling: half-pixel bilinear over a zero-padded
plane.
"""

from __future__ import annotations

import numpy as np


def crop_resize(img: np.ndarray, box, size: int) -> np.ndarray:
    """Zero-padded crop of `box` (x0, y0, x1, y1) of img[H, W, C] plus a
    bilinear resize to (size, size)."""
    img = np.ascontiguousarray(img, np.float32)
    x0, y0, x1, y1 = [int(v) for v in box]
    h, w, _ = img.shape
    ys = y0 + (np.arange(size) + 0.5) * (y1 - y0) / size - 0.5
    xs = x0 + (np.arange(size) + 0.5) * (x1 - x0) / size - 0.5
    yy0 = np.floor(ys).astype(np.int64)
    xx0 = np.floor(xs).astype(np.int64)
    fy = (ys - yy0)[:, None, None]
    fx = (xs - xx0)[None, :, None]

    def take(yi, xi):
        valid = ((yi[:, None] >= 0) & (yi[:, None] < h)
                 & (xi[None, :] >= 0) & (xi[None, :] < w))
        ycl = np.clip(yi, 0, h - 1)
        xcl = np.clip(xi, 0, w - 1)
        vals = img[ycl[:, None], xcl[None, :], :]
        return vals * valid[..., None]

    v00 = take(yy0, xx0)
    v01 = take(yy0, xx0 + 1)
    v10 = take(yy0 + 1, xx0)
    v11 = take(yy0 + 1, xx0 + 1)
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    return (top * (1 - fy) + bot * fy).astype(np.float32)
