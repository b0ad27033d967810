"""Anti-aliased landmark skeleton map (port of
`blindshadowremoval_tpu/geometry/landmark_map.py`, numpy only).

`generate_landmark_map` (utils.py:296-322 in the reference) draws the
68-point facial skeleton (jaw, brows, eyes, nose, lips) as anti-aliased
segments, blurs it with a 3x3 Gaussian and max-normalizes it to [0, 255].
The reference draws with `skimage.draw.line_aa`; segments here are Wu's
anti-aliased lines, the coverage model line_aa implements.
"""

from __future__ import annotations

import numpy as np

from blindshadowremoval_tpu_torch.geometry.landmarks import LM_SKELETON_EDGES


def _draw_line_aa(img: np.ndarray, x0: float, y0: float, x1: float,
                  y1: float) -> None:
    """Wu's anti-aliased line into img[y, x] (values max-combined)."""
    steep = abs(y1 - y0) > abs(x1 - x0)
    if steep:
        x0, y0, x1, y1 = y0, x0, y1, x1
    if x0 > x1:
        x0, x1 = x1, x0
        y0, y1 = y1, y0
    dx = x1 - x0
    dy = y1 - y0
    grad = dy / dx if dx != 0 else 1.0

    h, w = img.shape
    xs = np.arange(int(round(x0)), int(round(x1)) + 1)
    ys = y0 + grad * (xs - x0)
    ylo = np.floor(ys).astype(int)
    frac = ys - ylo
    for xi, yi, f in zip(xs, ylo, frac):
        r0, c0 = (xi, yi) if steep else (yi, xi)
        r1, c1 = (xi, yi + 1) if steep else (yi + 1, xi)
        if 0 <= r0 < h and 0 <= c0 < w:
            img[r0, c0] = max(img[r0, c0], 1.0 - f)
        if 0 <= r1 < h and 0 <= c1 < w:
            img[r1, c1] = max(img[r1, c1], f)


def generate_landmark_map(landmarks: np.ndarray, img_size: int) -> np.ndarray:
    """Normalized (68, 2) landmarks -> (img_size, img_size, 1) map on a
    [0, 255] scale: the LM_SKELETON_EDGES segments at landmark * img_size
    (x to columns, y to rows), a 3x3 Gaussian (cv2's sigma 0.8 for that
    size, edge padding), then divided by its peak."""
    lm = np.asarray(landmarks, np.float64) * img_size
    canvas = np.zeros((img_size, img_size), np.float32)
    for a, b in LM_SKELETON_EDGES:
        _draw_line_aa(canvas, lm[a, 0], lm[a, 1], lm[b, 0], lm[b, 1])

    k = np.array([np.exp(-0.5 * (i / 0.8) ** 2) for i in (-1, 0, 1)])
    k /= k.sum()
    blurred = np.apply_along_axis(
        lambda r: np.convolve(np.pad(r, 1, mode="edge"), k, "valid"), 0, canvas)
    blurred = np.apply_along_axis(
        lambda r: np.convolve(np.pad(r, 1, mode="edge"), k, "valid"), 1, blurred)
    peak = blurred.max()
    if peak > 0:
        blurred = blurred / peak * 255.0
    return blurred.reshape(img_size, img_size, 1)
