"""Host-side face crop/align and its training augmentation (port of
`blindshadowremoval_tpu/geometry/crop.py`: `pts_load`, `rotate_center`,
`rotate_image_and_landmarks`, `face_crop_and_resize`, `offline_crop`).

Box convention (utils.py:387-400 in the reference): a square window of
side 2L centred on the landmark extent, shifted up by 0.2L, where L = 1.4 x
half the larger landmark extent.  Landmarks are returned normalized by the
box side (2L).  With `aug=True` (the train parser) the image may first be
rotated by up to 10 degrees about its centre, and the box is jittered in
place and scale; the draws come from the caller's numpy Generator in the
JAX package's order, so one seed gives both packages the same crop.  The
crop and resize run in `utils/native.py`'s g++ library, as in the JAX
package.
"""

from __future__ import annotations

import numpy as np

from blindshadowremoval_tpu_torch.geometry.landmarks import mirror_landmarks
from blindshadowremoval_tpu_torch.utils.imageio import resize_linear
from blindshadowremoval_tpu_torch.utils.native import crop_resize


def pts_load(path: str) -> np.ndarray:
    """A `.pts` landmark file (utils.py:340-354): the points listed between
    the '{' and '}' lines, one "x y" pair a line, as [N, 2] float32."""
    with open(path) as fh:
        rows = [r.strip() for r in fh]
    head = rows.index("{") + 1
    tail = rows.index("}")
    pts = [tuple(float(v) for v in line.split()) for line in rows[head:tail]]
    return np.asarray(pts, dtype=np.float32)


def _rotation_inverse(deg: float, cx: float, cy: float) -> np.ndarray:
    """The 2x3 map from output to source pixel of `cv2.warpAffine` with
    `cv2.getRotationMatrix2D((cx, cy), deg, 1.0)`: the forward matrix, then
    inverted as cv2 inverts it, in f64."""
    a = deg * (np.pi / 180.0)
    alpha, beta = np.cos(a), np.sin(a)
    m = np.array([[alpha, beta, (1.0 - alpha) * cx - beta * cy],
                  [-beta, alpha, beta * cx + (1.0 - alpha) * cy]])
    det = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    det = 1.0 / det if det != 0 else 0.0
    a11, a22 = m[1, 1] * det, m[0, 0] * det
    a12, a21 = -m[0, 1] * det, -m[1, 0] * det
    b1 = -a11 * m[0, 2] - a12 * m[1, 2]
    b2 = -a21 * m[0, 2] - a22 * m[1, 2]
    return np.array([[a11, a12, b1], [a21, a22, b2]])


def _fixed_point_positions(m: np.ndarray, ys: np.ndarray, xs: np.ndarray):
    """cv2's fixed-point source positions of output rows `ys` and columns
    `xs` (imgwarp.cpp, AB_BITS=10, INTER_BITS=5): each row's offset and
    each column's step rounded to 1/1024 pixel, their sum to 1/32."""
    yq, xq = ys[:, None], xs[None, :]
    x0 = np.rint((m[0, 1] * yq + m[0, 2]) * 1024).astype(np.int64) + 16
    y0 = np.rint((m[1, 1] * yq + m[1, 2]) * 1024).astype(np.int64) + 16
    xi = (x0 + np.rint(m[0, 0] * xq * 1024).astype(np.int64)) >> 5
    yi = (y0 + np.rint(m[1, 0] * xq * 1024).astype(np.int64)) >> 5
    return xi / 32.0, yi / 32.0


def rotate_center(img: np.ndarray, deg: float,
                  region: tuple | None = None) -> np.ndarray:
    """Rotate CCW by `deg` about the image centre (n-1)/2, size unchanged:
    `cv2.warpAffine(img, cv2.getRotationMatrix2D(...), INTER_LINEAR)` with
    its constant-0 border (a corner outside the image contributes 0).  As
    OpenCV 5 does it: an f64 image is sampled at source positions rounded
    to 1/32 pixel (its fixed-point remap), any other at exact positions.
    `region` (r0, r1, c0, c1) computes only those output rows and columns
    and leaves the rest 0.  Keeps a float dtype (f32 otherwise); 2-D in,
    2-D out."""
    x = np.asarray(img)
    if x.dtype != np.float64:
        x = x.astype(np.float32)
    flat = x.ndim == 2
    if flat:
        x = x[..., None]
    rows, cols, c = x.shape
    r0, r1, c0, c1 = region or (0, rows, 0, cols)
    m = _rotation_inverse(deg, (cols - 1) / 2.0, (rows - 1) / 2.0)
    ys = np.arange(r0, r1, dtype=np.float64)
    xs = np.arange(c0, c1, dtype=np.float64)
    if x.dtype == np.float64:
        sx, sy = _fixed_point_positions(m, ys, xs)
    else:
        sx = m[0, 0] * xs[None, :] + m[0, 1] * ys[:, None] + m[0, 2]
        sy = m[1, 0] * xs[None, :] + m[1, 1] * ys[:, None] + m[1, 2]
    # a zero border of one pixel stands for cv2's constant border: a
    # sample whose top-left corner lies in [-1, n-1] reads its outside
    # corners from it, and one further out is wholly outside (0)
    x0 = np.floor(sx).astype(np.int64)
    y0 = np.floor(sy).astype(np.int64)
    inside = (x0 >= -1) & (x0 < cols) & (y0 >= -1) & (y0 < rows)
    fx = (sx - x0).astype(x.dtype)[..., None]
    fy = (sy - y0).astype(x.dtype)[..., None]
    pad = np.zeros((rows + 2, cols + 2, c), x.dtype)
    pad[1:-1, 1:-1] = x
    src = pad.reshape(-1, c)
    idx = ((np.clip(y0, -1, rows - 1) + 1) * (cols + 2)
           + np.clip(x0, -1, cols - 1) + 1)

    def lerp_row(i):
        left = np.take(src, i, axis=0)
        return left + fx * (np.take(src, i + 1, axis=0) - left)

    top = lerp_row(idx)
    part = top + fy * (lerp_row(idx + cols + 2) - top)
    part *= inside[..., None]
    if region is None:
        out = part
    else:
        out = np.zeros_like(x)
        out[r0:r1, c0:c1] = part
    return out[..., 0] if flat else out


def _rotate_landmarks(lm: np.ndarray, deg: float, rows: int,
                      cols: int) -> np.ndarray:
    """Landmarks turned with the image (utils.py:370-382), about (n/2):
    the reference's half-pixel quirk, kept."""
    s, c = np.sin(np.deg2rad(deg)), np.cos(np.deg2rad(deg))
    x = lm[:, 0] - cols / 2
    y = lm[:, 1] - rows / 2
    out = np.array(lm, copy=True)
    if not np.issubdtype(out.dtype, np.floating):
        out = out.astype(np.float32)
    out[:, 0] = y * s + x * c + cols / 2
    out[:, 1] = y * c - x * s + rows / 2
    return out


def rotate_image_and_landmarks(img: np.ndarray, lm: np.ndarray, deg: float):
    """Rotate the image CCW by `deg` about its centre, with matching
    landmarks."""
    rows, cols = img.shape[:2]
    return rotate_center(img, deg), _rotate_landmarks(lm, deg, rows, cols)


def face_crop_and_resize(img: np.ndarray, lm: np.ndarray, fsize: int,
                         aug: bool = False,
                         rng: np.random.Generator | None = None):
    """Crop the face box, resize to `fsize`, normalize landmarks.

    Returns (img, lm_norm, lm_mirror_norm, box); `box` is the crop window
    in the coordinates of the (rotated) image, before zero padding.  With
    `aug`, draws from `rng`: the rotation gate and angle, then the box's
    shifts and scale.
    """
    img = np.asarray(img)
    # keep the caller's FLOAT landmark dtype: the box corners go through
    # int() truncation, so f32-vs-f64 rounding of the centre/length (e.g.
    # 128.0f vs 127.99999809) shifts the crop window by a whole pixel.
    # Integer landmarks promote to float32.
    lm = np.array(lm, copy=True)
    if not np.issubdtype(lm.dtype, np.floating):
        lm = lm.astype(np.float32)
    rows, cols = img.shape[:2]
    deg = None
    if aug:
        if rng is None:
            rng = np.random.default_rng()
        if rng.uniform() > 0.5:
            deg = rng.uniform(-10, 10)
            lm = _rotate_landmarks(lm, deg, rows, cols)
    lm_mirror = mirror_landmarks(lm, cols)

    cx = (lm[:, 0].min() + lm[:, 0].max()) / 2
    cy = (lm[:, 1].min() + lm[:, 1].max()) / 2
    length = max((lm[:, 0].max() - lm[:, 0].min()) / 2,
                 (lm[:, 1].max() - lm[:, 1].min()) / 2) * 1.4
    if aug:
        cx += rng.uniform(-0.1, 0.1) * length
        cy += rng.uniform(-0.1, 0.1) * length
        length *= rng.uniform(0.9, 1.1)

    box = [int(cx) - int(length), int(cy) - int(length * 1.2),
           int(cx) + int(length),
           int(cy) + int(length) + int(length) - int(length * 1.2)]
    box_m = [cols - box[2], box[1], cols - box[0], box[3]]

    lm[:, 0] -= box[0]
    lm[:, 1] -= box[1]
    lm_mirror[:, 0] -= box_m[0]
    lm_mirror[:, 1] -= box_m[1]

    if (box[3] - box[1]) == (box[2] - box[0]) and (box[3] - box[1]) > 0:
        if deg is not None:
            # the crop's bilinear taps read rows box[1]-1 .. box[3] and the
            # same span of columns: rotate just those
            img = rotate_center(img, deg, (
                max(box[1] - 1, 0), min(box[3] + 1, rows),
                max(box[0] - 1, 0), min(box[2] + 1, cols)))
        img = crop_resize(img.astype(np.float32), box, fsize)
    else:
        img = np.zeros((fsize, fsize, img.shape[2]), np.float32)

    # degenerate landmark sets (zero extent) would divide by zero; guard so
    # landmarks stay finite
    side = max(length * 2, 1e-6)
    return (img.astype(np.float32), (lm / side).astype(np.float32),
            (lm_mirror / side).astype(np.float32),
            np.asarray(box, np.float32))


def offline_crop(img: np.ndarray, lm: np.ndarray, out_size: int = 256,
                 min_face: int = 250):
    """The offline dataset-prep crop (dataprocess.py:39-78): a square of
    1.45x the landmark extent, its centre shifted up by 1.2x, zero-padded
    where it leaves the image, resized to `out_size` (cv2's f32 bilinear).
    A face whose square is at most `min_face` px is rejected (None).
    Returns (crop [out_size, out_size, C] f32 on the input's scale,
    landmarks rescaled into it, f32)."""
    img = np.asarray(img)
    lm = np.array(lm, dtype=np.float64, copy=True)
    rows, cols = img.shape[:2]

    cx = (lm[:, 0].min() + lm[:, 0].max()) / 2
    cy = (lm[:, 1].min() + lm[:, 1].max()) / 2
    length = max((lm[:, 0].max() - lm[:, 0].min()) / 2,
                 (lm[:, 1].max() - lm[:, 1].min()) / 2) * 1.45
    box = [int(cx) - int(length), int(cy) - int(length * 1.2),
           int(cx) + int(length),
           int(cy) + int(length) + int(length) - int(length * 1.2)]

    lm[:, 0] -= box[0]
    lm[:, 1] -= box[1]

    pad_x = max(-box[0], box[2] - cols) if (box[0] < 0 or box[2] > cols) else 0
    pad_y = max(-box[1], box[3] - rows) if (box[1] < 0 or box[3] > rows) else 0
    if pad_x > 0 or pad_y > 0:
        big = np.zeros((rows + 2 * pad_y + 2, cols + 2 * pad_x + 2,
                        img.shape[2]), dtype=img.dtype)
        big[pad_y:pad_y + rows, pad_x:pad_x + cols, :] = img
        img = big
        box = [box[0] + pad_x, box[1] + pad_y, box[2] + pad_x, box[3] + pad_y]

    crop = img[box[1]:box[3], box[0]:box[2], :]
    side = crop.shape[0]
    if side <= min_face or crop.shape[0] != crop.shape[1]:
        return None
    out = resize_linear(crop.astype(np.float32), (out_size, out_size))
    lm = lm * (out_size / side)
    return out, lm.astype(np.float32)
