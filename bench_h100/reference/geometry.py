"""Plain reference of the served path's geometry: the face crop and
alignment, the Delaunay topologies, and the UV, offset and face maps
rasterized by barycentric interpolation.

Written from the published method (the reference repository's
`utils.py`: the crop box, `warp.py`: the UV and offset maps, the face
region's hull blurred by a 5x5 Gaussian) in plain numpy and PyTorch, f32,
on whatever device the tensors lie.  The rasterizer tests every triangle
against every pixel and keeps the first that holds it, as the program's
does, so the two pick the same triangle wherever their arithmetic agrees.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from scipy.spatial import Delaunay

from bench_h100.reference.landmarks import (
    ANCHOR_POINTS,
    LM_REF,
    UV_TABLE,
    forehead_points,
)

MAX_TRIANGLES = 192
_UV_VALUES = np.stack([UV_TABLE[:, 1], UV_TABLE[:, 0], UV_TABLE[:, 2]],
                      1).astype(np.float32)


def crop_box(lm: np.ndarray) -> tuple[list, float]:
    """The square crop window (x0, y0, x1, y1) of a face and its side: 2L
    around the landmarks' extent, shifted up by 0.2L, L = 1.4 x half the
    larger extent."""
    cx = (lm[:, 0].min() + lm[:, 0].max()) / 2
    cy = (lm[:, 1].min() + lm[:, 1].max()) / 2
    length = max((lm[:, 0].max() - lm[:, 0].min()) / 2,
                 (lm[:, 1].max() - lm[:, 1].min()) / 2) * 1.4
    box = [int(cx) - int(length), int(cy) - int(length * 1.2),
           int(cx) + int(length),
           int(cy) + int(length) + int(length) - int(length * 1.2)]
    return box, max(length * 2, 1e-6)


def crop_resize(img: np.ndarray, box, size: int) -> np.ndarray:
    """Zero-padded crop of `box` resized bilinearly to (size, size), with
    f64 sample positions at the output pixels' centres."""
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
        vals = img[np.clip(yi, 0, h - 1)[:, None], np.clip(xi, 0, w - 1)[None]]
        return vals * valid[..., None]

    top = take(yy0, xx0) * (1 - fx) + take(yy0, xx0 + 1) * fx
    bot = take(yy0 + 1, xx0) * (1 - fx) + take(yy0 + 1, xx0 + 1) * fx
    return (top * (1 - fy) + bot * fy).astype(np.float32)


def face_crop(img: np.ndarray, lm: np.ndarray, size: int):
    """(crop [size, size, 3] f32, landmarks normalized by the box side)."""
    lm = np.array(lm, dtype=np.float32, copy=True)
    box, side = crop_box(lm)
    if (box[3] - box[1]) == (box[2] - box[0]) and (box[3] - box[1]) > 0:
        crop = crop_resize(img, box, size)
    else:
        crop = np.zeros((size, size, img.shape[2]), np.float32)
    lm[:, 0] -= box[0]
    lm[:, 1] -= box[1]
    return crop, (lm / side).astype(np.float32)


def triangles(points: np.ndarray) -> np.ndarray:
    """Delaunay simplices of `points`, padded with (-1, -1, -1) rows to
    MAX_TRIANGLES."""
    simplices = Delaunay(np.asarray(points, np.float64)).simplices
    pad = np.full((MAX_TRIANGLES - len(simplices), 3), -1, np.int64)
    return np.concatenate([simplices.astype(np.int64), pad])


def rasterize(points: torch.Tensor, tris: torch.Tensor, values: torch.Tensor,
              size: int) -> torch.Tensor:
    """Piecewise-linear interpolation of per-point `values` [B, P, K] over
    the triangles `tris` [B, T, 3] (-1 padded) of `points` [B, P, 2] (x, y
    in [0, 1]) onto a size x size grid at (c, r) / (size - 1); 0 outside
    every triangle.  Each pixel takes the first triangle whose three
    barycentric weights are >= -1e-7.  Returns [B, size, size, K] f32."""
    eps = 1e-7
    dev = points.device
    b, t_max = tris.shape[:2]
    lin = torch.arange(size, dtype=torch.float32, device=dev) / (size - 1)
    xs, ys = lin.repeat(size), lin.repeat_interleave(size)
    valid = tris[..., 0] >= 0
    idx = tris.clamp(min=0).long()
    corner = torch.gather(points.float(), 1,
                          idx.reshape(b, -1, 1).expand(-1, -1, 2)
                          ).reshape(b, t_max, 3, 2)
    ax, ay = corner[..., 0, 0], corner[..., 0, 1]
    bx, by = corner[..., 1, 0], corner[..., 1, 1]
    cx, cy = corner[..., 2, 0], corner[..., 2, 1]
    den = (by - cy) * (ax - cx) + (cx - bx) * (ay - cy)
    den = torch.where(den.abs() < 1e-12, torch.full_like(den, 1e-12), den)
    found = torch.full((b, size * size), -1, dtype=torch.long, device=dev)
    for t in range(t_max):
        w0 = ((by[:, t, None] - cy[:, t, None]) * (xs - cx[:, t, None])
              + (cx[:, t, None] - bx[:, t, None]) * (ys - cy[:, t, None])
              ) / den[:, t, None]
        w1 = ((cy[:, t, None] - ay[:, t, None]) * (xs - cx[:, t, None])
              + (ax[:, t, None] - cx[:, t, None]) * (ys - cy[:, t, None])
              ) / den[:, t, None]
        w2 = 1.0 - w0 - w1
        inside = ((w0 >= -eps) & (w1 >= -eps) & (w2 >= -eps)
                  & valid[:, t, None] & (found < 0))
        found = torch.where(inside, torch.full_like(found, t), found)
    hit = found >= 0
    t = found.clamp(min=0)

    def pick(v):
        return torch.gather(v, 1, t)

    gax, gay, gbx, gby, gcx, gcy, gden = (
        pick(v) for v in (ax, ay, bx, by, cx, cy, den))
    w0 = ((gby - gcy) * (xs - gcx) + (gcx - gbx) * (ys - gcy)) / gden
    w1 = ((gcy - gay) * (xs - gcx) + (gax - gcx) * (ys - gcy)) / gden
    w2 = 1.0 - w0 - w1
    vidx = torch.gather(idx, 1, t.unsqueeze(-1).expand(-1, -1, 3))
    k = values.shape[-1]
    vals = values.float()

    def vert(j):
        return torch.gather(vals, 1, vidx[..., j:j + 1].expand(-1, -1, k))

    out = w0[..., None] * vert(0) + w1[..., None] * vert(1) \
        + w2[..., None] * vert(2)
    out = torch.where(hit[..., None], out, torch.zeros_like(out))
    return out.reshape(b, size, size, k)


def gauss5(x: torch.Tensor) -> torch.Tensor:
    """5x5 Gaussian blur (sigma 1.1, OpenCV's for ksize 5) of [B, H, W, C]
    with replicated edges."""
    n = torch.arange(-2, 3, dtype=torch.float32, device=x.device)
    k = torch.exp(-0.5 * (n / 1.1) ** 2)
    k = k / k.sum()
    c = x.shape[-1]
    y = F.pad(x.permute(0, 3, 1, 2), (2, 2, 2, 2), mode="replicate")
    y = F.conv2d(y, k.view(1, 1, 5, 1).expand(c, 1, 5, 1), groups=c)
    y = F.conv2d(y, k.view(1, 1, 1, 5).expand(c, 1, 1, 5), groups=c)
    return y.permute(0, 2, 3, 1)


def _offsets(delta: torch.Tensor) -> torch.Tensor:
    """(row delta, col delta, 0) of per-point (x, y) deltas."""
    return torch.cat([delta[..., 1:2], delta[..., 0:1],
                      torch.zeros_like(delta[..., :1])], dim=-1)


def geometry_maps(lms: list, size: int, device) -> dict:
    """The UV map [B,S,S,3], the offset maps into and out of the canonical
    face (reg [B,S,S,6]) and the soft face region [B,S,S,1] of normalized
    landmark sets, each triangulated here."""
    with_anchors = [np.concatenate([lm, ANCHOR_POINTS]) for lm in lms]
    face_pts = [np.concatenate([lm, forehead_points(lm, 0.8)]) for lm in lms]
    ref = np.concatenate([LM_REF, ANCHOR_POINTS])

    def stack(arrs):
        return torch.from_numpy(np.stack(arrs)).to(device)

    b = len(lms)
    lm_t, anch_t = stack(lms).float(), stack(with_anchors).float()
    ref_t = torch.from_numpy(ref).to(device).float().expand(b, -1, -1)
    uv = rasterize(lm_t, stack([triangles(p) for p in lms]),
                   torch.from_numpy(_UV_VALUES).to(device).expand(b, -1, -1),
                   size)
    reg_in = rasterize(ref_t, stack([triangles(ref)] * b),
                       _offsets(anch_t - ref_t), size)
    reg_out = rasterize(anch_t, stack([triangles(p) for p in with_anchors]),
                        _offsets(ref_t - anch_t), size)
    fp = stack(face_pts).float()
    face = rasterize(fp, stack([triangles(p) for p in face_pts]),
                     torch.ones(fp.shape[:2] + (1,), device=device), size)
    return {"uv": uv, "reg": torch.cat([reg_in, reg_out], -1),
            "face": gauss5((face > 0).float())}
