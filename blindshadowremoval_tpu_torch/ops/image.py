"""Colour spaces, gradients and resampling of [..., H, W, C] images (port of
`blindshadowremoval_tpu/ops/image.py`)."""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

# ITU-R BT.601 luma weights used by tf.image.rgb_to_grayscale.
_GRAY_W = (0.2989, 0.5870, 0.1140)

# BT.601 YUV matrix rows as inlined by the reference (utils.py:38-43).
_YUV = np.array(
    [[0.299000, 0.587000, 0.114000],
     [-0.168736, -0.331264, 0.500000],
     [0.500000, -0.418688, -0.081312]], np.float32)


def dequantize(x: torch.Tensor) -> torch.Tensor:
    """[0,1] planes sent as fixed point (uint16 /65535, uint8 /255) -> f32
    on their device; anything else as is.  uint16 takes few torch ops, so
    it is converted before any arithmetic."""
    if x.dtype == torch.uint16:
        return x.to(torch.float32) / 65535.0
    if x.dtype == torch.uint8:
        return x.to(torch.float32) / 255.0
    return x


def rgb_to_grayscale(x: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 1] luma, computed in x's dtype."""
    w = torch.tensor(_GRAY_W, dtype=x.dtype, device=x.device)
    return (x * w).sum(dim=-1, keepdim=True)


def rgb_to_yuv(x: torch.Tensor) -> torch.Tensor:
    """[..., 3] RGB -> YUV with the reference's inline matrix."""
    m = torch.from_numpy(_YUV).to(device=x.device, dtype=x.dtype)
    return torch.matmul(x, m.t())


def rgb_to_hsv(x: torch.Tensor) -> torch.Tensor:
    """tf.image.rgb_to_hsv; input in [0, 1], h in [0, 1]."""
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    mx = x.amax(dim=-1)
    mn = x.amin(dim=-1)
    diff = mx - mn
    safe = torch.where(diff > 0, diff, torch.ones_like(diff))
    rc = (mx - r) / safe
    gc = (mx - g) / safe
    bc = (mx - b) / safe
    h = torch.where(mx == r, bc - gc,
                    torch.where(mx == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.remainder(h / 6.0, 1.0)
    h = torch.where(diff > 0, h, torch.zeros_like(h))
    s = torch.where(mx > 0, diff / torch.where(mx > 0, mx, torch.ones_like(mx)),
                    torch.zeros_like(mx))
    return torch.stack([h, s, mx], dim=-1)


def hsv_to_rgb(x: torch.Tensor) -> torch.Tensor:
    """tf.image.hsv_to_rgb.  The six-way sextant pick is a chain of
    elementwise selects, not a gather."""
    h, s, v = x[..., 0], x[..., 1], x[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)

    def pick(opts):
        out = opts[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, opts[k], out)
        return out

    r = pick([v, q, p, p, t, v])
    g = pick([t, v, v, q, p, p])
    b = pick([p, p, t, v, v, q])
    return torch.stack([r, g, b], dim=-1)


def adjust_saturation(x: torch.Tensor, factor) -> torch.Tensor:
    """tf.image.adjust_saturation: scale S in HSV space, clip to [0, 1].
    `factor` is a scalar or broadcasts against x[..., 0]."""
    hsv = rgb_to_hsv(x.clamp(0.0, 1.0))
    s = (hsv[..., 1] * factor).clamp(0.0, 1.0)
    return hsv_to_rgb(torch.stack([hsv[..., 0], s, hsv[..., 2]], dim=-1))


def image_gradients(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """tf.image.image_gradients: forward differences, zero at the far edge.
    img [B, H, W, C] -> (dy, dx), each [B, H, W, C]."""
    dy = F.pad(img[:, 1:] - img[:, :-1], (0, 0, 0, 0, 0, 1))
    dx = F.pad(img[:, :, 1:] - img[:, :, :-1], (0, 0, 0, 1))
    return dy, dx


def flip_left_right(x: torch.Tensor) -> torch.Tensor:
    """Horizontal flip of [..., H, W, C]."""
    return torch.flip(x, dims=(-2,))


@functools.lru_cache(maxsize=64)
def _nearest_index(out_size: int, in_size: int) -> np.ndarray:
    """Source index of each output row of a NEAREST resize with half-pixel
    centres (the one-hot rows of image.py:183-193)."""
    idx = np.floor((np.arange(out_size) + 0.5) * (in_size / out_size))
    return np.clip(idx.astype(np.int64), 0, in_size - 1)


def resize_nearest(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """tf.image.resize NEAREST with half-pixel centres, [..., H, W, C].
    A selection is exact, so it is an index, not the JAX package's one-hot
    products."""
    h, w = x.shape[-3:-1]
    if (h, w) == tuple(size):
        return x
    rows = torch.from_numpy(_nearest_index(size[0], h)).to(x.device)
    cols = torch.from_numpy(_nearest_index(size[1], w)).to(x.device)
    return x.index_select(-3, rows).index_select(-2, cols)
