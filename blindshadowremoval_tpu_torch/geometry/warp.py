"""Bilinear resize with TF semantics (port of
`blindshadowremoval_tpu/geometry/warp.py:resize_bilinear`).

`tf.image.resize(bilinear)`, which the reference uses everywhere, samples
at half-pixel centres with edge clamping and does not blur on downsample.
`F.interpolate(mode="bilinear", align_corners=False, antialias=False)` is
the same sampling rule.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear_nchw(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """[B, C, H, W] -> [B, C, *size]."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False,
                         antialias=False)


def resize_bilinear(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """[..., H, W, C] -> [..., *size, C] (the JAX package's NHWC layout)."""
    *lead, h, w, c = x.shape
    if (h, w) == tuple(size):
        return x
    xb = x.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    y = resize_bilinear_nchw(xb, size).permute(0, 2, 3, 1)
    return y.reshape(*lead, size[0], size[1], c)
