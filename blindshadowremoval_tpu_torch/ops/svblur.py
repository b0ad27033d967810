"""Spatially varying blur through a Perlin-guided blur pyramid (port of
`blindshadowremoval_tpu/ops/svblur.py`, reference utils.py:836-900)."""

from __future__ import annotations

import torch

from blindshadowremoval_tpu_torch.ops.filters import disc_blur
from blindshadowremoval_tpu_torch.ops.perlin import perlin_collection


def spatially_varying_blur(draws: dict, image: torch.Tensor,
                           blur_size: torch.Tensor) -> torch.Tensor:
    """image [B, H, W, C]; blur_size [B] (the reference draws 1..2).

    Three disc-blur levels at radii blur_size * {1, 2, 4} are blended per
    pixel by a single-octave Perlin guide normalized to [0, 3].
    draws: "pers" [B], "angles" (one octave from 2x2)."""
    num_levels = 3
    blur_size = blur_size.to(torch.float32)
    pyramid = [disc_blur(image, blur_size * (2 ** i))
               for i in range(num_levels)]
    guide = perlin_collection(draws["angles"], tuple(image.shape[1:3]),
                              draws["pers"])
    guide = guide - guide.amin(dim=(1, 2), keepdim=True)
    guide = guide / (guide.amax(dim=(1, 2), keepdim=True) + 1e-12)
    guide = torch.clamp(guide / (1.0 / num_levels), 0.0, float(num_levels))
    recon = pyramid[num_levels - 1]
    for i in range(num_levels - 2, -1, -1):
        alpha = torch.clamp(guide - i, 0.0, 1.0)[..., None]
        recon = pyramid[i] + alpha * (recon - pyramid[i])
    return recon
