"""Colour-space conversion (port of `blindshadowremoval_tpu/ops/image.py`)."""

from __future__ import annotations

import torch

# ITU-R BT.601 luma weights used by tf.image.rgb_to_grayscale.
_GRAY_W = (0.2989, 0.5870, 0.1140)


def rgb_to_grayscale(x: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 1] luma, computed in x's dtype."""
    w = torch.tensor(_GRAY_W, dtype=x.dtype, device=x.device)
    return (x * w).sum(dim=-1, keepdim=True)
