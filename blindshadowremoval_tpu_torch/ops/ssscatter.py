"""Subsurface-scattering shadow softening, NVIDIA's skin model (port of
`blindshadowremoval_tpu/ops/ssscatter.py`, reference utils.py:667-726):
a six-level sum of Gaussian blurs with wavelength-dependent RGB weights
turns a hard binary shadow into a red-bleeding soft skin shadow."""

from __future__ import annotations

import numpy as np
import torch

from blindshadowremoval_tpu_torch.ops.filters import gaussian_blur

_MAX_SS_SIGMA = 15.0     # utils.py:16

# (sigma multiplier, r weight, g weight, b weight) per level (utils.py:695-700)
_SS_WEIGHTS = np.array(
    [[0.042, 0.220, 0.437, 0.635],
     [0.220, 0.101, 0.355, 0.365],
     [0.433, 0.119, 0.208, 0.000],
     [0.753, 0.114, 0.000, 0.000],
     [1.412, 0.364, 0.000, 0.000],
     [2.722, 0.080, 0.000, 0.000]], np.float32)

# static kernel radius of each level: 3 sigma of its largest sigma
# (ssscatter.py:46-54), capped at 96
_LEVEL_RADII = tuple(
    min(96, max(2, int(3.0 * m * _MAX_SS_SIGMA) + 1))
    for m in (0.042, 0.220, 0.433, 0.753, 1.412, 2.722))


def wavelength_filter(img: torch.Tensor, scale: torch.Tensor,
                      rgain: torch.Tensor) -> torch.Tensor:
    """Grayscale [B, H, W, 1] -> wavelength-blurred [B, H, W, 3]: level lv
    blurs with sigma = weight * scale [B], and its red channel carries the
    gain rgain[:, lv] (drawn in [1.1, 1.5])."""
    b = img.shape[0]
    out = torch.zeros(img.shape[:3] + (3,), device=img.device)
    scale = scale.to(torch.float32)
    for lv, radius in enumerate(_LEVEL_RADII):
        w = _SS_WEIGHTS[lv]
        blur = gaussian_blur(img, float(w[0]) * scale, max_radius=radius)
        gain = rgain[:, lv].to(torch.float32).reshape(b, 1, 1, 1)
        level = torch.cat([blur * float(w[1]) * gain, blur * float(w[2]),
                           blur * float(w[3])], dim=-1)
        out = out + level
    return out


def apply_ss_shadow_map(draws: dict, mask: torch.Tensor) -> torch.Tensor:
    """Shadow mask [B, H, W, 1] -> subsurface-scattered lit map [B, H, W, 3]
    (ssscatter.py:65-75): a global blur scale in [1, 15), then /0.6 clamped
    at 1.  draws: "scale" [B], "rgain" [B, 6]."""
    sm = wavelength_filter(mask, draws["scale"], draws["rgain"])
    return torch.clamp(sm / 0.6, max=1.0)


def draw_ss(gen: torch.Generator, b: int, device) -> dict:
    scale = 1.0 + (_MAX_SS_SIGMA - 1.0) * torch.rand(
        (b,), generator=gen, device=device)
    rgain = 1.1 + 0.4 * torch.rand((b, len(_LEVEL_RADII)), generator=gen,
                                   device=device)
    return {"scale": scale, "rgain": rgain}
