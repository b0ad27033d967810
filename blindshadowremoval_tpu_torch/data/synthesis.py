"""In-step shadow compositing of the train step (port of
`blindshadowremoval_tpu/data/synthesis.py:compose_shadow_image`, the
reference's `process_mask`, train_test_GSC.py:81-105).

Per sample: keep the external shadow mask (60%) or draw a face-gated Perlin
mask; soften it by subsurface scattering (75%) or plain inversion; draw a
brightness field with floor 0.3 or 0.5 (50/50); composite
img = gt * mask_ss + img_dark * mask_sv * intensity.  The JAX package
computes one `lax.cond` branch per vmapped sample; here each branch runs
once, batched over the samples that chose it.

Not ported yet (ROADMAP C1): `derive_darkened_views` (needs the tone curve,
`ops/tonecurve.py`), and the host-side `ShadowMaker` and
`shadow_synthesis_host` (need cv2).
"""

from __future__ import annotations

import torch

from blindshadowremoval_tpu_torch.ops.perlin import (
    _take,
    brightness_mask,
    draw_brightness,
    draw_perlin_mask,
    render_perlin_mask,
)
from blindshadowremoval_tpu_torch.ops.ssscatter import apply_ss_shadow_map, draw_ss


def draw_compose(gen: torch.Generator, b: int, device) -> dict:
    """Every random draw of `compose_from_draws` for a batch of b samples."""
    keep = torch.rand((b,), generator=gen, device=device) > 0.4
    use_ss = torch.rand((b,), generator=gen, device=device) > 0.25
    low_floor = torch.rand((b,), generator=gen, device=device) > 0.5
    min_val = torch.where(low_floor, 0.3, 0.5).to(torch.float32)
    return {"keep_ext": keep, "perlin": draw_perlin_mask(gen, b, device),
            "use_ss": use_ss, "ss": draw_ss(gen, b, device),
            "brightness": draw_brightness(gen, min_val, device)}


def compose_from_draws(draws: dict, mask: torch.Tensor, gt: torch.Tensor,
                       img_dark: torch.Tensor, face: torch.Tensor):
    """The deterministic compositor.  mask/face [B,S,S,1], gt/img_dark
    [B,S,S,3].  Returns (img, mask_sv, mask_edge), each [B,S,S,3]."""
    s = gt.shape[1]
    mask = mask.clone()
    fresh = (~draws["keep_ext"]).nonzero().flatten()
    if fresh.numel():
        mask[fresh] = face[fresh] * render_perlin_mask(
            _take(draws["perlin"], fresh), (s, s))
    inv = 1.0 - mask
    mask_ss = inv.expand(-1, -1, -1, 3).clone()
    ss = draws["use_ss"].nonzero().flatten()
    if ss.numel():
        mask_ss[ss] = apply_ss_shadow_map(_take(draws["ss"], ss), inv[ss])
    mask_sv = 1.0 - mask_ss
    intensity = brightness_mask(draws["brightness"], (s, s))[..., None]
    img = gt * mask_ss + img_dark * mask_sv * intensity
    img = torch.clamp(img, 0.0, 1.0)
    mask_edge = (mask_sv - mask).abs()
    return img, mask_sv, mask_edge


def compose_shadow_image(gen: torch.Generator, mask: torch.Tensor,
                         gt: torch.Tensor, img_dark: torch.Tensor,
                         face: torch.Tensor):
    """Batched compositor with its draws taken from `gen` (on the inputs'
    device).  Returns (img, mask_sv, mask_edge), each [B,S,S,3]."""
    draws = draw_compose(gen, gt.shape[0], gt.device)
    return compose_from_draws(draws, mask, gt, img_dark, face)
