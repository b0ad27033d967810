"""Perlin noise and the Perlin-based shadow and brightness masks (port of
`blindshadowremoval_tpu/ops/perlin.py`).

Each function is split in two: a deterministic core that takes its random
draws (gradient angles, persistence, blur radii, branch gates) as tensors,
batched over samples, and a `draw_*` function that makes those draws from
an explicit `torch.Generator`.  Tests feed the core the JAX package's own
draws; training feeds it the generator's.
"""

from __future__ import annotations

import math

import torch

from blindshadowremoval_tpu_torch.ops.filters import disc_blur
from blindshadowremoval_tpu_torch.ops.image import resize_nearest

_SQRT2 = math.sqrt(2.0)


def _linspace(stop: float, num: int, device) -> torch.Tensor:
    """jnp.linspace(0, stop, num) as XLA computes it in float32:
    stop * (i * f32(1 / (num - 1))) (the divide by a constant becomes a
    multiply by its reciprocal), and the endpoint exact."""
    inv = torch.tensor(1.0, dtype=torch.float32) / (num - 1)
    step = torch.arange(num - 1, dtype=torch.float32, device=device) * inv.to(device)
    return torch.cat([stop * step,
                      torch.full((1,), float(stop), device=device)])


def _fade(t: torch.Tensor) -> torch.Tensor:
    """6t^5 - 15t^4 + 10t^3, the powers by repeated squaring as XLA's
    integer_pow computes them."""
    t2 = t * t
    t4 = t2 * t2
    return 6.0 * (t * t4) - 15.0 * t4 + 10.0 * (t * t2)


def perlin(angles: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """One octave of Perlin noise from gradient `angles` [B, ry+1, rx+1]
    (radians) -> [B, H, W] float32 (perlin.py:22-53)."""
    h, w = size
    ry, rx = angles.shape[1] - 1, angles.shape[2] - 1
    dev = angles.device
    gy = torch.remainder(_linspace(ry, h, dev), 1.0)[:, None].expand(h, w)
    gx = torch.remainder(_linspace(rx, w, dev), 1.0)[None, :].expand(h, w)
    fade_y, fade_x = _fade(gy), _fade(gx)
    grads = torch.stack([torch.cos(angles), torch.sin(angles)], dim=3)
    g00 = resize_nearest(grads[:, :-1, :-1], (h, w))
    g10 = resize_nearest(grads[:, 1:, :-1], (h, w))
    g01 = resize_nearest(grads[:, :-1, 1:], (h, w))
    g11 = resize_nearest(grads[:, 1:, 1:], (h, w))
    d00 = g00[..., 0] * gy + g00[..., 1] * gx
    d10 = g10[..., 0] * (gy - 1.0) + g10[..., 1] * gx
    d01 = g01[..., 0] * gy + g01[..., 1] * (gx - 1.0)
    d11 = g11[..., 0] * (gy - 1.0) + g11[..., 1] * (gx - 1.0)
    top = d00 * (1.0 - fade_y) + d10 * fade_y
    bot = d01 * (1.0 - fade_y) + d11 * fade_y
    return _SQRT2 * (top * (1.0 - fade_x) + bot * fade_x)


def perlin_collection(angles: list[torch.Tensor], size: tuple[int, int],
                      persistence: torch.Tensor) -> torch.Tensor:
    """Multi-octave Perlin (perlin.py:56-70): octave i takes angles[i] (its
    resolution doubles each octave) at amplitude persistence^i.
    persistence [B] -> [B, H, W]."""
    b = angles[0].shape[0]
    dev = angles[0].device
    noise = torch.zeros((b,) + tuple(size), device=dev)
    amplitude = torch.ones(b, 1, 1, device=dev)
    pers = persistence.to(torch.float32).reshape(b, 1, 1)
    for a in angles:
        noise = noise + amplitude * perlin(a, size)
        amplitude = amplitude * pers
    return noise


def _uniform(gen: torch.Generator, shape, lo: float, hi: float,
             device) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)


def _angles(gen: torch.Generator, b: int, reso: int, octaves: int,
            device) -> list[torch.Tensor]:
    return [2.0 * math.pi * torch.rand((b, reso * 2 ** i + 1, reso * 2 ** i + 1),
                                       generator=gen, device=device)
            for i in range(octaves)]


# ---------------------------------------------------------- brightness
def brightness_mask(draws: dict, size: tuple[int, int]) -> torch.Tensor:
    """Per-pixel intensity in [min_val, 1] (perlin.py:73-81) -> [B, H, W].
    draws: "min_val" [B], "pers" [B], "angles" (2 octaves from 2x2)."""
    pm = perlin_collection(draws["angles"], size, draws["pers"])
    min_val = draws["min_val"].to(torch.float32).reshape(-1, 1, 1)
    pm = pm / (1.0 / (min_val + 1e-6)) + min_val
    return torch.clamp(pm, max=1.0)


def draw_brightness(gen: torch.Generator, min_val: torch.Tensor,
                    device) -> dict:
    b = min_val.shape[0]
    return {"min_val": min_val.to(device=device, dtype=torch.float32),
            "pers": _uniform(gen, (b,), 0.05, 0.25, device),
            "angles": _angles(gen, b, 2, 2, device)}


# ------------------------------------------------------- shadow masks
def render_perlin_mask(draws: dict, size: tuple[int, int]) -> torch.Tensor:
    """Perlin shadow mask with random softening -> [B, H, W, 1] in [0, 1]
    (perlin.py:84-109): multi-octave Perlin thresholded at 0.15, softened
    by the spatially varying pyramid blur where "use_sv", else by a disc
    blur of radius "disc_r", then divided by its max.  Each sample runs
    only its own branch."""
    from blindshadowremoval_tpu_torch.ops.svblur import spatially_varying_blur

    pm = perlin_collection(draws["angles"], size, draws["pers"])
    mask = (pm > 0.15).float()[..., None]
    use_sv = draws["use_sv"]
    out = torch.empty_like(mask)
    sv = use_sv.nonzero().flatten()
    disc = (~use_sv).nonzero().flatten()
    if sv.numel():
        out[sv] = spatially_varying_blur(
            {k: _take(v, sv) for k, v in draws["sv"].items()}, mask[sv],
            draws["sv_size"][sv])
    if disc.numel():
        out[disc] = disc_blur(mask[disc], draws["disc_r"][disc])
    peak = out.amax(dim=(1, 2, 3), keepdim=True)
    return out / (peak + 1e-12)


def draw_perlin_mask(gen: torch.Generator, b: int, device) -> dict:
    return {
        "pers": _uniform(gen, (b,), 0.05, 0.85, device),
        "angles": _angles(gen, b, 4, 4, device),
        "disc_r": torch.randint(1, 12, (b,), generator=gen, device=device),
        "sv_size": torch.randint(1, 3, (b,), generator=gen, device=device),
        "use_sv": torch.rand((b,), generator=gen, device=device) > 0.5,
        "sv": {"pers": _uniform(gen, (b,), 0.05, 0.25, device),
               "angles": _angles(gen, b, 2, 1, device)},
    }


def _take(v, idx: torch.Tensor):
    """Rows `idx` of a draw: a tensor, or each tensor of a list or dict."""
    if isinstance(v, list):
        return [_take(t, idx) for t in v]
    if isinstance(v, dict):
        return {k: _take(t, idx) for k, t in v.items()}
    return v[idx]
