"""Tone-curve jitter and least-squares colour-transfer matrices (port of
`blindshadowremoval_tpu/ops/tonecurve.py`, the reference's
`apply_tone_curve` and `get_ctm_ls`/`apply_ctm`, utils.py:438-527).

Split like the rest of the port's random augmentation: `draw_face_darken`
makes the random draws (two gain triples an image) from an explicit
`torch.Generator`, and `face_darken_from_draws` is the deterministic
function, batched over a leading image axis.  Tests feed it the gains of
the JAX package's keys.

Precision: the 3x3 normal equations sum over every pixel of a crop (65,536
at 256 px).  A TF32 product there (cuBLAS under PyTorch's
`allow_tf32` setting) makes the solve singular, so they are formed and
solved in f64, which no TF32 setting reaches, and the colour transform is
applied as three f32 multiply-adds, not a matrix product.
"""

from __future__ import annotations

import torch


def getbias(x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Schlick's bias (utils.py:438-440)."""
    return x / ((1.0 / bias - 2.0) * (1.0 - x) + 1.0 + 1e-6)


def apply_tone_curve(image: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
    """Per-channel Schlick tone jitter of [n, H, W, 3] images with gains
    [n, 3]; each image is normalized by its own max and rescaled after."""
    image_max = image.amax(dim=(1, 2, 3), keepdim=True)
    x = image / (image_max + 1e-6)
    up = x > 0.499
    g = gain.to(x.dtype)[:, None, None, :]
    lo = getbias(x * 2.0, g) / 2.0
    hi = getbias(x * 2.0 - 1.0, 1.0 - g) / 2.0 + 0.5
    # a true select, never the blend lo*(1-up)+hi*up: the unselected
    # branch is evaluated outside its domain, where getbias's denominator
    # crosses zero, and its inf * 0 would poison a blend with NaN
    return torch.where(up, hi, lo) * image_max


def get_ctm_ls(image: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """[n, 3, 3] matrices C^T minimizing |image @ C^T - target| per image
    (utils.py:497-512), by the normal equations in f64 with a ridge of 1e-6
    of the mean diagonal: a fixed ridge leaves A^T A singular for a
    near-constant crop (rank 1), where the reference's lstsq still gives a
    finite answer."""
    n = image.shape[0]
    a = image.reshape(n, -1, 3).double()
    b = target.reshape(n, -1, 3).double()
    ata = a.transpose(1, 2) @ a
    atb = a.transpose(1, 2) @ b
    eps = 1e-6 * ata.diagonal(dim1=1, dim2=2).sum(-1) / 3.0 + 1e-12
    eye = torch.eye(3, dtype=ata.dtype, device=ata.device)
    ctm = torch.linalg.solve(ata + eps[:, None, None] * eye, atb)
    return ctm.transpose(1, 2).to(image.dtype)


def apply_ctm(image: torch.Tensor, ctm: torch.Tensor) -> torch.Tensor:
    """out[..., k] = sum_c image[..., c] ctm[k, c] for [n, H, W, 3] images
    and [n, 3, 3] matrices, as f32 multiply-adds."""
    c = ctm[:, None, None]                       # [n, 1, 1, 3, 3]
    return (image[..., None, :] * c).sum(-1)


def draw_face_darken(gen: torch.Generator, n: int, device,
                     tone_sigma: float = 0.3):
    """The draws of `face_darken_from_draws` for n images: two gain
    triples each, uniform in 0.5 +- tone_sigma."""
    def gains():
        return 0.5 + tone_sigma * (
            2.0 * torch.rand((n, 3), generator=gen, device=device) - 1.0)

    g1 = gains()
    return g1, gains()


def face_darken_from_draws(img: torch.Tensor, g1: torch.Tensor,
                           g2: torch.Tensor):
    """Colour jitter and darkened twin of [n, H, W, 3] images
    (utils.py:1029-1047).  Returns (img_aug, img_dark, ctm [n, 3, 3]): each
    output is the least-squares colour transform of a tone-curve jitter of
    the input, so img_dark differs from img_aug by a global 3x3 transform,
    the invariant the GSC model learns to invert."""
    img = img.float()
    c1 = get_ctm_ls(img, apply_tone_curve(img, g1))
    c2 = get_ctm_ls(img, apply_tone_curve(img, g2))
    return apply_ctm(img, c1), apply_ctm(img, c2), c2
