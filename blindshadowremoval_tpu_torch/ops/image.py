"""Colour spaces, gradients, resampling and the PSNR / SSIM metrics of
[..., H, W, C] images (port of `blindshadowremoval_tpu/ops/image.py`)."""

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


@functools.lru_cache(maxsize=64)
def _constant(name: str, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    """`_GRAY_W` or `_YUV` as a tensor on `device`, made once:
    a host-to-device copy of a fresh host tensor waits on the stream, so a
    forward that made its constants each call would hold the host until
    the card caught up.  Made outside inference mode, so that autograd may
    save it."""
    with torch.inference_mode(False):
        value = _GRAY_W if name == "gray" else _YUV
        return torch.tensor(value, dtype=dtype, device=device)


def rgb_to_grayscale(x: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 1] luma, computed in x's dtype."""
    return (x * _constant("gray", x.dtype, x.device)).sum(dim=-1, keepdim=True)


def rgb_to_yuv(x: torch.Tensor) -> torch.Tensor:
    """[..., 3] RGB -> YUV with the reference's inline matrix."""
    return torch.matmul(x, _constant("yuv", x.dtype, x.device).t())


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


def psnr(a: torch.Tensor, b: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """tf.image.psnr over [..., H, W, C] -> [...] (dB).  Each image's mean
    accumulates in f64 and rounds once, so its value does not depend on
    the batch it is computed in (a k-image UCB step split over a mesh gives
    the one-device values)."""
    sq = (a - b) ** 2
    mse = sq.double().mean(dim=(-3, -2, -1)).to(sq.dtype)
    return 10.0 * torch.log10(max_val ** 2 / mse.clamp_min(1e-12))


def _ssim_kernel(size: int = 11, sigma: float = 1.5,
                 device: torch.device | str = "cpu") -> torch.Tensor:
    """The normalized 1-D Gaussian of tf.image.ssim, in f32."""
    n = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    k = torch.exp(-0.5 * (n / sigma) ** 2)
    return k / k.sum()


def _filter2d_valid(x: torch.Tensor, k1d: torch.Tensor) -> torch.Tensor:
    """Separable VALID filter of [B, H, W, C] with a 1-D kernel on both
    axes, as f32 shifted sums on the vector units.

    SSIM's variance E[x^2] - E[x]^2 cancels catastrophically, so the filter
    must run in true f32 (the JAX package asks XLA for Precision.HIGHEST).
    A cuDNN convolution would run in TF32 wherever the process allows it
    (PyTorch's default for cuDNN), whatever this function asks; sums of
    shifted slices never touch a tensor core."""
    n = k1d.shape[0]
    h = x.shape[1] - n + 1
    y = k1d[0] * x[:, 0:h]
    for i in range(1, n):
        y = y + k1d[i] * x[:, i:i + h]
    w = x.shape[2] - n + 1
    out = k1d[0] * y[:, :, 0:w]
    for i in range(1, n):
        out = out + k1d[i] * y[:, :, i:i + w]
    return out


def ssim(a: torch.Tensor, b: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """tf.image.ssim defaults: 11x11 Gaussian sigma=1.5, k1=.01, k2=.03.
    a, b: [..., H, W, C] -> [...] mean SSIM, computed in f32 (each image's
    mean accumulated in f64, as `psnr`'s)."""
    a = a.float()
    b = b.float()
    lead = a.shape[:-3]
    ab = a.reshape((-1,) + a.shape[-3:])
    bb = b.reshape((-1,) + b.shape[-3:])
    k = _ssim_kernel(device=a.device)
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2

    mu_a = _filter2d_valid(ab, k)
    mu_b = _filter2d_valid(bb, k)
    aa = _filter2d_valid(ab * ab, k)
    bbm = _filter2d_valid(bb * bb, k)
    abm = _filter2d_valid(ab * bb, k)

    # exact variances are >= 0; clamp the cancellation residue so the cs
    # denominator can never cross zero
    va = (aa - mu_a * mu_a).clamp_min(0.0)
    vb = (bbm - mu_b * mu_b).clamp_min(0.0)
    cov = abm - mu_a * mu_b

    lum = (2 * mu_a * mu_b + c1) / (mu_a ** 2 + mu_b ** 2 + c1)
    cs = (2 * cov + c2) / (va + vb + c2)
    return (lum * cs).double().mean(dim=(1, 2, 3)).float().reshape(lead)
