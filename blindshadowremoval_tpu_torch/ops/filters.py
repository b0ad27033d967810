"""Blur and morphology filters of [B, H, W, C] images (port of
`blindshadowremoval_tpu/ops/filters.py`).

Every filter takes its runtime parameter (sigma, radius) per sample, so a
batch whose samples drew different values runs as one grouped convolution
or one batched FFT rather than a loop over samples.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _reflect_index(n: int, pad: int, device) -> torch.Tensor:
    """Source indices of an axis of length n reflect-padded by `pad` on both
    sides, numpy's "reflect" (edge not repeated), also for pad >= n: the
    reflection is periodic with period 2(n - 1)."""
    i = torch.arange(-pad, n + pad, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    j = torch.remainder(i, period)
    return torch.where(j >= n, period - j, j)


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect-pad the H and W axes of [B, H, W, C] by `pad`."""
    h, w = x.shape[1:3]
    x = x.index_select(1, _reflect_index(h, pad, x.device))
    return x.index_select(2, _reflect_index(w, pad, x.device))


def _depthwise_separable(x: torch.Tensor, k1d: torch.Tensor,
                         pad: int) -> torch.Tensor:
    """Separable depthwise filter of [B, H, W, C], reflect-padded, rows
    then columns, with one 1-D kernel per sample (k1d [B, K]) or one for
    all ([K])."""
    b, _, _, c = x.shape
    xp = reflect_pad(x, pad)
    k1d = k1d.to(x.dtype)
    if k1d.dim() == 1:
        k1d = k1d.expand(b, -1)
    kern = k1d.repeat_interleave(c, dim=0)                # [B*C, K]
    hp, wp = xp.shape[1:3]
    y = xp.permute(0, 3, 1, 2).reshape(1, b * c, hp, wp)
    y = F.conv2d(y, kern[:, None, :, None], groups=b * c)
    y = F.conv2d(y, kern[:, None, None, :], groups=b * c)
    return y.reshape(b, c, y.shape[-2], y.shape[-1]).permute(0, 2, 3, 1)


def gaussian_kernel(sigma: torch.Tensor, max_radius: int) -> torch.Tensor:
    """[B, 2*max_radius+1] kernels: support [-ceil(2 sigma), ceil(2 sigma)]
    within the static extent, renormalized (filters.py:52-57)."""
    sigma = torch.clamp(sigma.to(torch.float32), min=1e-6).reshape(-1, 1)
    r = torch.ceil(2.0 * sigma)
    n = torch.arange(-max_radius, max_radius + 1, dtype=torch.float32,
                     device=sigma.device)
    t = n / sigma
    k = torch.exp(-0.5 * (t * t))
    k = torch.where(n.abs() <= r, k, torch.zeros_like(k))
    return k / k.sum(dim=1, keepdim=True)


def gaussian_blur(x: torch.Tensor, sigma, max_radius: int = 32) -> torch.Tensor:
    """Gaussian blur of [B, H, W, C] with runtime `sigma` (a scalar or one
    per sample) and a static kernel extent: the reference's dynamic-radius
    kernel whenever ceil(2 sigma) <= max_radius (utils.py:728-759)."""
    sigma = torch.as_tensor(sigma, dtype=torch.float32, device=x.device)
    k = gaussian_kernel(sigma.expand(x.shape[0]), max_radius)
    return _depthwise_separable(x, k, max_radius)


def dilate(x: torch.Tensor, ksize: int = 5) -> torch.Tensor:
    """Grayscale dilation of [B, H, W, C] by a flat ksize x ksize element:
    a sliding max over -inf padding."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), ksize, stride=1,
                     padding=ksize // 2)
    return y.permute(0, 2, 3, 1)


def find_edge(mask: torch.Tensor, reps: int = 2, ksize: int = 5) -> torch.Tensor:
    """Shadow-boundary band of [B, H, W, C] (utils.py:116-125): (mean over
    C > .01) minus (min over C > .3), dilated `reps` times, re-binarized."""
    edge = ((mask.mean(dim=3, keepdim=True) > 0.01).float()
            - (mask.amin(dim=3, keepdim=True) > 0.3).float())
    for _ in range(reps):
        edge = dilate(edge, ksize)
    return (edge > 0.0).float()


def disc_blur(img: torch.Tensor, radius, max_radius: int = 24) -> torch.Tensor:
    """Disc (defocus) blur of [B, H, W, C] with a runtime radius per sample,
    by FFT on a plane padded far enough that nothing wraps
    (filters.py:92-120); the disc's centre sits at (max_radius, max_radius),
    where the result is cropped."""
    b, h, w, c = img.shape
    radius = torch.as_tensor(radius, dtype=torch.float32,
                             device=img.device).expand(b).reshape(b, 1, 1)
    ph, pw = h + 2 * max_radius + 2, w + 2 * max_radius + 2
    yy = (torch.arange(ph, dtype=torch.float32, device=img.device)
          - max_radius)[:, None]
    xx = (torch.arange(pw, dtype=torch.float32, device=img.device)
          - max_radius)[None, :]
    disc = ((yy * yy + xx * xx)[None] <= radius * radius).float()
    disc = disc / disc.sum(dim=(1, 2), keepdim=True)
    imgp = F.pad(img.float().permute(0, 3, 1, 2), (0, pw - w, 0, ph - h))
    fk = torch.fft.fft2(disc)[:, None]
    res = torch.fft.ifft2(torch.fft.fft2(imgp) * fk).abs()
    res = res[:, :, max_radius:max_radius + h, max_radius:max_radius + w]
    return res.permute(0, 2, 3, 1)


def box_blur(x: torch.Tensor, ksize: int) -> torch.Tensor:
    """`cv2.blur(x, (ksize, ksize))` of [B, H, W, C]: the normalized box
    with cv2's anchor at ksize // 2 (output i averages the window
    [i - k//2, i + k - 1 - k//2], so an even box reaches one pixel further
    back than forward) and BORDER_REFLECT_101.  Each axis is a difference
    of running sums in f64, whatever the box size."""
    y = reflect_pad(x, ksize // 2).double()
    for dim, n in ((1, x.shape[1]), (2, x.shape[2])):
        c = torch.cumsum(y, dim=dim)
        c = torch.cat([torch.zeros_like(c.narrow(dim, 0, 1)), c], dim=dim)
        y = (c.narrow(dim, ksize, n) - c.narrow(dim, 0, n)) / ksize
    return y.to(x.dtype)
