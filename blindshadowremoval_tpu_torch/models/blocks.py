"""Building blocks of the GSC generator and its discriminators (port of
`blindshadowremoval_tpu/models/blocks.py`).

NCHW inside, TF semantics kept from the reference's Keras layers:

  * LeakyReLU slope 0.3 (Keras default);
  * BatchNorm eps 1e-3, Keras momentum 0.99 (see `BatchNorm`);
  * "SAME" padding as TF computes it: for a stride-2 3x3 conv on an even
    size that is ONE row/column after the data, none before (symmetric
    `padding=1` is wrong by ~6 on random weights);
  * ConvTranspose "SAME": the stride-2 transposed conv cropped to the first
    2H x 2W outputs (`output_padding=1` is wrong by ~3);
  * channel-pad residuals at the END of the channel axis;
  * NonLocal attention over the NHWC row-major position order, with no
    1/sqrt(D) scale.

Mixed precision as Flax's `dtype`/`param_dtype`: parameters stay in the
dtype they were made in (f32 for training), and each convolution runs in
the dtype of its input activation, its weights cast to it per call; the
model casts its input to the compute dtype once.

Each block owns its convolutions and BatchNorms, named so that
`models/folding.py` pairs them structurally (`BN_PAIRS`).  A block built
with `fold_bn=True` has `nn.Identity` in place of its BatchNorms.  Spectral
norm, dropout, int8 and space-to-depth convs are not ported (ROADMAP F4).
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from blindshadowremoval_tpu_torch.ops.nonlocal_attn import nonlocal_attention

LEAKY_SLOPE = 0.3
BN_EPS = 1e-3
BN_MOMENTUM = 0.99   # Keras/Flax: running = m * running + (1 - m) * batch


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm with Flax's semantics (`flax.linen.BatchNorm`, momentum
    0.99, eps 1e-3), under nn.BatchNorm2d's parameter and buffer names.

    Statistics and the affine are f32, and the normalization runs in f32;
    the output takes the input's dtype.  In training mode it normalizes by
    the batch statistics and moves the running statistics by
    running = 0.99 * running + 0.01 * batch, with the BIASED batch variance
    (nn.BatchNorm2d moves them with the unbiased one, n / (n - 1) larger).
    `update_stats = False` (see `frozen_stats`) keeps the batch statistics
    but leaves the running ones alone."""

    def __init__(self, ch: int):
        super().__init__(ch, eps=BN_EPS, momentum=1.0 - BN_MOMENTUM)
        self.update_stats = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if not self.training:
            y = F.batch_norm(xf, self.running_mean, self.running_var,
                             self.weight, self.bias, training=False,
                             eps=self.eps)
            return y.to(x.dtype)
        # Flax's batch statistics: the mean and the mean of squares in one
        # pass, var = max(0, E[x^2] - E[x]^2)
        mean = xf.mean(dim=(0, 2, 3))
        var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean,
                          min=0.0)
        if self.update_stats:
            with torch.no_grad():
                self.running_mean.mul_(BN_MOMENTUM).add_(
                    mean, alpha=1.0 - BN_MOMENTUM)
                self.running_var.mul_(BN_MOMENTUM).add_(
                    var, alpha=1.0 - BN_MOMENTUM)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]
        return y.to(x.dtype)


@contextlib.contextmanager
def frozen_stats(module: nn.Module):
    """Within the block, the BatchNorms of `module` use batch statistics in
    training mode but do not move their running statistics."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
    before = [bn.update_stats for bn in bns]
    for bn in bns:
        bn.update_stats = False
    try:
        yield
    finally:
        for bn, flag in zip(bns, before):
            bn.update_stats = flag


def _bn(ch: int, fold_bn: bool) -> nn.Module:
    return nn.Identity() if fold_bn else BatchNorm(ch)


def conv(x: torch.Tensor, mod: nn.Module, padding=0) -> torch.Tensor:
    """`mod` (a Conv2d or ConvTranspose2d) applied in x's dtype."""
    w = mod.weight.to(x.dtype)
    b = None if mod.bias is None else mod.bias.to(x.dtype)
    if isinstance(mod, nn.ConvTranspose2d):
        return F.conv_transpose2d(x, w, b, mod.stride)
    return F.conv2d(x, w, b, mod.stride, padding)


def _same_pad(size: int, k: int, stride: int) -> tuple[int, int]:
    """TF "SAME" (before, after) padding of one spatial axis."""
    total = max((math.ceil(size / stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d_same(x: torch.Tensor, mod: nn.Conv2d) -> torch.Tensor:
    """`mod` applied with TF "SAME" padding, in x's dtype."""
    k, s = mod.kernel_size[0], mod.stride[0]
    top, bottom = _same_pad(x.shape[-2], k, s)
    left, right = _same_pad(x.shape[-1], k, s)
    if top == bottom and left == right:
        return conv(x, mod, (top, left))
    return conv(F.pad(x, (left, right, top, bottom)), mod)


class ConvBlock(nn.Module):
    """Conv + optional BatchNorm + optional LeakyReLU (model.py:115-147)."""

    BN_PAIRS = (("conv", "bn"),)

    def __init__(self, in_ch: int, features: int, ksize: int = 3,
                 stride: int = 1, norm: bool = True, act: bool = True,
                 fold_bn: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, features, ksize, stride)
        self.bn = _bn(features, fold_bn) if norm else nn.Identity()
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(conv2d_same(x, self.conv))
        return F.leaky_relu(x, LEAKY_SLOPE) if self.act else x


class ConvTBlock(nn.Module):
    """3x3 stride-2 transposed conv + BatchNorm + LeakyReLU
    (model.py:149-177), TF "SAME": the output is exactly (2H, 2W)."""

    BN_PAIRS = (("conv", "bn"),)

    def __init__(self, in_ch: int, features: int, fold_bn: bool = False):
        super().__init__()
        self.conv = nn.ConvTranspose2d(in_ch, features, 3, 2)
        self.bn = _bn(features, fold_bn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2:]
        y = conv(x, self.conv)[..., :2 * h, :2 * w]
        return F.leaky_relu(self.bn(y), LEAKY_SLOPE)


class NonLocalBlock(nn.Module):
    """Embedded-Gaussian non-local self-attention (model.py:6-61): theta,
    phi and g are 1x1 convs to ch/2, the attention runs over all spatial
    positions, and the output 1x1 conv + BatchNorm (back to ch) is added
    residually."""

    BN_PAIRS = (("w", "bn"),)

    def __init__(self, ch: int, fold_bn: bool = False):
        super().__init__()
        half = ch // 2
        self.g = nn.Conv2d(ch, half, 1)
        self.phi = nn.Conv2d(ch, half, 1)
        self.theta = nn.Conv2d(ch, half, 1)
        self.w = nn.Conv2d(half, ch, 1)
        self.bn = _bn(ch, fold_bn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape

        def positions(mod):   # [B, C, H, W] -> [B, H*W, C], NHWC order
            y = conv(x, mod)
            return y.permute(0, 2, 3, 1).reshape(b, h * w, -1).contiguous()

        y = nonlocal_attention(positions(self.theta), positions(self.phi),
                               positions(self.g))
        y = y.reshape(b, h, w, -1).permute(0, 3, 1, 2)
        return x + self.bn(conv(y, self.w))


def _pad_channels_to_match(x: torch.Tensor, y: torch.Tensor):
    """Zero-pad the narrower of x/y at the end of the channel axis (dim 1)
    (model.py:105-112)."""
    cx, cy = x.shape[1], y.shape[1]
    if cx < cy:
        x = F.pad(x, (0, 0, 0, 0, 0, cy - cx))
    elif cy < cx:
        y = F.pad(y, (0, 0, 0, 0, 0, cx - cy))
    return x, y


class ResBottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck + NonLocal + channel-pad residual
    (model.py:81-113), at stride 1, the only stride the generators use."""

    BN_PAIRS = (("conv1", "bn1"), ("conv2", "bn2"), ("conv3", "bn3"))

    def __init__(self, in_ch: int, ch: int, fold_bn: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, ch // 2, 1)
        self.bn1 = _bn(ch // 2, fold_bn)
        self.conv2 = nn.Conv2d(ch // 2, ch // 2, 3)   # "SAME": padding 1
        self.bn2 = _bn(ch // 2, fold_bn)
        self.conv3 = nn.Conv2d(ch // 2, ch, 1)
        self.bn3 = _bn(ch, fold_bn)
        self.non_local = NonLocalBlock(ch, fold_bn=fold_bn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.leaky_relu(self.bn1(conv(x, self.conv1)), LEAKY_SLOPE)
        y = F.leaky_relu(self.bn2(conv(y, self.conv2, 1)), LEAKY_SLOPE)
        y = self.non_local(self.bn3(conv(y, self.conv3)))
        x, y = _pad_channels_to_match(x, y)
        return F.leaky_relu(x + y, LEAKY_SLOPE)
