"""Building blocks of the GSC generator (port of
`blindshadowremoval_tpu/models/blocks.py`).

NCHW inside, TF semantics kept from the reference's Keras layers:

  * LeakyReLU slope 0.3 (Keras default);
  * BatchNorm eps 1e-3, Keras momentum 0.99 (torch `momentum=0.01`);
  * "SAME" padding as TF computes it: for a stride-2 3x3 conv on an even
    size that is ONE row/column after the data, none before (symmetric
    `padding=1` is wrong by ~6 on random weights);
  * ConvTranspose "SAME": the stride-2 transposed conv cropped to the first
    2H x 2W outputs (`output_padding=1` is wrong by ~3);
  * channel-pad residuals at the END of the channel axis;
  * NonLocal attention over the NHWC row-major position order, with no
    1/sqrt(D) scale.

Each block owns its convolutions and BatchNorms, named so that
`models/folding.py` pairs them structurally (`BN_PAIRS`).  A block built
with `fold_bn=True` has `nn.Identity` in place of its BatchNorms.  Spectral
norm, dropout, int8 and space-to-depth convs are not ported (ROADMAP C2,
F4).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from blindshadowremoval_tpu_torch.ops.nonlocal_attn import nonlocal_attention

LEAKY_SLOPE = 0.3
BN_EPS = 1e-3
BN_MOMENTUM = 0.01   # torch convention for Keras' 0.99


def _bn(ch: int, fold_bn: bool) -> nn.Module:
    if fold_bn:
        return nn.Identity()
    return nn.BatchNorm2d(ch, eps=BN_EPS, momentum=BN_MOMENTUM)


def _same_pad(size: int, k: int, stride: int) -> tuple[int, int]:
    """TF "SAME" (before, after) padding of one spatial axis."""
    total = max((math.ceil(size / stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d_same(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """`conv` applied with TF "SAME" padding."""
    k, s = conv.kernel_size[0], conv.stride[0]
    top, bottom = _same_pad(x.shape[-2], k, s)
    left, right = _same_pad(x.shape[-1], k, s)
    if top == bottom and left == right:
        return F.conv2d(x, conv.weight, conv.bias, s, (top, left))
    return F.conv2d(F.pad(x, (left, right, top, bottom)), conv.weight,
                    conv.bias, s)


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
        y = self.conv(x)[..., :2 * h, :2 * w]
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

        def positions(conv):   # [B, C, H, W] -> [B, H*W, C], NHWC order
            y = conv(x)
            return y.permute(0, 2, 3, 1).reshape(b, h * w, -1).contiguous()

        y = nonlocal_attention(positions(self.theta), positions(self.phi),
                               positions(self.g))
        y = y.reshape(b, h, w, -1).permute(0, 3, 1, 2)
        return x + self.bn(self.w(y))


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
        self.conv2 = nn.Conv2d(ch // 2, ch // 2, 3, padding=1)
        self.bn2 = _bn(ch // 2, fold_bn)
        self.conv3 = nn.Conv2d(ch // 2, ch, 1)
        self.bn3 = _bn(ch, fold_bn)
        self.non_local = NonLocalBlock(ch, fold_bn=fold_bn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.leaky_relu(self.bn1(self.conv1(x)), LEAKY_SLOPE)
        y = F.leaky_relu(self.bn2(self.conv2(y)), LEAKY_SLOPE)
        y = self.non_local(self.bn3(self.conv3(y)))
        x, y = _pad_channels_to_match(x, y)
        return F.leaky_relu(x + y, LEAKY_SLOPE)
