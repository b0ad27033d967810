"""Multi-scale PatchGAN discriminators (port of
`blindshadowremoval_tpu/models/discriminator.py`, reference
model.py:292-312 and train_test_GSC.py:121-123).

Each discriminator is a stack of stride-2 4x4 conv + BatchNorm + LeakyReLU
layers and a 4x4 conv to a 1-channel logit map.  The caller stacks real and
fake images on the batch axis, so both halves share the BatchNorm batch
statistics, and the logits are split back into (real, fake).  Inputs are
NHWC; parameters stay f32 and the layers run in `dtype`.
"""

from __future__ import annotations

import torch
from torch import nn

from blindshadowremoval_tpu_torch.geometry.warp import resize_bilinear_nchw
from blindshadowremoval_tpu_torch.models.blocks import ConvBlock

_D_CH = (32, 32, 64, 64, 128, 256)   # model.py:295


class Discriminator(nn.Module):
    """Single-scale discriminator over a real-and-fake stacked batch."""

    def __init__(self, in_ch: int = 6, downsize: int = 1, num_layers: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.downsize = downsize
        self.dtype = dtype
        chans = (in_ch,) + _D_CH[:num_layers]
        # 4x4 stride-2 "SAME" on an even size pads one on each side
        self.convs = nn.ModuleList(
            ConvBlock(chans[i], chans[i + 1], ksize=4, stride=2)
            for i in range(num_layers))
        self.head = ConvBlock(chans[-1], 1, ksize=4, norm=None, act=False)

    def forward(self, x: torch.Tensor):
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        if self.downsize > 1:
            h, w = x.shape[-2:]
            x = resize_bilinear_nchw(x, (h // self.downsize,
                                         w // self.downsize))
        for blk in self.convs:
            x = blk(x)
        x = self.head(x).permute(0, 2, 3, 1).float()
        real, fake = torch.chunk(x, 2, dim=0)
        return real, fake


class MultiScaleDiscriminators(nn.Module):
    """The 1x/2x/4x trio: a list of (real_logits, fake_logits), one pair per
    scale, each [B, h, w, 1] f32."""

    def __init__(self, in_ch: int = 6, num_layers: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.discs = nn.ModuleList(
            Discriminator(in_ch, ds, num_layers, dtype) for ds in (1, 2, 4))

    def forward(self, x: torch.Tensor):
        return [d(x) for d in self.discs]
