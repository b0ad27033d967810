"""RGB-only ablation generator (port of
`blindshadowremoval_tpu/models/generator_rgb.py`, the reference's
model_RGB.py).

The GSC encoder, then only n_res // 2 ResBottlenecks, at 2 * 256 + 1 = 513
channels (so the NonLocal attention runs at D=256), up-convs of doubled
width, and two sequential 7x7 3-channel convs (`conv2`, `conv3`) giving
the output `con` directly: no grayscale branch, no mask, no hole gating.
forward(inputs [B,H,W,3], uv [B,H,W,3], reg=None) -> con [B,H,W,3] in
`egress_dtype`.
"""

from __future__ import annotations

import torch
from torch import nn

from blindshadowremoval_tpu_torch.geometry.warp import resize_bilinear_nchw
from blindshadowremoval_tpu_torch.models.blocks import (
    ConvBlock,
    ConvTBlock,
    ResBottleneck,
)
from blindshadowremoval_tpu_torch.models.generator import (
    N_CH,
    f32_convs,
    nhwc,
    run_res,
)

RGB_RES_CH = 2 * N_CH[5] + 1    # 513


class RGBGenerator(nn.Module):
    """Single-branch direct-RGB deshadowing generator (model_RGB.py)."""

    def __init__(self, n_res: int = 6, fold_bn: bool = False,
                 egress_dtype: torch.dtype = torch.float32,
                 dtype: torch.dtype = torch.float32, remat: bool = False,
                 s2d_convs: bool = False):
        super().__init__()
        self.egress_dtype = egress_dtype
        self.dtype = dtype
        self.remat = remat
        fb = dict(fold_bn=fold_bn)
        # s2d_convs: conv1 and both 7x7 output convs as space-to-depth
        # convs (generator_rgb.py:39,59-61 in the JAX package)
        self.conv1 = ConvBlock(3, N_CH[0], ksize=7, s2d=s2d_convs, **fb)
        self.down1 = ConvBlock(N_CH[0], N_CH[1], stride=2, **fb)
        self.down2 = ConvBlock(N_CH[1], N_CH[2], stride=2, **fb)
        self.down3 = ConvBlock(N_CH[2], N_CH[3], stride=2, **fb)
        ins = [N_CH[3] + 3] + [RGB_RES_CH] * (n_res // 2 - 1)
        self.res = nn.ModuleList(ResBottleneck(c, RGB_RES_CH, **fb)
                                 for c in ins)
        self.up1 = ConvTBlock(RGB_RES_CH, 2 * N_CH[3], **fb)
        self.up2 = ConvTBlock(2 * N_CH[3] + N_CH[2], 2 * N_CH[2], **fb)
        self.up3 = ConvTBlock(2 * N_CH[2] + N_CH[1], 2 * N_CH[1], **fb)
        self.conv2 = ConvBlock(2 * N_CH[1], 3, ksize=7, norm=None, act=False,
                               s2d=s2d_convs)
        self.conv3 = ConvBlock(3, 3, ksize=7, norm=None, act=False,
                               s2d=s2d_convs)

    def forward(self, inputs: torch.Tensor, uv: torch.Tensor,
                reg: torch.Tensor | None = None) -> torch.Tensor:
        del reg   # accepted for API parity; no ShareLayer here
        with f32_convs(self.dtype):
            return self._layers(inputs, uv)

    def _layers(self, inputs: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
        dtype = self.dtype
        x = inputs.permute(0, 3, 1, 2).to(dtype)          # NCHW
        x1 = self.conv1(x)
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x = self.down3(x3)
        uv_small = resize_bilinear_nchw(uv.permute(0, 3, 1, 2).to(dtype),
                                        x.shape[-2:])
        x = torch.cat([x, uv_small], dim=1)
        for blk in self.res:
            x = run_res(blk, x, self.remat and self.training)
        y = self.up1(x)
        y = self.up2(torch.cat([y, x3], dim=1))
        y = self.up3(torch.cat([y, x2], dim=1))
        con = self.conv3(self.conv2(y))
        return nhwc(con).to(self.egress_dtype)
