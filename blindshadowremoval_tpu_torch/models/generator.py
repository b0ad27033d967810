"""GSC (grayscale shadow consistency) generator (port of
`blindshadowremoval_tpu/models/generator.py:GSCGenerator`).

  encoder:  7x7 conv (32) -> three stride-2 convs (64, 64, 96), 256 -> 32 px
  shared:   UV map concatenated at the 32x32 bottleneck, then 3
            NonLocal-augmented ResBottlenecks at 257 channels
  GS head:  3 up-convs with encoder skips; a fused 2-channel 7x7 head gives
            the gain `mask = tanh(.)` and offset `con`:
            gs = gray(input) * (1 + mask) + con
  RGB head: a binary shadow mask from the grayscale difference gates the
            bottleneck features; 3 more ResBottlenecks; 3 up-convs; 3 convs
            conditioned on `gs` give the recoloured output.

The TSM variant (models/generator_tsm.py) is this network with a
ShareLayer's output concatenated at both bottleneck concats.

Inputs and outputs are NHWC, as in the JAX package: forward(inputs
[B,H,W,3], uv [B,H,W,3]) -> (gs [B,H,W,1], con_rgb [B,H,W,3], mask22
[B,H,W,3], dif [B,H,W,1]) in `egress_dtype`.  Activations run in `dtype`
(the compute dtype); parameters keep the dtype they were made in, f32 for
training, and each convolution casts its weights to its input's dtype.

Training: `model.train()` puts every BatchNorm on batch statistics with
Flax's running update (`models/blocks.py:BatchNorm`).  `remat=True`
recomputes each ResBottleneck in the backward pass
(`torch.utils.checkpoint`), and the recompute leaves the running statistics
alone, so they move once per step as without remat.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from blindshadowremoval_tpu_torch.geometry.warp import resize_bilinear_nchw
from blindshadowremoval_tpu_torch.models.blocks import (
    ConvBlock,
    ConvTBlock,
    ResBottleneck,
    frozen_stats,
)
from blindshadowremoval_tpu_torch.ops.image import rgb_to_grayscale

# encoder/decoder widths (model.py:201)
N_CH = (32, 64, 64, 96, 128, 256, 256)
RES_CH = N_CH[5] + 1    # 257: the bottleneck width


class GSCGenerator(nn.Module):
    """Two-stage grayscale-then-RGB deshadowing generator."""

    # channels a ShareLayer adds at each bottleneck concat, per feature
    # channel (none here; 2 in the TSM variant: its max and its mean)
    SHARE_WIDTH = 0

    def __init__(self, n_res: int = 6, fold_bn: bool = False,
                 egress_dtype: torch.dtype = torch.float32,
                 dtype: torch.dtype = torch.float32, remat: bool = False,
                 int8_head: bool = False,
                 int8_head_scale: float | tuple = 0.0,
                 int8_head_split: bool = False, s2d_convs: bool = False):
        super().__init__()
        self.egress_dtype = egress_dtype
        self.dtype = dtype
        self.remat = remat
        fb = dict(fold_bn=fold_bn)
        # s2d_convs: conv1 and the 7x7 head as space-to-depth convs
        # (generator.py:77,105 in the JAX package)
        self.conv1 = ConvBlock(3, N_CH[0], ksize=7, s2d=s2d_convs, **fb)
        self.down1 = ConvBlock(N_CH[0], N_CH[1], stride=2, **fb)
        self.down2 = ConvBlock(N_CH[1], N_CH[2], stride=2, **fb)
        self.down3 = ConvBlock(N_CH[2], N_CH[3], stride=2, **fb)
        # res0's input: 96 features (+ their shared statistics) + 3 UV;
        # later blocks of each half keep the wider of their input and 257
        # (channel-pad residual).  The RGB half's input: the gated features
        # (+ their shared statistics) + bmask + UV
        k = 1 + self.SHARE_WIDTH
        shared_in = N_CH[3] * k + 3
        shared_out = max(shared_in, RES_CH)
        rgb_in = shared_out * k + 1 + 3
        rgb_out = max(rgb_in, RES_CH)
        half = n_res // 2
        ins = ([shared_in] + [shared_out] * (half - 1)
               + [rgb_in] + [rgb_out] * (n_res - half - 1))
        self.res = nn.ModuleList(ResBottleneck(c, RES_CH, **fb) for c in ins)
        self.up1 = ConvTBlock(shared_out, N_CH[3], **fb)
        self.up2 = ConvTBlock(N_CH[3] + N_CH[2], N_CH[2], **fb)
        self.up3 = ConvTBlock(N_CH[2] + N_CH[1], N_CH[1], **fb)
        # conv2 (tanh gain) and conv3 (offset) of the reference, fused into
        # one 2-channel 7x7 head, as in the JAX package.  int8_head runs it
        # on int8 codes against the bound(s) int8_head_scale
        # (ops/calibration.py derives them from the checkpoint); the split
        # head puts only channel 1, the offset `con`, on int8, and keeps
        # the tanh gain that feeds the dif > 0.1 mask exact
        self.head = ConvBlock(
            N_CH[1], 2, ksize=7, norm=None, act=False,
            int8=int8_head or int8_head_split, int8_scale=int8_head_scale,
            int8_channels=(1,) if int8_head_split else None, s2d=s2d_convs)
        self.clr_up1 = ConvTBlock(rgb_out, N_CH[4], **fb)
        self.clr_up2 = ConvTBlock(N_CH[4], N_CH[3], **fb)
        self.clr_up3 = ConvTBlock(N_CH[3], N_CH[2], **fb)
        self.clr_conv1 = ConvBlock(1 + N_CH[2], 16, ksize=3, **fb)
        self.clr_conv2 = ConvBlock(16, 16, ksize=1, **fb)
        self.clr_conv3 = ConvBlock(16, 3, ksize=1, norm=None, act=False)
        self.n_res = n_res

    def forward(self, inputs: torch.Tensor, uv: torch.Tensor,
                reg: torch.Tensor | None = None):
        del reg   # accepted for API parity; the GSC variant has no ShareLayer
        return self._run(inputs, uv, lambda x: ())

    def _run(self, inputs: torch.Tensor, uv: torch.Tensor, shared):
        """The forward, with `shared(x)` giving the tensors concatenated
        after the bottleneck features x at both concats (none for GSC)."""
        with f32_convs(self.dtype):
            return self._layers(inputs, uv, shared)

    def _layers(self, inputs: torch.Tensor, uv: torch.Tensor, shared):
        dtype = self.dtype
        x = inputs.permute(0, 3, 1, 2).to(dtype)          # NCHW

        # ---- encoder ------------------------------------------------
        x1 = self.conv1(x)
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x = self.down3(x3)
        h, w = x.shape[-2:]

        # ---- bottleneck with UV conditioning ------------------------
        uv_small = resize_bilinear_nchw(uv.permute(0, 3, 1, 2).to(dtype),
                                        (h, w))
        x = torch.cat([x, *shared(x), uv_small], dim=1)
        half = self.n_res // 2
        for blk in self.res[:half]:
            x = run_res(blk, x, self.remat and self.training)

        # ---- grayscale head -----------------------------------------
        y = self.up1(x)
        y = self.up2(torch.cat([y, x3], dim=1))
        y = self.up3(torch.cat([y, x2], dim=1))
        head = self.head(y)
        mask = torch.tanh(head[:, 0:1])
        con = head[:, 1:2]

        gray_in = rgb_to_grayscale(inputs.float()).permute(0, 3, 1, 2).to(dtype)
        gs = gray_in * (1.0 + mask) + con
        dif = gs - gray_in
        mask22 = torch.cat([F.relu(mask), mask * 0.0, F.relu(-mask)], dim=1)

        # ---- RGB head -----------------------------------------------
        # binary shadow mask at bottleneck resolution, from an f32 resize;
        # no gradient flows through it (generator.py:123-125)
        bmask = (resize_bilinear_nchw(dif.detach().float(), (h, w))
                 > 0.1).to(dtype)
        x_hole = x * (1.0 - bmask)
        x = torch.cat([x_hole, bmask, *shared(x_hole), uv_small], dim=1)
        for blk in self.res[half:]:
            x = run_res(blk, x, self.remat and self.training)
        f = self.clr_up1(x)
        f = self.clr_up2(f)
        f = self.clr_up3(f)
        con_rgb = self.clr_conv1(torch.cat([gs, f], dim=1))
        con_rgb = self.clr_conv2(con_rgb)
        con_rgb = self.clr_conv3(con_rgb)

        et = self.egress_dtype
        con_rgb = nhwc(con_rgb).to(et)
        dif_out = rgb_to_grayscale(con_rgb) - rgb_to_grayscale(inputs.to(et))
        return (nhwc(gs).to(et), con_rgb, nhwc(mask22).to(et), dif_out)


@contextlib.contextmanager
def f32_convs(dtype: torch.dtype):
    """Inside, an f32-compute forward's convolutions run in true f32:
    PyTorch lets cuDNN use TF32 by default, whose 10-bit mantissa moves an
    f32 forward off the TF-reference goldens (PERF.md, P2).  cuDNN's
    setting is restored after; other compute dtypes leave it alone."""
    cudnn = torch.backends.cudnn
    saved = cudnn.allow_tf32
    if dtype == torch.float32:
        cudnn.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32 = saved


def nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1)


def run_res(blk: ResBottleneck, x: torch.Tensor, remat: bool) -> torch.Tensor:
    """One ResBottleneck, recomputed in the backward pass under `remat`
    (a training forward with autograd on)."""
    if not (remat and torch.is_grad_enabled()):
        return blk(x)
    # the recompute in backward sees the same input, so the same batch
    # statistics, and must not move the running statistics again
    return checkpoint(blk, x, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          frozen_stats(blk)))
