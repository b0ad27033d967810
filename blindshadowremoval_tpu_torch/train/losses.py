"""Loss library of the train step (port of
`blindshadowremoval_tpu/train/losses.py`, reference utils.py:22-125 and
train_test_GSC.py:107-115,287-336).

Images are NHWC.  Masked losses divide by the mask sum (plus 1e-6) and the
channel count; YUV losses average (y+u+v)/2; HSV uses circular hue and
averages (h+v)/2; the hinge loss is mean(max(0, 1 - y_true * y_pred)); the
perceptual loss sums the mean |real - fake| of the five VGG taps; the
gradient loss compares (dx+dy)*5 at scales {1,2,4,8,16}, reweighted 1/30/10
(global/shadow/edge) and normalized by the edge-mask sum.

Inside `with mesh:` of a mesh over processes (parallel/), each rank holds
an equal share of the batch.  A plain mean is then the mean of the ranks'
means.  A ratio of batch-wide sums is not: its denominator (a mask sum,
constant in the parameters) is summed over the ranks first, and each rank
returns its numerator's share scaled so that the ranks' mean is the
whole batch's ratio (`_batch_ratio`).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.distributed as dist

from blindshadowremoval_tpu_torch.geometry.warp import resize_bilinear
from blindshadowremoval_tpu_torch.ops.image import (
    image_gradients,
    rgb_to_hsv,
    rgb_to_yuv,
)
from blindshadowremoval_tpu_torch.parallel.distributed import all_sum
from blindshadowremoval_tpu_torch.parallel.mesh import batch_group


def _batch_ratio(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num / (den + 1e-6) over the whole batch.  Under a mesh over
    processes: n * num / (the ranks' summed den + 1e-6), whose mean over
    the n ranks is the whole batch's ratio."""
    group = batch_group()
    if group is None:
        return num / (den + 1e-6)
    return num * dist.get_world_size(group) / (all_sum(den, group) + 1e-6)


def _masked_mean(diff: torch.Tensor, mask: torch.Tensor | None,
                 channels: int) -> torch.Tensor:
    if mask is None:
        return diff.mean()
    return _batch_ratio((diff * mask).sum(), mask.sum()) / channels


def l1_loss(x, y, mask=None):
    """utils.py:22-29 (the masked variant divides by C)."""
    ch = x.shape[3] if mask is not None else 1
    return _masked_mean((x - y).abs(), mask, ch)


def l2_loss(x, y, mask=None):
    """utils.py:69-75."""
    ch = x.shape[3] if mask is not None else 1
    return _masked_mean((x - y) ** 2, mask, ch)


def _yuv_channel_losses(x, y, mask, sq: bool):
    d = rgb_to_yuv(x) - rgb_to_yuv(y)
    diff = d * d if sq else d.abs()
    total = 0.0
    for k in range(3):
        dk = diff[..., k:k + 1]
        if mask is not None:
            total = total + _batch_ratio((dk * mask).sum(), mask.sum())
        else:
            total = total + dk.mean()
    return total / 2.0


def l1_loss_yuv(x, y, mask=None):
    """utils.py:31-52: per-channel masked L1 in YUV, (y+u+v)/2, with the
    mask's first channel."""
    return _yuv_channel_losses(x, y, None if mask is None else mask[..., :1],
                               sq=False)


def l2_loss_yuv(x, y, mask=None):
    """utils.py:77-98."""
    return _yuv_channel_losses(x, y, None if mask is None else mask[..., :1],
                               sq=True)


def l1_loss_hsv(x, y, mask=None):
    """utils.py:54-67: circular hue + value, (h+v)/2, of the channel-
    reversed (BGR) input, as the reference computes it."""
    hx = rgb_to_hsv(torch.flip(x, dims=(-1,)).clamp(0.0, 1.0))
    hy = rgb_to_hsv(torch.flip(y, dims=(-1,)).clamp(0.0, 1.0))
    two_pi = 2 * math.pi
    dh = (torch.cos(two_pi * hx[..., 0:1]) - torch.cos(two_pi * hy[..., 0:1])).abs()
    dv = (hx[..., 2:3] - hy[..., 2:3]).abs()
    if mask is not None:
        m = mask[..., :1]
        h_loss = _batch_ratio((dh * m).sum(), m.sum())
        v_loss = _batch_ratio((dv * m).sum(), m.sum())
    else:
        h_loss, v_loss = dh.mean(), dv.mean()
    return (h_loss + v_loss) / 2.0


def hinge_loss(y_pred, y_true: float):
    """utils.py:100-102: mean(max(0, 1 - y_true * y_pred))."""
    return torch.clamp(1.0 - y_true * y_pred, min=0.0).mean()


def style_content_loss_pair(feats_real: Sequence[torch.Tensor],
                            feats_fake: Sequence[torch.Tensor]):
    """utils.py:104-114 with the real and fake taps computed separately (VGG
    has no cross-batch op, so this equals the concatenated form)."""
    loss = 0.0
    for fr, ff in zip(feats_real, feats_fake):
        loss = loss + (fr - ff).abs().mean()
    return loss


def get_img_grad(img: torch.Tensor, scale: int = 1) -> torch.Tensor:
    """(dx + dy) * 5 at a downscale (train_test_GSC.py:107-115)."""
    h, w = img.shape[1:3]
    if scale > 1:
        img = resize_bilinear(img, (h // scale, w // scale))
    dy, dx = image_gradients(img)
    grad = (dx + dy) * 5.0
    if scale > 1:
        grad = resize_bilinear(grad, (h, w))
    return grad


def multi_scale_gradient_loss(pred, gt, mask_bi, mask_edge):
    """5-scale reweighted gradient loss (train_test_GSC.py:307-328)."""
    total = 0.0
    for scale in (1, 2, 4, 8, 16):
        d = (get_img_grad(pred, scale) - get_img_grad(gt, scale)).abs()
        total = total + ((d + 30.0 * d * mask_bi + 10.0 * d * mask_edge)
                         / 41.0).sum()
    return _batch_ratio(total, mask_edge.sum())


def reconstruction_losses(gs, rgb, gt, gray_gt, mask_bi, mask_edge):
    """The 1/30/10-reweighted reconstruction pair (train_test_GSC.py:287-301)."""
    recon_gs = (l1_loss(gs, gray_gt)
                + l1_loss(gs, gray_gt, mask_bi) * 30.0
                + l1_loss(gs, gray_gt, mask_edge) * 10.0) / 41.0
    recon_c = (l1_loss(rgb, gt)
               + l1_loss(rgb, gt, mask_bi) * 30.0
               + l1_loss(rgb, gt, mask_edge) * 10.0
               + l1_loss_yuv(rgb, gt)
               + l1_loss_yuv(rgb, gt, mask_bi) * 30.0
               + l1_loss_yuv(rgb, gt, mask_edge) * 10.0) / 82.0
    return recon_gs, recon_c
