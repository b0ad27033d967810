"""Serving-time BatchNorm folding (port of
`blindshadowremoval_tpu/models/folding.py`).

In eval mode BatchNorm is a per-channel affine of its frozen statistics,
and every BatchNorm of the generator directly follows a convolution, so it
folds exactly into that convolution's weight and bias:

    s_c     = gamma_c / sqrt(var_c + eps)
    weight' = weight * s_c        (output-channel axis)
    bias'   = (bias - mean_c) * s_c + beta_c

Each block names its (conv, BatchNorm) pairs in `BN_PAIRS`, so pairing is
structural.  Fold in float32, before any cast to bf16, as the JAX package
does.  Serving only: training needs live statistics.
"""

from __future__ import annotations

import torch
from torch import nn


@torch.no_grad()
def _fold_pair(conv: nn.Module, bn: nn.BatchNorm2d) -> None:
    s = bn.weight.float() / torch.sqrt(bn.running_var.float() + bn.eps)
    # output channels: dim 0 of a Conv2d weight, dim 1 of a ConvTranspose2d
    out_dim = 1 if isinstance(conv, nn.ConvTranspose2d) else 0
    shape = [1] * conv.weight.dim()
    shape[out_dim] = -1
    weight = conv.weight.float() * s.view(shape)
    bias = conv.bias.float() if conv.bias is not None else torch.zeros_like(s)
    bias = (bias - bn.running_mean.float()) * s + bn.bias.float()
    conv.weight.copy_(weight.to(conv.weight.dtype))
    if conv.bias is None:
        conv.bias = nn.Parameter(bias.to(conv.weight.dtype))
    else:
        conv.bias.copy_(bias.to(conv.bias.dtype))


def fold_batch_norm(model: nn.Module) -> nn.Module:
    """Fold every BatchNorm of `model` into its paired convolution, in
    place, replacing the BatchNorm by `nn.Identity`.  The result has the
    structure of the same model built with `fold_bn=True`.  Returns
    `model`."""
    if model.training:
        raise ValueError("fold_batch_norm folds eval-mode statistics; call "
                         "model.eval() first")
    for block in model.modules():
        for conv_name, bn_name in getattr(block, "BN_PAIRS", ()):
            bn = getattr(block, bn_name)
            if isinstance(bn, nn.Identity):
                continue
            if bn.weight.dtype != torch.float32:
                raise ValueError("fold in float32, before casting the model")
            _fold_pair(getattr(block, conv_name), bn)
            setattr(block, bn_name, nn.Identity())
    return model
