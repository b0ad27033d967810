"""Frozen VGG-19 feature extractor of the perceptual loss (port of
`blindshadowremoval_tpu/models/vgg.py`, reference train_test_GSC.py:128-160).

Features at block{1..5}_conv1 of caffe-preprocessed input (RGB -> BGR,
x255, minus the ImageNet channel means).  Only the layers up to
block5_conv1 run: nothing after it reaches a tap.  No ImageNet weights ship
with the repository; `load_weights_npz` reads a converted `.npz` of the
Keras h5 (keys `block1_conv1/kernel`, HWIO, and `.../bias`).  Without one
the extractor is randomly initialized from a seed, which makes the
perceptual term a random-projection feature loss.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# (block, features, conv count) per VGG19 block
_CFG = (("block1", 64, 2), ("block2", 128, 2), ("block3", 256, 4),
        ("block4", 512, 4), ("block5", 512, 4))
TAPS = ("block1_conv1", "block2_conv1", "block3_conv1", "block4_conv1",
        "block5_conv1")

# ImageNet BGR channel means of keras.applications preprocess (caffe mode)
_BGR_MEAN = (103.939, 116.779, 123.68)


def preprocess(img01: torch.Tensor) -> torch.Tensor:
    """[B,H,W,3] RGB in [0,1] -> caffe-style BGR, x255, mean-subtracted."""
    x = torch.flip(img01, dims=(-1,)) * 255.0
    return x - torch.tensor(_BGR_MEAN, dtype=x.dtype, device=x.device)


def _layers():
    """(name, in, out) of each conv up to the last tap, in order, with
    "pool" between blocks."""
    out, cin = [], 3
    for block, width, n_conv in _CFG:
        if out:
            out.append(("pool", 0, 0))
        for i in range(1, n_conv + 1):
            out.append((f"{block}_conv{i}", cin, width))
            cin = width
            if f"{block}_conv{i}" == TAPS[-1]:
                return out
    return out


def conv_names() -> list[str]:
    """The convolutions the extractor runs, in order."""
    return [name for name, _, _ in _layers() if name != "pool"]


class VGG19Features(nn.Module):
    """Returns the f32 features at the five taps of NHWC input, computing
    in `dtype`.  Frozen: its parameters do not take gradients."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.layers = _layers()
        self.convs = nn.ModuleDict(
            {name: nn.Conv2d(cin, cout, 3, padding=1)
             for name, cin, cout in self.layers if name != "pool"})
        self.requires_grad_(False)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        feats = []
        for name, _, _ in self.layers:
            if name == "pool":
                x = F.max_pool2d(x, 2, 2)
                continue
            mod = self.convs[name]
            x = F.relu(F.conv2d(x, mod.weight.to(x.dtype),
                                mod.bias.to(x.dtype), padding=1))
            if name in TAPS:
                feats.append(x.permute(0, 2, 3, 1).float())
        return feats


def init_vgg(model: VGG19Features, seed: int = 0) -> VGG19Features:
    """LeCun-normal kernels and zero biases (Flax's nn.Conv defaults), drawn
    from a seeded generator."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.convs.values():
            fan_in = mod.weight[0].numel()
            mod.weight.copy_(torch.randn(mod.weight.shape, generator=gen)
                             / np.sqrt(fan_in))
            mod.bias.zero_()
    return model


def load_weights_npz(path: str) -> dict[str, torch.Tensor]:
    """A VGG19Features state_dict from an npz of Keras-style VGG19 weights
    (`<block>_conv<i>/kernel` [3,3,in,out] HWIO and `.../bias` [out]);
    layers past block5_conv1 are ignored."""
    raw = np.load(path)
    sd = {}
    for name in conv_names():
        k = np.asarray(raw[f"{name}/kernel"], np.float32)
        sd[f"convs.{name}.weight"] = torch.from_numpy(
            np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
        sd[f"convs.{name}.bias"] = torch.from_numpy(
            np.asarray(raw[f"{name}/bias"], np.float32))
    return sd
