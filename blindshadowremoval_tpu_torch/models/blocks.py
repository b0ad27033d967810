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
with `fold_bn=True` has `nn.Identity` in place of its BatchNorms.  A
`ConvBlock` built with `int8=True` runs its conv on int8 codes
(ops/quant.py), and one built with `s2d=True` computes a stride-1 odd-k
conv over 2x2 space-to-depth packed pixels (`space_to_depth_conv`), both
with the plain conv's parameters, so checkpoints interchange.  The
options no model of the package uses are ported as the JAX package has
them: `norm="spec"` (flax's SpectralNorm: one power iteration a call, its
`u` and `sigma` kept in the `sn` submodule and updated in training mode
only) and `dropout` (rate 0.3, in training mode only).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from blindshadowremoval_tpu_torch.ops.nonlocal_attn import nonlocal_attention
from blindshadowremoval_tpu_torch.ops.quant import int8_conv, pad_same, same_pad
from blindshadowremoval_tpu_torch.parallel.distributed import all_sum
from blindshadowremoval_tpu_torch.parallel.mesh import batch_group

LEAKY_SLOPE = 0.3
BN_EPS = 1e-3
BN_MOMENTUM = 0.99   # Keras/Flax: running = m * running + (1 - m) * batch
DROPOUT_RATE = 0.3   # blocks.py:215-216, :247-248


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm with Flax's semantics (`flax.linen.BatchNorm`, momentum
    0.99, eps 1e-3), under nn.BatchNorm2d's parameter and buffer names.

    Statistics and the affine are f32, and the normalization runs in f32;
    the output takes the input's dtype.  In training mode it normalizes by
    the batch statistics and moves the running statistics by
    running = 0.99 * running + 0.01 * batch, with the BIASED batch variance
    (nn.BatchNorm2d moves them with the unbiased one, n / (n - 1) larger).
    `update_stats = False` (see `frozen_stats`) keeps the batch statistics
    but leaves the running ones alone.  Inside `with mesh:` of a mesh over
    processes (parallel/), training mode reduces the moments over every
    rank, so the running statistics are the same on each."""

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
        group = batch_group()
        if group is None:
            mean = xf.mean(dim=(0, 2, 3))
            meansq = (xf * xf).mean(dim=(0, 2, 3))
        else:
            # the batch is split over the ranks: the moments are the whole
            # batch's (as GSPMD gives the JAX step), from the sums of x and
            # x^2 and the count, reduced with their gradients
            c = xf.shape[1]
            count = xf.new_full((1,), xf.numel() / c)
            sums = all_sum(torch.cat([xf.sum(dim=(0, 2, 3)),
                                      (xf * xf).sum(dim=(0, 2, 3)), count]),
                           group)
            mean, meansq = sums[:c] / sums[-1], sums[c:2 * c] / sums[-1]
        var = torch.clamp(meansq - mean * mean, min=0.0)
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


def conv(x: torch.Tensor, mod: nn.Module, padding=0,
         weight: torch.Tensor | None = None) -> torch.Tensor:
    """`mod` (a Conv2d or ConvTranspose2d) applied in x's dtype, with
    `weight` in place of its own when given."""
    w = (mod.weight if weight is None else weight).to(x.dtype)
    b = None if mod.bias is None else mod.bias.to(x.dtype)
    if isinstance(mod, nn.ConvTranspose2d):
        return F.conv_transpose2d(x, w, b, mod.stride)
    return F.conv2d(x, w, b, mod.stride, padding)


def conv2d_same(x: torch.Tensor, mod: nn.Conv2d,
                weight: torch.Tensor | None = None) -> torch.Tensor:
    """`mod` applied with TF "SAME" padding, in x's dtype (with `weight`
    in place of its own when given)."""
    k, s = mod.kernel_size[0], mod.stride[0]
    top, bottom = same_pad(x.shape[-2], k, s)
    left, right = same_pad(x.shape[-1], k, s)
    if top == bottom and left == right:
        return conv(x, mod, (top, left), weight)
    return conv(F.pad(x, (left, right, top, bottom)), mod, weight=weight)


# ----------------------------------------------------- space-to-depth convs
def s2d_kernel(weight: torch.Tensor) -> torch.Tensor:
    """[cout, cin, k, k] SAME stride-1 kernel -> [4cout, 4cin, K2, K2]
    VALID kernel over 2x2-packed pixels (K2 = (k+1)//2); input channels
    grouped (pi, pj, c), output channels (di, dj, co), as the JAX package's
    `s2d_kernel` groups them.

    With xp = pad(x, k//2) and phases di, pi in {0, 1}, y[2i+di] = sum_kk
    xp[2i+di+kk] w[kk]; writing di+kk = 2c+pi maps each (output phase,
    input phase) pair to the K2-tap kernel w[2c+pi-di]."""
    cout, cin, k, _ = weight.shape
    k2 = (k + 1) // 2
    c = torch.arange(k2, device=weight.device)
    two = torch.arange(2, device=weight.device)
    kk = 2 * c[:, None, None] + two[None, :, None] - two[None, None, :]
    valid = ((kk >= 0) & (kk < k)).to(weight.dtype)
    kkc = kk.clamp(0, k - 1)
    w = weight.permute(2, 3, 1, 0)                       # HWIO
    wk = w[kkc] * valid[..., None, None, None]          # [c,pi,di,l,ci,co]
    wkl = wk[:, :, :, kkc] * valid[None, None, None, ..., None, None]
    # [c,pi,di,d,pj,dj,ci,co] -> [(di,dj,co), (pi,pj,ci), c, d]
    return wkl.permute(2, 5, 7, 1, 4, 6, 0, 3).reshape(
        4 * cout, 4 * cin, k2, k2)


def s2d_pack(x: torch.Tensor, k: int) -> torch.Tensor:
    """[B, C, H, W] padded for a SAME odd-k conv and packed 2x2 pixels into
    channels: [B, 4C, (H+2p)/2, (W+2p)/2], channel (pi*2+pj)*C + c."""
    b, cin, hh, ww = x.shape
    p = k // 2
    xp = F.pad(x, (p, p, p, p))
    h2, w2 = (hh + 2 * p) // 2, (ww + 2 * p) // 2
    x2 = xp.reshape(b, cin, h2, 2, w2, 2).permute(0, 3, 5, 1, 2, 4)
    return x2.reshape(b, 4 * cin, h2, w2)


def d2s_unpack(y2: torch.Tensor, cout: int) -> torch.Tensor:
    """Inverse of the output packing: [B, 4cout, h, w] -> [B, cout, 2h,
    2w]."""
    b, _, oh, ow = y2.shape
    y = y2.reshape(b, 2, 2, cout, oh, ow).permute(0, 3, 4, 1, 5, 2)
    return y.reshape(b, cout, 2 * oh, 2 * ow)


def space_to_depth_conv(x: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A stride-1 SAME odd-k conv of x [B, C, H, W] (H, W even) as a VALID
    K2 x K2 conv over 2x2-packed pixels, in `dtype`: the same convolution
    with four times the channels on each side.  (The JAX package measured
    it slower than the direct conv on the TPU; no default uses it.)"""
    cout, _, k, _ = weight.shape
    if k % 2 != 1 or x.shape[-2] % 2 or x.shape[-1] % 2:
        raise ValueError(f"space_to_depth_conv needs an odd k and even H, W;"
                         f" got k={k}, {tuple(x.shape[-2:])}")
    y2 = F.conv2d(s2d_pack(x, k).to(dtype), s2d_kernel(weight).to(dtype))
    return d2s_unpack(y2, cout) + bias.to(dtype)[None, :, None, None]


class SpectralNorm(nn.Module):
    """flax.linen.SpectralNorm (n_steps=1, eps 1e-12) of one conv kernel:
    the kernel as flax holds it (HWIO, or [kh, kw, IN, OUT] for a
    transposed conv), flattened to [-1, OUT], divided by sigma = v W u^T
    after one power iteration from the stored `u`.  In training mode (flax's
    `update_stats=True`) the new `u` and `sigma` are stored; u and v carry
    no gradient, sigma does."""

    EPS = 1e-12

    def __init__(self, features: int):
        super().__init__()
        self.register_buffer("u", torch.randn(1, features))
        self.register_buffer("sigma", torch.ones(()))

    @classmethod
    def _normalize(cls, x: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt((x * x).sum() + cls.EPS)

    def forward(self, weight: torch.Tensor, transpose: bool) -> torch.Tensor:
        # torch Conv2d [O, I, kh, kw] -> HWIO; ConvTranspose2d [I, O, kh,
        # kw] is flax's [kh, kw, I, O] flipped
        mat = (weight.flip(2, 3).permute(2, 3, 0, 1) if transpose
               else weight.permute(2, 3, 1, 0))
        mat = mat.reshape(-1, mat.shape[-1])
        with torch.no_grad():
            v = self._normalize(self.u @ mat.T)
            u = self._normalize(v @ mat)
        sigma = (v @ mat @ u.T)[0, 0]
        if self.training:
            with torch.no_grad():
                self.u.copy_(u)
                self.sigma.copy_(sigma)
        return weight / torch.where(sigma != 0, sigma, torch.ones_like(sigma))


def _norm(features: int, norm: str | None, fold_bn: bool) -> nn.Module:
    """The block's BatchNorm ("batch"), or nothing ("spec" normalizes the
    kernel instead, None not at all)."""
    if norm not in ("batch", "spec", None):
        raise ValueError(f"norm={norm!r}: choose 'batch', 'spec' or None")
    return _bn(features, fold_bn) if norm == "batch" else nn.Identity()


def int8_conv2d_same(x: torch.Tensor, mod: nn.Conv2d,
                     static_scale: float | tuple = 0.0,
                     channels: tuple | None = None) -> torch.Tensor:
    """`mod` applied "SAME" on int8 codes (ops/quant.py:int8_conv), in x's
    dtype (JAX `_Int8Conv`).  `channels`: only these output channels run
    int8, the rest in x's dtype (the split head)."""
    s = mod.stride[0]
    if channels is None:
        return int8_conv(x, mod.weight, mod.bias, s,
                         static_scale).to(x.dtype)
    ch8 = list(channels)
    rest = [c for c in range(mod.out_channels) if c not in ch8]
    y8 = int8_conv(x, mod.weight[ch8], mod.bias[ch8], s,
                   static_scale).to(x.dtype)
    # the exact channels: the conv, then the bias, each rounded to x's
    # dtype, as the JAX package adds them
    yr = F.conv2d(pad_same(x, mod.kernel_size[0], s),
                  mod.weight[rest].to(x.dtype), stride=s) \
        + mod.bias[rest].to(x.dtype)[None, :, None, None]
    cols = [None] * mod.out_channels
    for j, c in enumerate(ch8):
        cols[c] = y8[:, j:j + 1]
    for j, c in enumerate(rest):
        cols[c] = yr[:, j:j + 1]
    return torch.cat(cols, dim=1)


class ConvBlock(nn.Module):
    """Conv + optional BatchNorm or spectral norm + optional LeakyReLU +
    optional dropout (model.py:115-147).  `norm` in {"batch", "spec",
    None}.

    `int8`: the conv runs on int8 codes against the activation bound(s)
    `int8_scale` (a scalar, a per-input-channel tuple, or <= 0 for the
    dynamic per-sample max), for the output channels `int8_channels` only
    when given (ops/quant.py; JAX `ConvBlock.quant_*`).  `s2d`: a stride-1
    odd-k conv on an even-sized input runs as `space_to_depth_conv`; the
    int8 path takes precedence, and an s2d conv is not spectrally
    normalized, as in the JAX package (blocks.py:187-205)."""

    BN_PAIRS = (("conv", "bn"),)

    def __init__(self, in_ch: int, features: int, ksize: int = 3,
                 stride: int = 1, norm: str | None = "batch", act: bool = True,
                 fold_bn: bool = False, int8: bool = False,
                 int8_scale: float | tuple = 0.0,
                 int8_channels: tuple | None = None, s2d: bool = False,
                 dropout: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, features, ksize, stride)
        self.bn = _norm(features, norm, fold_bn)
        self.sn = SpectralNorm(features) if norm == "spec" else None
        self.act = act
        self.int8 = int8
        self.int8_scale = int8_scale
        self.int8_channels = int8_channels
        self.s2d = s2d
        self.dropout = dropout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.conv.kernel_size[0], self.conv.stride[0]
        if self.int8:
            y = int8_conv2d_same(x, self.conv, self.int8_scale,
                                 self.int8_channels)
        elif (self.s2d and s == 1 and k % 2 == 1 and x.shape[-2] % 2 == 0
              and x.shape[-1] % 2 == 0):
            y = space_to_depth_conv(x, self.conv.weight, self.conv.bias,
                                    x.dtype)
        else:
            y = conv2d_same(x, self.conv, None if self.sn is None
                            else self.sn(self.conv.weight, transpose=False))
        return _act_dropout(self.bn(y), self.act, self.dropout, self.training)


def _act_dropout(x: torch.Tensor, act: bool, dropout: bool,
                 training: bool) -> torch.Tensor:
    if act:
        x = F.leaky_relu(x, LEAKY_SLOPE)
    if dropout:
        x = F.dropout(x, DROPOUT_RATE, training)
    return x


class ConvTBlock(nn.Module):
    """3x3 stride-2 transposed conv + BatchNorm or spectral norm +
    LeakyReLU + optional dropout (model.py:149-177), TF "SAME": the output
    is exactly (2H, 2W)."""

    BN_PAIRS = (("conv", "bn"),)

    def __init__(self, in_ch: int, features: int, fold_bn: bool = False,
                 norm: str | None = "batch", dropout: bool = False):
        super().__init__()
        self.conv = nn.ConvTranspose2d(in_ch, features, 3, 2)
        self.bn = _norm(features, norm, fold_bn)
        self.sn = SpectralNorm(features) if norm == "spec" else None
        self.dropout = dropout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2:]
        y = conv(x, self.conv, weight=None if self.sn is None
                 else self.sn(self.conv.weight, transpose=True))
        y = y[..., :2 * h, :2 * w]
        return _act_dropout(self.bn(y), True, self.dropout, self.training)


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
