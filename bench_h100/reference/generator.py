"""Plain reference of the GSC generator and its TSM variant (Hou et al.,
"Blind Removal of Facial Foreign Shadows", BMVC 2022; the reference
repository's `model.py` and `model_with_TSM.py`), in f32 PyTorch.

Functional, over the unfolded state dict the benchmark draws (the same
names the program's `build_generator` takes): eval-mode BatchNorm as its
affine of the running statistics (eps 1e-3), TF "SAME" padding, LeakyReLU
0.3, the NonLocal attention as a plain softmax(theta phi^T) g over the
NHWC position order without a 1/sqrt(D) scale, TF's half-pixel bilinear
resize, and the ShareLayer's max and mean over each group of `frame`
views in canonical face space.

`operand` is applied to both operands of every convolution and matrix
product, and `egress` to the outputs and to the operands of the shadow
map taken from them: the identity for the reference, a rounding to a
lower precision for the benchmark's control (`fp8_operand`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-3
SLOPE = 0.3
GRAY = (0.2989, 0.5870, 0.1140)
GATE = 0.1      # the RGB half's shadow gate: dif > GATE at the bottleneck


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def fp8_operand(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale a tensor (its largest
    magnitude mapped to e4m3's 448), back in f32."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def bf16_operand(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16, back in f32."""
    return x.to(torch.bfloat16).float()


# the next precision below a configuration's stated one, as the control
# computes it: bf16 for f32, float8 e4m3 for bf16
LOWER = {"float32": bf16_operand, "bfloat16": fp8_operand}


class Net:
    """The generator's parameters and the roundings of its operands and
    outputs."""

    def __init__(self, sd: dict, operand=identity, egress=identity):
        self.sd = {k: v.float() for k, v in sd.items()}
        self.op = operand
        self.egress = egress

    def p(self, name: str) -> torch.Tensor:
        return self.sd[name]

    def bn(self, x: torch.Tensor, name: str) -> torch.Tensor:
        mean, var = self.p(name + ".running_mean"), self.p(name + ".running_var")
        scale = self.p(name + ".weight") / torch.sqrt(var + BN_EPS)
        return (x - mean[:, None, None]) * scale[:, None, None] \
            + self.p(name + ".bias")[:, None, None]

    def conv(self, x: torch.Tensor, name: str, stride: int = 1) -> torch.Tensor:
        w, b = self.p(name + ".weight"), self.p(name + ".bias")
        k = w.shape[-1]
        pads = []
        for n in (x.shape[-1], x.shape[-2]):
            total = max((-(-n // stride) - 1) * stride + k - n, 0)
            pads += [total // 2, total - total // 2]
        return F.conv2d(F.pad(self.op(x), pads), self.op(w), b, stride)

    def conv_block(self, x, name, stride=1, norm=True, act=True):
        y = self.conv(x, name + ".conv", stride)
        if norm:
            y = self.bn(y, name + ".bn")
        return F.leaky_relu(y, SLOPE) if act else y

    def convt_block(self, x, name):
        h, w = x.shape[-2:]
        y = F.conv_transpose2d(self.op(x), self.op(self.p(name + ".conv.weight")),
                               self.p(name + ".conv.bias"), 2)
        y = self.bn(y[..., :2 * h, :2 * w], name + ".bn")
        return F.leaky_relu(y, SLOPE)

    def nonlocal_block(self, x, name):
        b, _, h, w = x.shape

        def positions(mod):
            y = self.conv(x, f"{name}.{mod}")
            return y.permute(0, 2, 3, 1).reshape(b, h * w, -1)

        theta, phi, g = positions("theta"), positions("phi"), positions("g")
        scores = torch.matmul(self.op(theta), self.op(phi).transpose(1, 2))
        att = torch.matmul(self.op(torch.softmax(scores, -1)), self.op(g))
        y = att.reshape(b, h, w, -1).permute(0, 3, 1, 2)
        return x + self.bn(self.conv(y, name + ".w"), name + ".bn")

    def res_block(self, x, name):
        y = F.leaky_relu(self.bn(self.conv(x, name + ".conv1"), name + ".bn1"),
                         SLOPE)
        y = F.leaky_relu(self.bn(self.conv(y, name + ".conv2"), name + ".bn2"),
                         SLOPE)
        y = self.nonlocal_block(self.bn(self.conv(y, name + ".conv3"),
                                        name + ".bn3"), name + ".non_local")
        cx, cy = x.shape[1], y.shape[1]
        if cx < cy:
            x = F.pad(x, (0, 0, 0, 0, 0, cy - cx))
        elif cy < cx:
            y = F.pad(y, (0, 0, 0, 0, 0, cx - cy))
        return F.leaky_relu(x + y, SLOPE)


def interp_matrix(out_size: int, in_size: int, device) -> torch.Tensor:
    """[out, in] TF bilinear resize matrix: half-pixel centres, clamped."""
    pos = (np.arange(out_size, dtype=np.float64) + 0.5) * (in_size / out_size) \
        - 0.5
    pos = np.clip(pos, 0.0, in_size - 1.0)
    lo, hi = np.floor(pos).astype(np.int64), np.ceil(pos).astype(np.int64)
    f = (pos - lo).astype(np.float32)
    a = np.zeros((out_size, in_size), np.float32)
    a[np.arange(out_size), lo] += 1.0 - f
    a[np.arange(out_size), hi] += f
    return torch.from_numpy(a).to(device)


def resize_nchw(x: torch.Tensor, size: int) -> torch.Tensor:
    h, w = x.shape[-2:]
    if (h, w) == (size, size):
        return x
    a_h = interp_matrix(size, h, x.device)
    a_w = interp_matrix(size, w, x.device)
    return a_h @ x @ a_w.t()


def gray(x: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 1] luma."""
    return (x * torch.tensor(GRAY, device=x.device)).sum(-1, keepdim=True)


def warp(x: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """x [B,s,s,C] sampled bilinearly (coordinates clamped, corners at
    their floor and ceil) at the identity grid plus the offset field
    [B,S,S,>=2] (row, col, in fractions of the side) resized to s."""
    b, s = x.shape[:2]
    off = offsets[..., :2].permute(0, 3, 1, 2)
    off = resize_nchw(off, s).permute(0, 2, 3, 1) * s
    grid = torch.arange(s, dtype=torch.float32, device=x.device)
    rows = (off[..., 0] + grid[:, None]).reshape(b, -1).clamp(0, s - 1)
    cols = (off[..., 1] + grid[None, :]).reshape(b, -1).clamp(0, s - 1)
    r0, c0, r1, c1 = rows.floor(), cols.floor(), rows.ceil(), cols.ceil()
    fr, fc = (rows - r0)[..., None], (cols - c0)[..., None]
    flat = x.reshape(b, s * s, -1)

    def take(ri, ci):
        idx = (ri.long() * s + ci.long())[..., None].expand(-1, -1,
                                                             flat.shape[-1])
        return torch.gather(flat, 1, idx)

    top = take(r0, c0) + (take(r1, c0) - take(r0, c0)) * fr
    bot = take(r0, c1) + (take(r1, c1) - take(r0, c1)) * fr
    return (top + (bot - top) * fc).reshape(x.shape)


def share(x: torch.Tensor, reg: torch.Tensor, frame: int) -> torch.Tensor:
    """The ShareLayer: features [G*F,C,h,w] warped into the canonical face
    (reg[..., :3]), their max and mean over each group of `frame` views,
    warped back out (reg[..., 3:]) to every view: [G*F, 2C, h, w]."""
    xr = warp(x.permute(0, 2, 3, 1), reg[..., :3])
    gf, h, w, c = xr.shape
    grouped = xr.reshape(gf // frame, frame, h, w, c)
    pooled = torch.cat([grouped.amax(1), grouped.mean(1)], -1)
    pooled = pooled[:, None].expand(-1, frame, -1, -1, -1).reshape(
        gf, h, w, 2 * c)
    return warp(pooled, reg[..., 3:]).permute(0, 3, 1, 2)


def generator(net: Net, img: torch.Tensor, uv: torch.Tensor, n_res: int,
              reg: torch.Tensor | None = None, frame: int = 1,
              gate: float = GATE):
    """(gs, rgb, mask22, dif), NHWC, of the GSC generator, or of the TSM
    generator when `reg` is given (the ShareLayer over groups of `frame`
    views).  `gate` moves the shadow gate's threshold, for the envelope
    that the comparison allows where rounding can flip the gate."""

    def shared(x):
        return [] if reg is None else [share(x, reg, frame)]

    x = img.permute(0, 3, 1, 2)
    x1 = net.conv_block(x, "conv1")
    x2 = net.conv_block(x1, "down1", 2)
    x3 = net.conv_block(x2, "down2", 2)
    x = net.conv_block(x3, "down3", 2)
    h = x.shape[-1]
    uv_small = resize_nchw(uv.permute(0, 3, 1, 2), h)
    x = torch.cat([x, *shared(x), uv_small], 1)
    half = n_res // 2
    for i in range(half):
        x = net.res_block(x, f"res.{i}")
    y = net.convt_block(x, "up1")
    y = net.convt_block(torch.cat([y, x3], 1), "up2")
    y = net.convt_block(torch.cat([y, x2], 1), "up3")
    head = net.conv_block(y, "head", norm=False, act=False)
    mask, con = torch.tanh(head[:, :1]), head[:, 1:2]
    gray_in = gray(img).permute(0, 3, 1, 2)
    gs = gray_in * (1.0 + mask) + con
    dif = gs - gray_in
    mask22 = torch.cat([F.relu(mask), mask * 0.0, F.relu(-mask)], 1)
    bmask = (resize_nchw(dif, h) > gate).float()
    x_hole = x * (1.0 - bmask)
    x = torch.cat([x_hole, bmask, *shared(x_hole), uv_small], 1)
    for i in range(half, n_res):
        x = net.res_block(x, f"res.{i}")
    f = net.convt_block(x, "clr_up1")
    f = net.convt_block(f, "clr_up2")
    f = net.convt_block(f, "clr_up3")
    c = net.conv_block(torch.cat([gs, f], 1), "clr_conv1")
    c = net.conv_block(c, "clr_conv2")
    rgb = net.conv_block(c, "clr_conv3", norm=False, act=False)
    # the outputs in the egress precision, the shadow map taken there
    out = net.egress
    rgb = out(rgb.permute(0, 2, 3, 1))
    dif = out(out(gray(rgb)) - out(gray(out(img))))
    nhwc = [out(t.permute(0, 2, 3, 1)) for t in (gs, mask22)]
    return nhwc[0], rgb, nhwc[1], dif
