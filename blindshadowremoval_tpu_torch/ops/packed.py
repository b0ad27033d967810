"""Phase-packed (2x2 space-to-depth) forms of the decoder's convolutions
(port of `blindshadowremoval_tpu/ops/packed.py`).

STATUS: a measured negative result, kept as a tested utility and record;
no model uses it.  The idea: the generator's 256 px tail (the last
stride-2 transposed conv, its BatchNorm and LeakyReLU, and the 7x7 head
with 2 output channels) computed at 128 px with four times the channels,
the transposed conv's four output phases kept as channel groups (its
natural product) and the head a 5x5 conv to 8 channels, so no 256 px
tensor is materialized.  On the TPU the JAX package measured the packed
tail slower than the direct one (its docs/perf.md, "packed decoder tail";
tools/bench_packed_tail.py).  chip_smoke.py times the same segment both
ways on the GPU (PERF.md).

The rewrites are exact (tests/test_torch_packed.py holds them against
the JAX package's): a stride-2 ConvTranspose maps onto a small conv whose
output keeps the four output phases (p, q) in {0, 1}^2 as channel groups
at the input resolution, and any SAME odd-k conv over the full-resolution
image maps onto a conv over that packed layout.

Layout: NCHW, as the port's blocks; the packed layout is "phase-aligned":
channel (p*2+q)*C + c holds pixel [2i+p, 2j+q] of channel c, so
`unpack_image` is `models/blocks.py:d2s_unpack` (which differs from
`s2d_pack`, the packing of a padded image for its own kernel transform).
Kernels are in the port's layouts: a transposed conv's as
nn.ConvTranspose2d holds it [cin, cout, 3, 3], a conv's as nn.Conv2d
[cout, cin, k, k].

Derivations (1-D; 2-D is the tensor product).  ConvTranspose k=3 s=2 SAME
== input-dilated conv with pad (2, 1) of the kernel w as JAX applies it
(unflipped, [3, 3, cin, cout]).  With x_dil[2t] = x[t]:
  out[2i]   = x[i-1] w[0] + x[i] w[2]
  out[2i+1] = x[i]   w[1]
i.e. one 2-tap conv per phase over pad_low(x, 1).  SAME odd-k conv on the
packed layout: out[2i+p] = sum_u x[2i+p+u] w[u+r] (r = k//2); writing
2i+p+u = 2(i+d)+s maps each (p, s) phase pair to taps d = (u+p-s)/2, an
odd K = 2*((r+1)//2)+1-tap packed kernel (5 for k=7, 3 for k in {3, 5})
with structural zeros where u falls outside [-r, r].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pack_image(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, 4C, H/2, W/2] phase-aligned (inverse of
    unpack_image)."""
    b, c, h, w = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"pack_image needs an even H and W, got {(h, w)}")
    y = x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 3, 5, 1, 2, 4)
    return y.reshape(b, 4 * c, h // 2, w // 2)


def unpack_image(y: torch.Tensor, cout: int) -> torch.Tensor:
    """[B, 4C, H, W] -> [B, C, 2H, 2W] (the layout of
    models/blocks.py:d2s_unpack)."""
    b, _, h, w = y.shape
    x = y.reshape(b, 2, 2, cout, h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(b, cout, 2 * h, 2 * w)


def convt_packed_kernel(w: torch.Tensor) -> torch.Tensor:
    """nn.ConvTranspose2d's [cin, cout, 3, 3] stride-2 SAME kernel ->
    [4cout, cin, 2, 2] packed-conv kernel (apply with `convt_packed`)."""
    if tuple(w.shape[2:]) != (3, 3):
        raise ValueError(f"the stride-2 SAME packed form needs k=3, got "
                         f"{tuple(w.shape[2:])}")
    cin, cout = w.shape[:2]
    wj = w.flip(2, 3).permute(2, 3, 0, 1)    # JAX's [3, 3, cin, cout]
    # tap a, phase p: m(a=0,p=0)=w[0]; m(a=1,p=0)=w[2]; m(a=1,p=1)=w[1]
    rows = {(0, 0): 0, (1, 0): 2, (1, 1): 1}
    zero = torch.zeros_like(wj[0, 0])

    def sub(a, p, b, q):
        if (a, p) in rows and (b, q) in rows:
            return wj[rows[a, p], rows[b, q]]
        return zero

    # packed[a, b, cin, (p*2+q)*cout + co], HWIO -> OIHW
    packed = torch.stack([
        torch.stack([torch.cat([sub(a, p, b, q) for p in (0, 1)
                                for q in (0, 1)], dim=-1)
                     for b in (0, 1)])
        for a in (0, 1)])
    return packed.permute(3, 2, 0, 1).contiguous()


def convt_packed(x: torch.Tensor, packed_kernel: torch.Tensor) -> torch.Tensor:
    """[B, cin, H, W] x packed kernel -> [B, 4cout, H, W], the phase-packed
    transposed-conv output (== pack_image of the stride-2 SAME transposed
    conv), in x's dtype."""
    return F.conv2d(F.pad(x, (1, 0, 1, 0)), packed_kernel.to(x.dtype))


def conv_same_packed_kernel(w: torch.Tensor) -> torch.Tensor:
    """nn.Conv2d's [cout, cin, k, k] SAME stride-1 odd-k kernel -> [4cout,
    4cin, K, K] packed-conv kernel over the phase-aligned layout,
    K = 2*((k//2+1)//2)+1."""
    cout, cin, k, _ = w.shape
    if k % 2 != 1:
        raise ValueError(f"conv_same_packed_kernel needs an odd k, got {k}")
    r = k // 2
    kk = 2 * ((r + 1) // 2) + 1
    d = torch.arange(kk, device=w.device) - kk // 2             # packed tap
    ps = torch.arange(2, device=w.device)
    # index grid [d, s, p] -> u + r (clipped), validity mask
    u = 2 * d[:, None, None] + ps[None, :, None] - ps[None, None, :]
    valid = (u.abs() <= r).to(w.dtype)
    ui = (u + r).clamp(0, k - 1)
    wj = w.permute(2, 3, 1, 0)                                    # HWIO
    # w1[d, s, p, l, ci, co] = w[u+r, l] masked
    w1 = wj[ui] * valid[..., None, None, None]
    w2 = w1[:, :, :, ui] * valid[None, None, None, ..., None, None]
    # [d, s, p, e, t, q, ci, co] -> [(p, q, co), (s, t, ci), d, e]
    return w2.permute(2, 5, 7, 1, 4, 6, 0, 3).reshape(
        4 * cout, 4 * cin, kk, kk)


def conv_same_packed(xp: torch.Tensor,
                     packed_kernel: torch.Tensor) -> torch.Tensor:
    """Packed [B, 4cin, H, W] x packed kernel [4cout, 4cin, K, K] -> packed
    [B, 4cout, H, W]; equals pack_image of the SAME conv of the unpacked
    image.  K is odd with symmetric support, so padding is SAME."""
    kk = packed_kernel.shape[-1]
    return F.conv2d(xp, packed_kernel.to(xp.dtype), padding=kk // 2)


def conv1x1_packed(xp: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Packed [B, 4cin, H, W] x nn.Conv2d's [cout, cin, 1, 1] -> packed
    [B, 4cout, H, W]: a 1x1 conv acts per phase, a grouped conv."""
    return F.conv2d(xp, torch.cat([w] * 4).to(xp.dtype), groups=4)


def tile_phase(v: torch.Tensor) -> torch.Tensor:
    """Per-channel vector [C] -> packed-channel vector [4C]."""
    return v.repeat(4)


def concat_packed(a: torch.Tensor, ca: int, b: torch.Tensor,
                  cb: int) -> torch.Tensor:
    """Channel-concat two packed tensors: packed channels interleave as
    (phase, channel), so the concat happens inside each phase group."""
    if a.shape[0] != b.shape[0] or a.shape[2:] != b.shape[2:]:
        raise ValueError(f"packed shapes differ: {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    n, _, h, w = a.shape
    return torch.cat([a.reshape(n, 4, ca, h, w), b.reshape(n, 4, cb, h, w)],
                     dim=2).reshape(n, 4 * (ca + cb), h, w)
