"""Bilinear resize with TF semantics, and dense bilinear warping (port of
`blindshadowremoval_tpu/geometry/warp.py`).

`tf.image.resize(bilinear)`, which the reference uses everywhere, samples
at half-pixel centres with edge clamping and does not blur on downsample.
As in the JAX package the resample is two products with static [out, in]
interpolation matrices (out = A_h . x . A_w^T): the taps are placed in
float64 on the host, the weights are float32, and the matrix is cast to the
input's dtype.  Its backward is two more products, which the gradient loss
runs at five scales.

A warp (`batch_map_offsets`, the TSM ShareLayer's) samples at clamped
coordinates with a four-corner gather: channel 0 of a normalized offset
field is the row delta, channel 1 the column delta, in fractions of the
side.  The gathers index a flattened [B, H*W, C] (`torch.gather`); their
backward is a scatter-add, atomic on the card, so a warp's input gradient
varies from run to run there within f32 rounding.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def _interp_matrix(out_size: int, in_size: int) -> np.ndarray:
    """[out, in] bilinear interpolation matrix: half-pixel centres, edge
    clamp, floor/ceil corners (warp.py:28-42, value for value)."""
    pos = (np.arange(out_size, dtype=np.float64) + 0.5) * (
        in_size / out_size) - 0.5
    pos = np.clip(pos, 0.0, in_size - 1.0)
    lo = np.floor(pos).astype(np.int64)
    hi = np.ceil(pos).astype(np.int64)
    f = (pos - lo).astype(np.float32)
    a = np.zeros((out_size, in_size), np.float32)
    a[np.arange(out_size), lo] += 1.0 - f
    a[np.arange(out_size), hi] += f
    return a


@functools.lru_cache(maxsize=256)
def _matrix(out_size: int, in_size: int, dtype: torch.dtype,
            device: torch.device) -> torch.Tensor:
    # cached across calls, so never an inference tensor: a first call under
    # torch.inference_mode must not stop later calls from saving it for
    # backward
    with torch.inference_mode(False):
        return torch.from_numpy(_interp_matrix(out_size, in_size)).to(
            device=device, dtype=dtype)


def resize_bilinear_nchw(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """[B, C, H, W] -> [B, C, *size], in x's memory format, as F.interpolate
    keeps it: a channels-last input (an NHWC tensor seen through a permute)
    is resized in NHWC without a copy, and the convolutions around it do not
    transpose."""
    if not x.is_contiguous() and x.is_contiguous(
            memory_format=torch.channels_last):
        return resize_bilinear(x.permute(0, 2, 3, 1), size).permute(0, 3, 1, 2)
    h, w = x.shape[-2:]
    oh, ow = size
    if (h, w) == (oh, ow):
        return x
    a_h = _matrix(oh, h, x.dtype, x.device)
    a_w = _matrix(ow, w, x.dtype, x.device)
    return torch.matmul(torch.matmul(a_h, x), a_w.t())


def resize_bilinear(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """[..., H, W, C] -> [..., *size, C] (the JAX package's NHWC layout),
    the H product first, as the JAX package orders them."""
    *lead, h, w, c = x.shape
    oh, ow = size
    if (h, w) == (oh, ow):
        return x
    a_h = _matrix(oh, h, x.dtype, x.device)
    a_w = _matrix(ow, w, x.dtype, x.device)
    xb = x.reshape(-1, h, w * c)
    y = torch.matmul(a_h, xb).reshape(-1, oh, w, c)          # [b, O, w, c]
    y = torch.matmul(a_w, y)                                  # [b, O, P, c]
    return y.reshape(*lead, oh, ow, c)


def _bilinear_gather(x: torch.Tensor, rows: torch.Tensor,
                     cols: torch.Tensor) -> torch.Tensor:
    """Sample x [B,H,W,C] at fractional (rows, cols) [B,N] -> [B,N,C]
    (warp.py:76-107): the coordinates are clamped first and the corners
    are floor/ceil of the clamped values, so an integer coordinate samples
    exactly.  The lerp weights keep the coordinates' dtype."""
    b, h, w, c = x.shape
    rows = rows.clamp(0.0, h - 1.0)
    cols = cols.clamp(0.0, w - 1.0)
    r0, c0 = rows.floor(), cols.floor()
    r1, c1 = rows.ceil(), cols.ceil()
    fr = (rows - r0)[..., None]
    fc = (cols - c0)[..., None]
    flat = x.reshape(b, h * w, c)

    def take(ri, ci):
        idx = (ri.long() * w + ci.long())[..., None].expand(-1, -1, c)
        return torch.gather(flat, 1, idx)

    v00, v01 = take(r0, c0), take(r0, c1)
    v10, v11 = take(r1, c0), take(r1, c1)
    top = v00 + (v10 - v00) * fr
    bot = v01 + (v11 - v01) * fr
    return top + (bot - top) * fc


def batch_map_coordinates(x: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear sample x [B,H,W,C] at absolute coords [B,N,2] (row, col)
    -> [B,N,C] (warp.py:110-117)."""
    return _bilinear_gather(x, coords[..., 0], coords[..., 1])


def batch_map_offsets(x: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Warp x [B,S,S,C] by a normalized offset field [B,s,s,>=2] ->
    [B,S,S,C] (warp.py:120-141): the field is resized to S (bilinear, TF
    semantics), scaled by S and added to the identity grid; only its first
    two channels are read."""
    b, s = x.shape[:2]
    off = offsets[..., :2]
    if off.shape[1:3] != (s, s):
        off = resize_bilinear(off, (s, s))
    off = off * s
    grid = torch.arange(s, dtype=torch.float32, device=x.device)
    rows = (off[..., 0] + grid[:, None]).reshape(b, s * s)
    cols = (off[..., 1] + grid[None, :]).reshape(b, s * s)
    return _bilinear_gather(x, rows, cols).reshape(b, s, s, x.shape[-1])
