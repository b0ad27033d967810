"""Int8 convolution of the generators' output head (port of
`blindshadowremoval_tpu/ops/quant.py`).

Symmetric int8: per-output-channel weight scales, and one of three
activation scales:

  * a static scalar bound (`static_scale > 0`): scale bound / 127;
  * static per-input-channel bounds (a tuple, one per input channel): each
    channel quantizes against its own bound, and the bounds are folded into
    the weight before the weight's own quantization, so the product is
    still a plain int8 x int8 convolution;
  * the dynamic per-sample max (`static_scale <= 0`).

Codes round half to even (`torch.round`, as `jnp.round`) and clip to
+-127; the products accumulate in int32, dequantize in f32, and the bias
is added last, as in the JAX package.

ATen has no int8 convolution, and no float convolution of the codes is
exact in f32 or bf16 (the head's 7x7x64 taps of up to 127^2 each pass
2^24).  So the accumulation is `torch._int_mm` (int8 x int8 -> int32;
cuBLASLt on CUDA), one product per tap: the input is padded ("SAME") and
flattened to [B*Hp*Wp, C] rows, and a tap's shift (dy, dx) is the row
offset dy*Wp + dx into it, so no tap copies its input.  The stride-1
result on the padded grid is subsampled for a larger stride.  Channels
are padded with zeros to what `_int_mm` takes on CUDA: a reduction of a
multiple of 16 (which also keeps every row offset 16-byte aligned) and an
output of a multiple of 8.  `int8_accumulate_reference` gives the same
accumulators from an f64 convolution, where every product and sum of
int8 codes is exact.

Differentiable by a straight-through estimator: the backward is the float
convolution's gradient (JAX `_int8_conv_bwd`), so the head can train.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

_K_MULTIPLE = 16      # the reduction (input channels), padded
_N_MULTIPLE = 8       # the output channels, padded
_MIN_ROWS = 17        # _int_mm on CUDA takes more than 16 rows


def same_pad(size: int, k: int, stride: int) -> tuple[int, int]:
    """TF "SAME" (before, after) padding of one spatial axis."""
    total = max((math.ceil(size / stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """[B, C, H, W] padded "SAME" for a k x k conv at `stride`."""
    top, bottom = same_pad(x.shape[-2], k, stride)
    left, right = same_pad(x.shape[-1], k, stride)
    return F.pad(x, (left, right, top, bottom))


def quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[out, in, kh, kw] float kernel -> (int8 kernel, [out] f32 scales)."""
    w = w.float()
    scale = w.abs().amax(dim=(1, 2, 3)) / 127.0 + 1e-12
    wq = torch.clamp(torch.round(w / scale[:, None, None, None]), -127, 127)
    return wq.to(torch.int8), scale


def _quantize(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x), -127, 127).to(torch.int8)


@functools.lru_cache(maxsize=64)
def _f32_constant(value, device: torch.device) -> torch.Tensor:
    """`value` (a float or a tuple of them) as an f32 tensor on `device`,
    made once: a host-to-device copy of a fresh host tensor waits on the
    stream.  Made outside inference mode, so that autograd may save it."""
    with torch.inference_mode(False):
        return torch.tensor(value, dtype=torch.float32, device=device)


def quantize_activations(x: torch.Tensor, w: torch.Tensor,
                         static_scale: float | tuple = 0.0):
    """(int8 codes of x [B, C, H, W], int8 kernel, the f32 scale the int32
    accumulators are multiplied by, broadcastable to [B, out, 1, 1]) in
    the mode `static_scale` selects (see the module's docstring)."""
    xf = x.float()
    w = w.float()
    if isinstance(static_scale, tuple):
        if len(static_scale) != x.shape[1]:
            raise ValueError(
                f"per-channel static_scale has {len(static_scale)} entries "
                f"for {x.shape[1]} input channels")
        bounds = _f32_constant(static_scale, x.device)
        x_scale = (bounds / 127.0 + 1e-12)[None, :, None, None]
        xq = _quantize(xf / x_scale)
        # the per-channel activation scales folded into the kernel; the
        # per-output-channel weight quantization then absorbs them
        wq, w_scale = quantize_weight(w * x_scale)
        return xq, wq, w_scale[None, :, None, None]
    if static_scale > 0.0:
        # the scale is formed in f64 and rounded once, as jnp.asarray does
        x_scale = _f32_constant(static_scale / 127.0, x.device)
    else:   # <= 0: the dynamic per-sample max
        x_scale = xf.abs().amax(dim=(1, 2, 3), keepdim=True) / 127.0 + 1e-12
    xq = _quantize(xf / x_scale)
    wq, w_scale = quantize_weight(w)
    return xq, wq, x_scale * w_scale[None, :, None, None]


def int8_accumulate(xq: torch.Tensor, wq: torch.Tensor,
                    stride: int = 1) -> torch.Tensor:
    """int32 accumulators [B, out, Ho, Wo] of the "SAME" convolution of
    int8 codes xq [B, C, H, W] with the int8 kernel wq [out, C, kh, kw]:
    one `torch._int_mm` a tap over the padded rows (module docstring)."""
    b, c, _, _ = xq.shape
    o, _, kh, kw = wq.shape
    cp = -(-c // _K_MULTIPLE) * _K_MULTIPLE
    op = -(-o // _N_MULTIPLE) * _N_MULTIPLE
    x = pad_same(xq, kh, stride)
    hp, wp = x.shape[-2:]
    rows = F.pad(x.permute(0, 2, 3, 1), (0, cp - c)).reshape(-1, cp)
    span = (kh - 1) * wp + (kw - 1)
    m = max(rows.shape[0] - span, _MIN_ROWS)
    if rows.shape[0] < m + span:
        rows = F.pad(rows, (0, 0, 0, m + span - rows.shape[0]))
    # [kh, kw, out, C]: each tap's [out, C] block is contiguous, and its
    # transpose is the column-major [C, out] operand cuBLASLt takes
    taps = F.pad(wq, (0, 0, 0, 0, 0, cp - c, 0, op - o)).permute(
        2, 3, 0, 1).contiguous()
    acc = None
    for dy in range(kh):
        for dx in range(kw):
            off = dy * wp + dx
            part = torch._int_mm(rows[off:off + m], taps[dy, dx].t())
            acc = part if acc is None else acc.add_(part)
    n = b * hp * wp
    acc = F.pad(acc, (0, 0, 0, n - m)) if m < n else acc[:n]
    full = acc.reshape(b, hp, wp, op)[:, :hp - kh + 1:stride,
                                      :wp - kw + 1:stride, :o]
    return full.permute(0, 3, 1, 2)


def int8_accumulate_reference(xq: torch.Tensor, wq: torch.Tensor,
                              stride: int = 1) -> torch.Tensor:
    """`int8_accumulate`'s plain version: an f64 convolution of the codes,
    exact (each product is at most 127^2 and any sum of fewer than 2^39
    of them stays below 2^53)."""
    x = pad_same(xq.double(), wq.shape[-1], stride)
    return F.conv2d(x, wq.double(), stride=stride).to(torch.int32)


def float_conv(x: torch.Tensor, w: torch.Tensor,
               bias: torch.Tensor | None, stride: int = 1) -> torch.Tensor:
    """The f32 "SAME" convolution int8_conv approximates (JAX
    `_float_conv`): the straight-through backward's forward."""
    out = F.conv2d(pad_same(x.float(), w.shape[-1], stride), w.float(),
                   stride=stride)
    return out if bias is None else out + bias.float()[None, :, None, None]


def _int8_forward(x, w, bias, stride, static_scale) -> torch.Tensor:
    xq, wq, out_scale = quantize_activations(x, w, static_scale)
    out = int8_accumulate(xq, wq, stride).float() * out_scale
    return out if bias is None else out + bias.float()[None, :, None, None]


class _Int8Conv(torch.autograd.Function):
    """int8 forward, the float convolution's gradient backward."""

    @staticmethod
    def forward(ctx, x, w, bias, stride, static_scale):
        ctx.save_for_backward(x, w, bias)
        ctx.stride = stride
        return _int8_forward(x, w, bias, stride, static_scale)

    @staticmethod
    def backward(ctx, g):
        x, w, bias = ctx.saved_tensors
        leaves = [t.detach().requires_grad_() if t is not None else None
                  for t in (x, w, bias)]
        wanted = [t for t, need in zip(leaves, ctx.needs_input_grad[:3])
                  if need and t is not None]
        with torch.enable_grad():
            out = float_conv(*leaves, ctx.stride)
            grads = iter(torch.autograd.grad(out, wanted, g))
        return (*(next(grads) if need and t is not None else None
                  for t, need in zip(leaves, ctx.needs_input_grad[:3])),
                None, None)


def int8_conv(x: torch.Tensor, w: torch.Tensor,
              bias: torch.Tensor | None = None, stride: int = 1,
              static_scale: float | tuple = 0.0) -> torch.Tensor:
    """int8 "SAME" convolution of x [B, C, H, W] (any float dtype) with the
    float kernel w [out, C, kh, kw] (quantized per call) and an optional
    bias; f32 [B, out, Ho, Wo] out.  `static_scale` picks the activation
    scale (module docstring).  Gradients are the float convolution's."""
    return _Int8Conv.apply(x, w, bias, stride, static_scale)
