"""NonLocal attention, out = softmax(theta . phi^T) . g over [B, N, D].

Port of `blindshadowremoval_tpu/ops/pallas/nonlocal_attn.py`.  Its two TPU
kernels become hand-written Hopper kernels: the forward `_attn_kernel` in
`csrc/nonlocal_attn.cu` (K1) and the backward `_attn_bwd_kernel` in
`csrc/nonlocal_attn_bwd.cu` (K2); each source's header says what bounds it
and how the design answers that.  `nonlocal_attention_reference` and
`nonlocal_attention_bwd_reference` are their plain PyTorch versions.

Each kernel is an op of the `bsr` namespace (`torch.ops.bsr.nonlocal_attn`,
`nonlocal_attn_lse`, `nonlocal_attn_bwd`) with a CPU and a CUDA
implementation, so the dispatcher routes by where the tensors live, and by
nothing else: CPU tensors take the plain versions, CUDA tensors launch the
kernels or raise.  There is no fallback from a kernel to its plain
version.  Dispatch modes see one op per call whatever runs inside it, and
each op carries its FLOP formula (`torch.utils.flop_counter`), so a count
is the same on both routes although the kernels launch through ctypes,
which no mode sees.  With autograd recording, `nonlocal_attention` is one
`torch.autograd.Function` on both devices: the forward also returns the
row logsumexp, and the backward launches K2 on the card.  `PlainRoute`
runs the ops as their plain versions op by op on any device.
"""

from __future__ import annotations

import ctypes

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import register_flop_formula

from blindshadowremoval_tpu_torch.ops import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
SUPPORTED_D = (128, 256)

# How far a kernel may lie from its plain version, as (atol, rtol) in
# |out - ref| <= atol + rtol * |ref|, checked per output tensor.
#
# K1, bf16: both round each output once to bf16, at most one ulp (2^-7 of
# |ref|) apart, after rounding their weights at different points (the
# kernel exp(s - running max), the plain version the normalized weights),
# which moves the f32 result by up to ~4e-4 at N <= 1024, D <= 256 with
# unit-variance scores.  f32: the kernel's products are 3xTF32 on the
# tensor cores (csrc/hopper.cuh), each within ~2^-22 of the f32 product,
# and their sums run in another order; a CPU emulation
# (tests/test_torch_nonlocal_attn.py, numpy seed 0) gives max(err - 1e-5
# |ref|) of at most 5.3e-7 over the f32 shapes the main paths launch and
# ragged N, one TF32 pass 4.7e-5 to 4.8e-4, and 3xTF32 without small.big
# 2.6e-5 to 3.1e-4.  The tensor cores' own sums (truncated, not rounded)
# are the kernel's to keep within this: csrc/hopper.cuh says how.
KERNEL_TOLERANCE = {torch.bfloat16: (8e-4, 2.0 ** -7),
                    torch.float32: (1e-6, 1e-5)}
# K2: per gradient tensor, |grad - ref| <= share * max|ref| + rtol * |ref|,
# with (share, rtol) = KERNEL_BWD_TOLERANCE[dtype] and max|ref| taken no
# lower than BWD_SCALE_FLOOR (bwd_tolerance below gives the atol).  bf16:
# the plain backward keeps W and dS in f32, as the TPU kernel does; K2
# rounds P = exp(S - lse) to bf16 as the operand of dg = P^T dO, and dS to
# bf16 as the operand of dtheta = dS phi and dphi = dS^T theta, takes
# Delta = rowsum(dO o O) from the bf16 forward output and sums dtheta in
# f32 across key blocks in no fixed order; each gradient is then rounded
# once to bf16 (2^-7 of |ref|).  Those roundings grow with the gradients'
# size, which shrinks with N (max |ref| ~2.3-3 at N = 64, ~0.7 at N = 1024),
# hence an atol in proportion to it.  With operands of 0.3 randn
# (unit-variance scores at D = 128) and dO of randn, as chip_smoke.py and
# the card tests use, a CPU emulation of those roundings
# (tests/test_torch_nonlocal_attn.py, numpy seed 0) gives
# max(err - 2^-7 |ref|) / max|ref| of at most 1.01e-3 at (8, 1024, 128),
# 1.08e-3 at N = 200, 1.04e-3 at (4, 1024, 256), 1.89e-3 at
# (300, 64, 128) and 1.98e-3 at N = 65, 127, 129.  A Delta off by 3%
# gives 5.4e-3 at (8, 1024, 128), 9.7e-3 at (4, 1024, 256) and 2.0e-2 at
# (300, 64, 128) in dtheta or dphi; P and dS rounded to fp8 give 3.3e-2 or
# more at each of those three shapes.  The floor keeps
# a gradient that is zero in exact arithmetic (dtheta and dphi at N = 1)
# to a small atol rather than to exact zero.  f32: five 3xTF32 products,
# summation order and the exp of the saved logsumexp; the emulation gives
# at most 1.45e-6 of max|ref| (at (4, 1024, 256)), one TF32 pass or
# 3xTF32 without small.big 4.1e-4 to 1.0e-3.
KERNEL_BWD_TOLERANCE = {torch.bfloat16: (3e-3, 2.0 ** -7),
                        torch.float32: (1e-5, 1e-5)}
BWD_SCALE_FLOOR = 2.0 ** -4


def bwd_tolerance(ref: torch.Tensor, dtype: torch.dtype):
    """(atol, rtol) that K2's gradient must meet against the plain
    backward's `ref` of the same gradient, for kernel dtype `dtype`."""
    share, rtol = KERNEL_BWD_TOLERANCE[dtype]
    scale = max(ref.float().abs().max().item(), BWD_SCALE_FLOOR)
    return share * scale, rtol


def _weighted(scores: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    w = torch.softmax(scores, dim=-1).to(g.dtype)
    return torch.matmul(w.float(), g.float()).to(g.dtype)


def nonlocal_attention_reference(theta: torch.Tensor, phi: torch.Tensor,
                                 g: torch.Tensor) -> torch.Tensor:
    """Plain forward: f32 scores and softmax, weights cast to g's dtype,
    second product accumulated in f32 and cast back (the TPU kernel's
    numerics).  No 1/sqrt(D) scale."""
    return _weighted(torch.matmul(theta.float(), phi.float().transpose(1, 2)),
                     g)


def nonlocal_attention_lse_reference(theta: torch.Tensor, phi: torch.Tensor,
                                     g: torch.Tensor):
    """The plain forward and the f32 row logsumexp [B, N] of its scores."""
    scores = torch.matmul(theta.float(), phi.float().transpose(1, 2))
    return _weighted(scores, g), torch.logsumexp(scores, dim=-1)


def nonlocal_attention_bwd_reference(theta: torch.Tensor, phi: torch.Tensor,
                                     g: torch.Tensor, dout: torch.Tensor):
    """Plain backward (the JAX package's `_attention_bwd_xla`, :167-178,
    with f32 scores as its TPU kernel takes them): recompute
    W = softmax(theta phi^T), then dW = dO g^T, dg = W^T dO,
    dS = W o (dW - rowsum(dW o W)), dtheta = dS phi, dphi = dS^T theta, all
    in f32.  Each cotangent takes its own primal's dtype."""
    t32, p32, g32 = theta.float(), phi.float(), g.float()
    w = torch.softmax(torch.matmul(t32, p32.transpose(1, 2)), dim=-1)
    do32 = dout.float()
    dw = torch.matmul(do32, g32.transpose(1, 2))
    dg = torch.matmul(w.transpose(1, 2), do32)
    ds = w * (dw - (dw * w).sum(dim=-1, keepdim=True))
    dtheta = torch.matmul(ds, p32)
    dphi = torch.matmul(ds.transpose(1, 2), t32)
    return dtheta.to(theta.dtype), dphi.to(phi.dtype), dg.to(g.dtype)


_LIB = torch.library.Library("bsr", "DEF")
_LIB.define("nonlocal_attn(Tensor theta, Tensor phi, Tensor g) -> Tensor")
_LIB.define("nonlocal_attn_lse(Tensor theta, Tensor phi, Tensor g) "
            "-> (Tensor, Tensor)")
_LIB.define("nonlocal_attn_bwd(Tensor theta, Tensor phi, Tensor g, "
            "Tensor out, Tensor lse, Tensor dout) -> (Tensor, Tensor, Tensor)")
_LIB.impl("nonlocal_attn",
          lambda theta, phi, g: nonlocal_attention_reference(theta, phi, g),
          "CPU")
_LIB.impl("nonlocal_attn",
          lambda theta, phi, g: _launch_fwd(theta, phi, g, False)[0], "CUDA")
_LIB.impl("nonlocal_attn_lse",
          lambda theta, phi, g: nonlocal_attention_lse_reference(
              theta, phi, g), "CPU")
_LIB.impl("nonlocal_attn_lse",
          lambda theta, phi, g: _launch_fwd(theta, phi, g, True), "CUDA")
_LIB.impl("nonlocal_attn_bwd",
          lambda theta, phi, g, out, lse, dout:
          nonlocal_attention_bwd_reference(theta, phi, g, dout), "CPU")
_LIB.impl("nonlocal_attn_bwd",
          lambda theta, phi, g, out, lse, dout: nonlocal_attention_bwd(
              theta, phi, g, out, lse, dout.contiguous()), "CUDA")


@register_flop_formula([torch.ops.bsr.nonlocal_attn,
                        torch.ops.bsr.nonlocal_attn_lse])
def _fwd_flops(theta_shape, phi_shape, g_shape, *args, **kwargs) -> int:
    """theta phi^T and W g: 2*B*N*M*(D + Dg)."""
    b, n, d = theta_shape
    return 2 * b * n * phi_shape[1] * (d + g_shape[2])


@register_flop_formula(torch.ops.bsr.nonlocal_attn_bwd)
def _bwd_flops(theta_shape, phi_shape, g_shape, *args, **kwargs) -> int:
    """The recomputed scores, dW = dO g^T, dg = W^T dO, dtheta = dS phi and
    dphi = dS^T theta: 2*B*N*M*(3*D + 2*Dg)."""
    b, n, d = theta_shape
    return 2 * b * n * phi_shape[1] * (3 * d + 2 * g_shape[2])


class _NonLocalAttention(torch.autograd.Function):
    """Forward K1 (with the row logsumexp) and backward K2 on the card;
    the plain forward and plain backward on the CPU."""

    @staticmethod
    def forward(ctx, theta, phi, g):
        out, lse = torch.ops.bsr.nonlocal_attn_lse(theta, phi, g)
        ctx.save_for_backward(theta, phi, g, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        return torch.ops.bsr.nonlocal_attn_bwd(*ctx.saved_tensors, dout)


def nonlocal_attention(theta: torch.Tensor, phi: torch.Tensor,
                       g: torch.Tensor) -> torch.Tensor:
    """softmax(theta . phi^T) . g.  CPU tensors: the plain version.  CUDA
    tensors: K1, which takes contiguous, 16-byte aligned [B, N, D] bf16 or
    f32 tensors on one device with D in {128, 256}, and raises on anything
    else.  Differentiable on both: the backward is K2 on the card."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (theta, phi, g)):
        return _NonLocalAttention.apply(theta, phi, g)
    return torch.ops.bsr.nonlocal_attn(theta, phi, g)


# kernel launches made by this process; tests and chip_smoke.py reset them
nonlocal_attention.launches = 0


class PlainRoute(TorchDispatchMode):
    """Inside, the attention ops run as their plain versions, op by op, on
    whatever device the tensors lie, where the dispatch modes entered
    before this one (a FlopCounterMode) see each product."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        plain = {torch.ops.bsr.nonlocal_attn: nonlocal_attention_reference,
                 torch.ops.bsr.nonlocal_attn_lse:
                     nonlocal_attention_lse_reference,
                 torch.ops.bsr.nonlocal_attn_bwd:
                     lambda theta, phi, g, out, lse, dout:
                     nonlocal_attention_bwd_reference(theta, phi, g, dout),
                 }.get(func.overloadpacket, func)
        return plain(*args, **(kwargs or {}))


def _check(name: str, tensors: dict) -> tuple[int, int, int]:
    """The kernels' contract; raises on anything they cannot take.
    Returns (B, N, D)."""
    first = next(iter(tensors.values()))
    dev, dtype, shape = first.device, first.dtype, first.shape
    if dev.type != "cuda" or any(t.device != dev for t in tensors.values()):
        raise ValueError(f"{name}: {', '.join(tensors)} must lie on one CUDA "
                         f"device, got "
                         f"{[str(t.device) for t in tensors.values()]}")
    if dtype not in _DTYPE_CODE or any(t.dtype != dtype
                                       for t in tensors.values()):
        raise TypeError(f"{name}: the kernel takes bf16 or f32, all alike; "
                        f"got {[str(t.dtype) for t in tensors.values()]}")
    if len(shape) != 3 or any(t.shape != shape for t in tensors.values()):
        raise ValueError(f"{name}: the kernel takes [B,N,D] tensors of one "
                         f"shape; got "
                         f"{[tuple(t.shape) for t in tensors.values()]}")
    b, n, d = shape
    if d not in SUPPORTED_D:
        raise ValueError(f"{name}: D={d} is not one of {SUPPORTED_D}")
    if not all(t.is_contiguous() for t in tensors.values()):
        raise ValueError(f"{name}: the kernel takes contiguous tensors")
    # the kernels load 16-byte vectors: a view at an odd storage offset
    # would fault asynchronously, after the launch reported success
    if any(t.data_ptr() % 16 for t in tensors.values()):
        raise ValueError(f"{name}: the kernel takes tensors whose data is "
                         "16-byte aligned")
    return b, n, d


def _launch_fwd(theta: torch.Tensor, phi: torch.Tensor, g: torch.Tensor,
                with_lse: bool):
    """K1.  Returns (out, lse): lse is the f32 row logsumexp [B, N] that K2
    takes, written only when `with_lse`; else None."""
    b, n, d = _check("nonlocal_attention",
                     {"theta": theta, "phi": phi, "g": g})
    lib = _build.load("nonlocal_attn")
    fn = lib.bsr_nonlocal_attn_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    size = lib.bsr_nonlocal_attn_fwd_workspace
    size.argtypes = [ctypes.c_int] * 4
    size.restype = ctypes.c_longlong
    out = torch.empty_like(theta)
    lse = (torch.empty((b, n), dtype=torch.float32, device=theta.device)
           if with_lse else None)
    with torch.cuda.device(theta.device):
        # f32 scratch for a split over keys when the grid is small (the
        # size is the card's to say: it counts its SMs); none otherwise
        floats = size(b, n, d, _DTYPE_CODE[theta.dtype])
        work = (torch.empty(floats, dtype=torch.float32, device=theta.device)
                if floats else None)
        stream = torch.cuda.current_stream(theta.device).cuda_stream
        err = fn(theta.data_ptr(), phi.data_ptr(), g.data_ptr(),
                 out.data_ptr(), lse.data_ptr() if with_lse else None,
                 work.data_ptr() if floats else None,
                 b, n, d, _DTYPE_CODE[theta.dtype], stream)
    _build.raise_on_error(err, lib, "nonlocal_attention")
    nonlocal_attention.launches += 1
    return out, lse


def nonlocal_attention_bwd(theta: torch.Tensor, phi: torch.Tensor,
                           g: torch.Tensor, out: torch.Tensor,
                           lse: torch.Tensor, dout: torch.Tensor):
    """K2: (dtheta, dphi, dg) of out = softmax(theta phi^T) g, from K1's
    output and its row logsumexp `lse` [B, N] f32.  Same contract as K1,
    with dout and out alike to theta; raises on anything else."""
    b, n, d = _check("nonlocal_attention_bwd",
                     {"theta": theta, "phi": phi, "g": g, "out": out,
                      "dout": dout})
    if (lse.device != theta.device or lse.dtype != torch.float32
            or tuple(lse.shape) != (b, n) or not lse.is_contiguous()):
        raise ValueError("nonlocal_attention_bwd: lse must be a contiguous "
                         f"f32 [B, N] tensor on {theta.device}")
    lib = _build.load("nonlocal_attn_bwd")
    fn = lib.bsr_nonlocal_attn_bwd
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    size = lib.bsr_nonlocal_attn_bwd_workspace
    size.argtypes = [ctypes.c_int] * 4
    size.restype = ctypes.c_longlong
    dtheta, dphi, dg = (torch.empty_like(theta), torch.empty_like(phi),
                        torch.empty_like(g))
    # the kernel's f32 scratch (bf16: dtheta's f32 sums and the padded lse
    # and Delta; f32: each key block's partial dtheta, none when one block
    # holds every key); it initialises what it reads
    workspace = torch.empty(size(b, n, d, _DTYPE_CODE[theta.dtype]),
                            dtype=torch.float32, device=theta.device)
    with torch.cuda.device(theta.device):
        stream = torch.cuda.current_stream(theta.device).cuda_stream
        err = fn(theta.data_ptr(), phi.data_ptr(), g.data_ptr(),
                 out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                 workspace.data_ptr(), dtheta.data_ptr(), dphi.data_ptr(),
                 dg.data_ptr(), b, n, d, _DTYPE_CODE[theta.dtype], stream)
    _build.raise_on_error(err, lib, "nonlocal_attention_bwd")
    nonlocal_attention_bwd.launches += 1
    return dtheta, dphi, dg


nonlocal_attention_bwd.launches = 0
