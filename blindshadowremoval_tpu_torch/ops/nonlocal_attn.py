"""NonLocal attention, out = softmax(theta . phi^T) . g over [B, N, D].

Port of `blindshadowremoval_tpu/ops/pallas/nonlocal_attn.py`.  The TPU
kernel `_attn_kernel` becomes the hand-written Hopper kernel in
`csrc/nonlocal_attn.cu` (its header says what bounds it and how the design
answers that); `nonlocal_attention_reference` is its plain PyTorch version.

Dispatch is by where the tensors live, and nothing else: CPU tensors take
the plain version, CUDA tensors launch the kernel or raise.  There is no
fallback from the kernel to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from blindshadowremoval_tpu_torch.ops import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
SUPPORTED_D = (128, 256)

# How far the kernel may lie from the plain version, as (atol, rtol) in
# |out - ref| <= atol + rtol * |ref|.  bf16: both round each output once to
# bf16, at most one ulp (2^-7 of |ref|) apart, after rounding their weights
# at different points (the kernel exp(s - running max), the plain version
# the normalized weights), which moves the f32 result by up to ~4e-4 at
# N <= 1024, D <= 256 with unit-variance scores.  f32: summation order only.
KERNEL_TOLERANCE = {torch.bfloat16: (8e-4, 2.0 ** -7),
                    torch.float32: (1e-6, 1e-5)}


def nonlocal_attention_reference(theta: torch.Tensor, phi: torch.Tensor,
                                 g: torch.Tensor) -> torch.Tensor:
    """Plain version: f32 scores and softmax, weights cast to g's dtype,
    second product accumulated in f32 and cast back (the TPU kernel's
    numerics).  No 1/sqrt(D) scale."""
    scores = torch.matmul(theta.float(), phi.float().transpose(1, 2))
    w = torch.softmax(scores, dim=-1).to(g.dtype)
    return torch.matmul(w.float(), g.float()).to(g.dtype)


def nonlocal_attention(theta: torch.Tensor, phi: torch.Tensor,
                       g: torch.Tensor) -> torch.Tensor:
    """softmax(theta . phi^T) . g.  CPU tensors: the plain version.  CUDA
    tensors: the Hopper kernel, which takes contiguous, 16-byte aligned
    [B, N, D] bf16 or f32 tensors on one device with D in {128, 256}, and
    raises on anything else."""
    if all(t.device.type == "cpu" for t in (theta, phi, g)):
        return nonlocal_attention_reference(theta, phi, g)
    return _launch(theta, phi, g)


# kernel launches made by this process; tests and chip_smoke.py reset it
nonlocal_attention.launches = 0


def _library() -> ctypes.CDLL:
    lib = _build.load("nonlocal_attn")
    fn = lib.bsr_nonlocal_attn_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.bsr_cuda_error_string.argtypes = [ctypes.c_int]
    lib.bsr_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch(theta: torch.Tensor, phi: torch.Tensor,
            g: torch.Tensor) -> torch.Tensor:
    dev = theta.device
    if dev.type != "cuda" or phi.device != dev or g.device != dev:
        raise ValueError("nonlocal_attention: theta, phi and g must lie on "
                         f"one CUDA device, got {theta.device}, {phi.device}, "
                         f"{g.device}")
    if theta.dtype not in _DTYPE_CODE or not (
            theta.dtype == phi.dtype == g.dtype):
        raise TypeError("nonlocal_attention: the kernel takes bf16 or f32, "
                        f"all alike; got {theta.dtype}, {phi.dtype}, "
                        f"{g.dtype}")
    if theta.dim() != 3 or not (theta.shape == phi.shape == g.shape):
        raise ValueError("nonlocal_attention: the kernel takes three [B,N,D] "
                         f"tensors of one shape; got {tuple(theta.shape)}, "
                         f"{tuple(phi.shape)}, {tuple(g.shape)}")
    b, n, d = theta.shape
    if d not in SUPPORTED_D:
        raise ValueError(f"nonlocal_attention: D={d} is not one of "
                         f"{SUPPORTED_D}")
    if not (theta.is_contiguous() and phi.is_contiguous()
            and g.is_contiguous()):
        raise ValueError("nonlocal_attention: the kernel takes contiguous "
                         "tensors")
    # the kernel loads 16-byte vectors: a view at an odd storage offset
    # would fault asynchronously, after the launch reported success
    if any(t.data_ptr() % 16 for t in (theta, phi, g)):
        raise ValueError("nonlocal_attention: the kernel takes tensors whose "
                         "data is 16-byte aligned")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (theta, phi, g)):
        raise NotImplementedError(
            "nonlocal_attention: the backward kernel (K2) is not ported yet "
            "(ROADMAP slice C); run the forward under torch.no_grad()")
    lib = _library()
    out = torch.empty_like(theta)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.bsr_nonlocal_attn_fwd(
            theta.data_ptr(), phi.data_ptr(), g.data_ptr(), out.data_ptr(),
            b, n, d, _DTYPE_CODE[theta.dtype], stream)
    if err != 0:
        raise RuntimeError("nonlocal_attention: kernel launch failed: "
                           + lib.bsr_cuda_error_string(err).decode())
    nonlocal_attention.launches += 1
    return out
