"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card.

Every test here needs an NVIDIA GPU (marker `cuda`) and skips without one.
This file imports torch and the port only, so it runs on a machine without
JAX:  python -m pytest --noconftest tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from blindshadowremoval_tpu_torch.ops.nonlocal_attn import (
    KERNEL_TOLERANCE,
    nonlocal_attention,
    nonlocal_attention_reference,
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernel runs only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d,dtype", [
    (2, 1024, 128, torch.bfloat16),
    (2, 200, 128, torch.bfloat16),
    (2, 1024, 256, torch.bfloat16),
    (2, 1024, 128, torch.float32),
    (2, 77, 256, torch.float32),
])
def test_kernel_matches_plain_on_card(cuda_device, b, n, d, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    t, p, g = (0.3 * torch.randn(b, n, d, generator=gen, device=cuda_device)
               for _ in range(3))
    t, p, g = t.to(dtype), p.to(dtype), g.to(dtype)
    before = nonlocal_attention.launches
    with torch.no_grad():
        out = nonlocal_attention(t, p, g)
        torch.cuda.synchronize()
        ref = nonlocal_attention_reference(t, p, g)
    assert nonlocal_attention.launches == before + 1
    # KERNEL_TOLERANCE says why these limits (ops/nonlocal_attn.py)
    atol, rtol = KERNEL_TOLERANCE[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
def test_kernel_rejects_misaligned_view(cuda_device):
    # contiguous, but one element past a 16-byte boundary: the kernel's
    # vector loads would fault, so the wrapper refuses it before launching
    flat = torch.zeros(2 * 64 * 128 + 1, dtype=torch.bfloat16,
                       device=cuda_device)
    t = flat[1:].view(2, 64, 128)
    assert t.is_contiguous()
    before = nonlocal_attention.launches
    with pytest.raises(ValueError, match="aligned"):
        nonlocal_attention(t, t, t)
    assert nonlocal_attention.launches == before
