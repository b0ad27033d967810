"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card.

Every test here needs an NVIDIA GPU (marker `cuda`) and skips without one.
This file imports torch and the port only, so it runs on a machine without
JAX:  python -m pytest --noconftest tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from blindshadowremoval_tpu_torch.ops.nonlocal_attn import (
    KERNEL_BWD_TOLERANCE,
    KERNEL_TOLERANCE,
    nonlocal_attention,
    nonlocal_attention_bwd,
    nonlocal_attention_bwd_reference,
    nonlocal_attention_reference,
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernel runs only there")
    return torch.device("cuda")


# K1's cases: the main path's widths, ragged tails of the 128- and 64-key
# tiles, a single row (N=1), one row past a tile (N=129), and 300 batch
# elements of one partial query tile each (N=64)
FWD_CASES = [
    (2, 1024, 128, torch.bfloat16),
    (2, 200, 128, torch.bfloat16),
    (2, 1024, 256, torch.bfloat16),
    (2, 1024, 128, torch.float32),
    (2, 77, 256, torch.float32),
    (2, 1, 128, torch.bfloat16),
    (2, 129, 128, torch.bfloat16),
    (2, 1000, 256, torch.bfloat16),
    (300, 64, 128, torch.bfloat16),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d,dtype", FWD_CASES)
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
def test_kernel_keeps_batch_elements_apart(cuda_device):
    # batch element 1 is 50 randn, its neighbours 0.3 randn: keys of one
    # element leaking into another's softmax (an unmasked ragged tile read
    # past row N), or rows stored past N, would move the whole output far
    # outside the tolerance
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    t, p, g = (0.3 * torch.randn(3, 200, 128, generator=gen,
                                 device=cuda_device) for _ in range(3))
    for x in (t, p, g):
        x[1] = 50 * torch.randn(200, 128, generator=gen, device=cuda_device)
    t, p, g = t.bfloat16(), p.bfloat16(), g.bfloat16()
    with torch.no_grad():
        out = nonlocal_attention(t, p, g)
        torch.cuda.synchronize()
        ref = nonlocal_attention_reference(t, p, g)
    atol, rtol = KERNEL_TOLERANCE[torch.bfloat16]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    # K2 on K1's outputs: elements 0 and 2 must not see element 1 either
    # (element 1's scores of ~1e5 lie outside KERNEL_BWD_TOLERANCE's
    # derivation, so it is left out of the comparison)
    from blindshadowremoval_tpu_torch.ops.nonlocal_attn import _launch_fwd

    do = torch.randn(3, 200, 128, generator=gen, device=cuda_device).bfloat16()
    out, lse = _launch_fwd(t, p, g, with_lse=True)
    grads = nonlocal_attention_bwd(t, p, g, out, lse, do)
    torch.cuda.synchronize()
    keep = [0, 2]
    ref = nonlocal_attention_bwd_reference(t[keep], p[keep], g[keep], do[keep])
    atol, rtol = KERNEL_BWD_TOLERANCE[torch.bfloat16]
    for name, a, r in zip(("dtheta", "dphi", "dg"), grads, ref):
        torch.testing.assert_close(a[keep].float(), r.float(), atol=atol,
                                   rtol=rtol, msg=name)


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


def _operands(device, b, n, d, dtype, seed=0):
    """theta, phi, g of 0.3 randn and dout of randn: the scales
    KERNEL_BWD_TOLERANCE was derived at."""
    gen = torch.Generator(device=device).manual_seed(seed)
    t, p, g = (0.3 * torch.randn(b, n, d, generator=gen, device=device)
               for _ in range(3))
    do = torch.randn(b, n, d, generator=gen, device=device)
    return [x.to(dtype) for x in (t, p, g, do)]


# K2 through the autograd Function, so fed K1's own output and row
# logsumexp.  FWD_CASES's (300, 64, 128) is left out: at N=64 the gradients
# reach ~2.3 and K2's own rounding of P and dS, with the exact forward
# output, already lies outside KERNEL_BWD_TOLERANCE there
# (tests/test_torch_nonlocal_attn.py:test_bwd_tolerance_stops_short_of_short_n).
@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d,dtype", [
    (64, 1024, 128, torch.bfloat16),   # the train step's shape
    (2, 200, 128, torch.bfloat16),     # ragged N
    (2, 1024, 256, torch.bfloat16),    # RGB's width
    (2, 1024, 128, torch.float32),
    (2, 77, 256, torch.float32),
    (2, 1, 128, torch.bfloat16),       # one row
    (2, 129, 128, torch.bfloat16),     # one row past a 128-key tile
    (2, 1000, 256, torch.bfloat16),    # ragged 64-key tiles
])
def test_bwd_kernel_matches_plain_on_card(cuda_device, b, n, d, dtype):
    t, p, g, do = _operands(cuda_device, b, n, d, dtype)
    leaves = [x.clone().requires_grad_() for x in (t, p, g)]
    k1, k2 = nonlocal_attention.launches, nonlocal_attention_bwd.launches
    out = nonlocal_attention(*leaves)
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert nonlocal_attention.launches == k1 + 1
    assert nonlocal_attention_bwd.launches == k2 + 1
    ref = nonlocal_attention_bwd_reference(t, p, g, do)
    # KERNEL_BWD_TOLERANCE says why these limits (ops/nonlocal_attn.py)
    atol, rtol = KERNEL_BWD_TOLERANCE[dtype]
    for name, a, r in zip(("dtheta", "dphi", "dg"), grads, ref):
        assert a.dtype == dtype
        torch.testing.assert_close(a.float(), r.float(), atol=atol, rtol=rtol,
                                   msg=name)


@pytest.mark.cuda
def test_forward_saves_the_row_logsumexp(cuda_device):
    from blindshadowremoval_tpu_torch.ops.nonlocal_attn import _launch_fwd

    t, p, g, _ = _operands(cuda_device, 2, 200, 128, torch.bfloat16)
    out, lse = _launch_fwd(t, p, g, with_lse=True)
    ref = torch.logsumexp(torch.matmul(t.float(), p.float().transpose(1, 2)),
                          dim=-1)
    # f32 max + log(sum of fast exps): a few ulps of values near 5
    torch.testing.assert_close(lse, ref, atol=1e-4, rtol=1e-5)
    plain, none = _launch_fwd(t, p, g, with_lse=False)
    assert none is None
    torch.testing.assert_close(out, plain, rtol=0, atol=0)


@pytest.mark.cuda
def test_bwd_kernel_rejects_misaligned_view(cuda_device):
    flat = torch.zeros(2 * 64 * 128 + 1, dtype=torch.bfloat16,
                       device=cuda_device)
    t = flat[1:].view(2, 64, 128)
    lse = torch.zeros(2, 64, device=cuda_device)
    before = nonlocal_attention_bwd.launches
    with pytest.raises(ValueError, match="aligned"):
        nonlocal_attention_bwd(t, t, t, t, lse, t)
    with pytest.raises(TypeError, match="all alike"):
        x = torch.zeros(2, 64, 128, dtype=torch.bfloat16, device=cuda_device)
        nonlocal_attention_bwd(x, x, x, x, lse, x.float())
    assert nonlocal_attention_bwd.launches == before
