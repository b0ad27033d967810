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
    _launch_fwd,
    bwd_tolerance,
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


# the f32 kernels (3xTF32 on the tensor cores) at B=1 and 80, N=64 (one
# key tile of K1 at D=128, one key block of K2), 65, 200 and 1024, D=128
# and 256
F32_CASES = [(1, 64, 128), (80, 64, 256), (1, 65, 256), (80, 65, 128),
             (1, 200, 128), (80, 200, 256), (1, 1024, 256), (80, 1024, 128),
             (80, 1024, 256)]

# K1's cases: the main path's widths, ragged tails of the 128- and 64-key
# tiles, a single row (N=1), one row past a tile (N=129), 300 batch
# elements of one partial query tile each (N=64), and the batches of the
# TSM and RGB paths
FWD_CASES = [
    (2, 1024, 128, torch.bfloat16),    # TSM: an anchor and its mirror
    (16, 1024, 128, torch.bfloat16),   # TSM: a fused UCB pass of 8 pairs
    (10, 1024, 256, torch.bfloat16),   # RGB: one evaluation sample
    (80, 1024, 256, torch.bfloat16),   # RGB: a fused UCB pass
    (2, 200, 128, torch.bfloat16),
    (2, 1024, 256, torch.bfloat16),
    (2, 1024, 128, torch.float32),
    (2, 77, 256, torch.float32),
    (2, 1, 128, torch.bfloat16),
    (2, 129, 128, torch.bfloat16),
    (2, 1000, 256, torch.bfloat16),
    (300, 64, 128, torch.bfloat16),
] + [(b, n, d, torch.float32) for b, n, d in F32_CASES]


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
    do = torch.randn(3, 200, 128, generator=gen, device=cuda_device).bfloat16()
    out, lse = _launch_fwd(t, p, g, with_lse=True)
    grads = nonlocal_attention_bwd(t, p, g, out, lse, do)
    torch.cuda.synchronize()
    keep = [0, 2]
    ref = nonlocal_attention_bwd_reference(t[keep], p[keep], g[keep], do[keep])
    for name, a, r in zip(("dtheta", "dphi", "dg"), grads, ref):
        atol, rtol = bwd_tolerance(r, torch.bfloat16)
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
# logsumexp: the main path's widths, ragged tails, N around the 64-query
# tile and the 128-key block of the bf16 kernel at D=128, and 300 batch
# elements of one partial tile each (N=64)
@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d,dtype", [
    (64, 1024, 128, torch.bfloat16),   # the train step's shape
    (64, 1024, 256, torch.bfloat16),   # the RGB train step's shape
    (2, 200, 128, torch.bfloat16),     # ragged N
    (2, 1024, 256, torch.bfloat16),    # RGB's width
    (2, 1024, 128, torch.float32),
    (2, 77, 256, torch.float32),
    (2, 1, 128, torch.bfloat16),       # one row
    (2, 65, 128, torch.bfloat16),      # one query past a 64-query tile
    (2, 127, 128, torch.bfloat16),     # one key short of a 128-key block
    (2, 129, 128, torch.bfloat16),     # one key past a 128-key block
    (2, 1000, 256, torch.bfloat16),    # ragged 64-key tiles
    (300, 64, 128, torch.bfloat16),    # short N, the largest gradients
] + [(b, n, d, torch.float32) for b, n, d in F32_CASES])
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
    for name, a, r in zip(("dtheta", "dphi", "dg"), grads, ref):
        assert a.dtype == dtype
        atol, rtol = bwd_tolerance(r, dtype)
        torch.testing.assert_close(a.float(), r.float(), atol=atol, rtol=rtol,
                                   msg=name)


@pytest.mark.cuda
def test_bwd_kernel_keeps_batch_elements_apart(cuda_device):
    # K2 alone, fed the plain forward's output and logsumexp: batch element
    # 1 is 50 times its neighbours, so a query tile or key block that read
    # past row N into the next element, or a gradient stored or added past
    # row N, would move elements 0 and 2 far outside the tolerance
    t, p, g, do = _operands(cuda_device, 3, 200, 128, torch.float32)
    for x in (t, p, g, do):
        x[1] *= 50
    t, p, g, do = (x.bfloat16() for x in (t, p, g, do))
    out = nonlocal_attention_reference(t, p, g)
    lse = torch.logsumexp(torch.matmul(t.float(), p.float().transpose(1, 2)),
                          dim=-1).contiguous()
    grads = nonlocal_attention_bwd(t, p, g, out, lse, do)
    torch.cuda.synchronize()
    keep = [0, 2]
    ref = nonlocal_attention_bwd_reference(t[keep], p[keep], g[keep], do[keep])
    for name, a, r in zip(("dtheta", "dphi", "dg"), grads, ref):
        assert bool(torch.isfinite(a).all()), name
        atol, rtol = bwd_tolerance(r, torch.bfloat16)
        torch.testing.assert_close(a[keep].float(), r.float(), atol=atol,
                                   rtol=rtol, msg=name)


@pytest.mark.cuda
def test_bwd_kernel_runs_agree(cuda_device):
    # dtheta's f32 partial sums arrive from the key blocks in no fixed
    # order, so two runs may differ in rounding; by no more than the
    # tolerance, and dphi and dg not at all
    t, p, g, do = _operands(cuda_device, 16, 1024, 128, torch.bfloat16)
    out, lse = _launch_fwd(t, p, g, with_lse=True)
    first = nonlocal_attention_bwd(t, p, g, out, lse, do)
    second = nonlocal_attention_bwd(t, p, g, out, lse, do)
    torch.cuda.synchronize()
    atol, rtol = bwd_tolerance(first[0], torch.bfloat16)
    torch.testing.assert_close(second[0].float(), first[0].float(), atol=atol,
                               rtol=rtol)
    for a, b in zip(first[1:], second[1:]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.cuda
def test_forward_saves_the_row_logsumexp(cuda_device):
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


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d", [(16, 1024, 128), (3, 200, 256),
                                   (8, 64, 128)])
def test_f32_kernels_repeat_bitwise(cuda_device, b, n, d):
    # the f32 kernels sum in a fixed order (no atomics; K2's dtheta adds
    # its key blocks' partial sums in block order): the same inputs give
    # the same bits, forward, logsumexp and all three gradients
    t, p, g, do = _operands(cuda_device, b, n, d, torch.float32)
    first = _launch_fwd(t, p, g, with_lse=True)
    second = _launch_fwd(t, p, g, with_lse=True)
    grads = [nonlocal_attention_bwd(t, p, g, *first, do) for _ in range(2)]
    torch.cuda.synchronize()
    for a, c in zip(first + grads[0], second + grads[1]):
        assert torch.equal(a, c)


@pytest.mark.cuda
def test_f32_kernels_ignore_tf32_switches(cuda_device):
    # 3xTF32 is the kernels' own arithmetic: PyTorch's TF32 switches,
    # which steer cuBLAS and cuDNN, change none of their bits
    t, p, g, do = _operands(cuda_device, 4, 200, 128, torch.float32)
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    runs = []
    try:
        for allow in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = allow
            torch.backends.cudnn.allow_tf32 = allow
            out, lse = _launch_fwd(t, p, g, with_lse=True)
            runs.append((out, lse, *nonlocal_attention_bwd(t, p, g, out, lse,
                                                           do)))
        torch.cuda.synchronize()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    for a, c in zip(*runs):
        assert torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [128, 256])
def test_f32_kernels_keep_batch_elements_apart(cuda_device, d):
    # as the bf16 tests above, in f32: batch element 1 is 50 times its
    # neighbours, so a tile read past row N into the next element, or a
    # row stored past it, would move elements 0 and 2 out of tolerance
    # (element 1's scores of ~1e5 lie outside the tolerances' derivation)
    t, p, g, do = _operands(cuda_device, 3, 200, d, torch.float32)
    for x in (t, p, g, do):
        x[1] *= 50
    keep = [0, 2]
    out, lse = _launch_fwd(t, p, g, with_lse=True)
    grads = nonlocal_attention_bwd(t, p, g, out, lse, do)
    torch.cuda.synchronize()
    atol, rtol = KERNEL_TOLERANCE[torch.float32]
    torch.testing.assert_close(
        out[keep], nonlocal_attention_reference(t[keep], p[keep], g[keep]),
        atol=atol, rtol=rtol)
    ref = nonlocal_attention_bwd_reference(t[keep], p[keep], g[keep],
                                           do[keep])
    for name, a, r in zip(("dtheta", "dphi", "dg"), grads, ref):
        assert bool(torch.isfinite(a).all()), name
        atol, rtol = bwd_tolerance(r, torch.float32)
        torch.testing.assert_close(a[keep], r, atol=atol, rtol=rtol,
                                   msg=name)
