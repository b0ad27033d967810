"""Port's NonLocal attention (ops/nonlocal_attn.py), forward and backward,
against the JAX package's attention: the XLA path and the Pallas kernels
run by the Pallas interpreter.

On the CPU the wrapper takes the plain versions; the Hopper kernels
themselves are held against them on the card by
tests/test_torch_kernels_cuda.py and chip_smoke.py.  The emulations below
show that the kernels' stated tolerances admit their own rounding and
reject a broken kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blindshadowremoval_tpu.ops.pallas.nonlocal_attn import (
    _attention_bwd_xla,
    _attention_xla,
    _pallas_attention,
    _pallas_attention_bwd,
)
from blindshadowremoval_tpu_torch.ops.nonlocal_attn import (
    BWD_SCALE_FLOOR,
    KERNEL_BWD_TOLERANCE,
    KERNEL_TOLERANCE,
    bwd_tolerance,
    nonlocal_attention,
    nonlocal_attention_bwd_reference,
    nonlocal_attention_reference,
)


def _ops(rng, b=2, n=256, d=128):
    return [rng.normal(scale=0.3, size=(b, n, d)).astype(np.float32)
            for _ in range(3)]


def _port(ops, dtype=torch.float32):
    out = nonlocal_attention(*(torch.tensor(x).to(dtype) for x in ops))
    return out.float().numpy()


def test_plain_matches_xla_f32(rng):
    ops = _ops(rng)
    ref = np.asarray(_attention_xla(*map(jnp.asarray, ops)))
    # both f32 end to end; only the summation order differs
    np.testing.assert_allclose(_port(ops), ref, atol=2e-6)


def test_plain_matches_pallas_interpret_f32(rng):
    ops = _ops(rng)
    ref = np.asarray(_pallas_attention(*map(jnp.asarray, ops),
                                       interpret=True))
    # the same tolerance tests/test_pallas_attn.py holds the kernel to
    np.testing.assert_allclose(_port(ops), ref, atol=2e-5)


def test_plain_matches_pallas_interpret_bf16(rng):
    ops = [x.astype(jnp.bfloat16) for x in map(jnp.asarray, _ops(rng))]
    ref = np.asarray(_pallas_attention(*ops, interpret=True)).astype(
        np.float32)
    out = _port([np.asarray(x.astype(jnp.float32)) for x in ops],
                torch.bfloat16)
    # both take f32 scores of the same bf16 operands and cast the
    # normalized weights to bf16; a weight or an output that rounds the
    # other way moves the output by one bf16 ulp (2^-8 relative near 1)
    np.testing.assert_allclose(out, ref, atol=4e-3, rtol=1e-2)


def test_plain_matches_xla_ragged_n(rng):
    ops = _ops(rng, n=200)
    ref = np.asarray(_attention_xla(*map(jnp.asarray, ops)))
    np.testing.assert_allclose(_port(ops), ref, atol=2e-6)


def test_cpu_tensors_do_not_launch(rng):
    before = nonlocal_attention.launches
    _port(_ops(rng, b=1, n=64))
    assert nonlocal_attention.launches == before


def test_cpu_wrapper_is_the_plain_version(rng):
    t, p, g = (torch.tensor(x) for x in _ops(rng, b=1, n=64))
    torch.testing.assert_close(nonlocal_attention(t, p, g),
                               nonlocal_attention_reference(t, p, g),
                               rtol=0, atol=0)


# keys per tile of the bf16 kernel by head width (csrc/nonlocal_attn.cu,
# Tiles<D>::kBlockN)
KEY_TILE = {128: 128, 256: 64}


def _emulate_kernel(t, p, g, tile, p_dtype=torch.bfloat16, rescale=1.0):
    """The bf16 kernel's numerics (csrc/nonlocal_attn.cu) in plain PyTorch:
    `tile`-key tiles, an online softmax in f32, exp(s - running max)
    rounded to `p_dtype` as the operand of the second product, the row sum
    taken over the unrounded values, one divide at the end.  `rescale`
    multiplies the fourth tile's rescale factor, to model a broken kernel."""
    s = torch.matmul(t.float(), p.float().transpose(1, 2))
    b, n, d = g.shape
    m = torch.full((b, n, 1), -float("inf"))
    total = torch.zeros(b, n, 1)
    acc = torch.zeros(b, n, d)
    for i, n0 in enumerate(range(0, n, tile)):
        block = s[..., n0:n0 + tile]
        mx = torch.maximum(m, block.amax(-1, keepdim=True))
        alpha = torch.exp(m - mx) * (rescale if i == 3 else 1.0)
        e = torch.exp(block - mx)
        total = total * alpha + e.sum(-1, keepdim=True)
        acc = acc * alpha + torch.matmul(e.to(p_dtype).float(),
                                         g[:, n0:n0 + tile].float())
        m = mx
    return (acc / total).to(torch.bfloat16).float()


def _within_kernel_tolerance(out, ref):
    atol, rtol = KERNEL_TOLERANCE[torch.bfloat16]
    return bool(((out - ref).abs() <= atol + rtol * ref.abs()).all())


def _bf16_ops(b, n, d):
    rng = np.random.default_rng(0)
    return [torch.tensor(x).to(torch.bfloat16) for x in _ops(rng, b, n, d)]


@pytest.mark.parametrize("b,n,d", [(8, 1024, 128), (2, 200, 128),
                                   (4, 1024, 256)])
def test_kernel_tolerance_admits_the_kernels_numerics(b, n, d):
    # the bound that chip_smoke.py and the card tests hold the kernel to
    # must admit the kernel's own rounding at the main path's widths, with
    # the key tiles the kernel takes at each head width
    t, p, g = _bf16_ops(b, n, d)
    ref = nonlocal_attention_reference(t, p, g).float()
    assert _within_kernel_tolerance(_emulate_kernel(t, p, g, KEY_TILE[d]), ref)


@pytest.mark.parametrize("p_dtype,rescale", [
    (torch.float8_e4m3fn, 1.0),    # weights rounded to fp8, not bf16
    (torch.bfloat16, 1.03),        # one tile's rescale off by 3%
])
def test_kernel_tolerance_rejects_broken_numerics(p_dtype, rescale):
    t, p, g = _bf16_ops(8, 1024, 128)
    ref = nonlocal_attention_reference(t, p, g).float()
    out = _emulate_kernel(t, p, g, KEY_TILE[128], p_dtype, rescale)
    assert not _within_kernel_tolerance(out, ref)


# ------------------------------------------------------------- backward
def test_bwd_reference_matches_xla_f32(rng):
    ops = _ops(rng) + [rng.normal(size=(2, 256, 128)).astype(np.float32)]
    ref = _attention_bwd_xla(*map(jnp.asarray, ops))
    out = nonlocal_attention_bwd_reference(*(torch.tensor(x) for x in ops))
    for name, a, b in zip(("dtheta", "dphi", "dg"), out, ref):
        # both f32 end to end; only the summation order differs
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-6,
                                   err_msg=name)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_bwd_reference_matches_pallas_interpret(rng, dtype):
    ops = [jnp.asarray(x, dtype) for x in _ops(rng)]
    ops.append(jnp.asarray(rng.normal(size=(2, 256, 128)), dtype))
    ref = _pallas_attention_bwd(*ops, interpret=True)
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    out = nonlocal_attention_bwd_reference(
        *(torch.tensor(np.asarray(x.astype(jnp.float32))).to(tdtype)
          for x in ops))
    for name, a, b in zip(("dtheta", "dphi", "dg"), out, ref):
        assert a.dtype == tdtype
        b = np.asarray(b.astype(jnp.float32))
        if dtype == jnp.float32:
            np.testing.assert_allclose(a.numpy(), b, atol=2e-5, err_msg=name)
        else:
            # both keep W and dS in f32 and round each gradient once to
            # bf16: at most one ulp apart (2^-8 relative, plus sums
            # landing either side of a rounding boundary)
            np.testing.assert_allclose(a.float().numpy(), b, atol=2e-3,
                                       rtol=2 ** -7, err_msg=name)


def test_bwd_reference_mixed_dtypes(rng):
    t, p, g = (torch.tensor(x) for x in _ops(rng, b=1, n=64))
    do = torch.tensor(rng.normal(size=(1, 64, 128)).astype(np.float32))
    dt, dp, dg = nonlocal_attention_bwd_reference(t.bfloat16(), p, g.half(),
                                                  do)
    assert (dt.dtype, dp.dtype, dg.dtype) == (torch.bfloat16, torch.float32,
                                              torch.float16)


@pytest.mark.parametrize("n", [64, 200])
def test_function_grads_match_autograd_of_plain_forward(rng, n):
    # the autograd.Function's wiring on the CPU: its backward (the plain
    # backward) against autograd through the plain forward
    ops = _ops(rng, b=2, n=n)
    do = torch.tensor(rng.normal(size=(2, n, 128)).astype(np.float32))
    a = [torch.tensor(x, requires_grad=True) for x in ops]
    b = [torch.tensor(x, requires_grad=True) for x in ops]
    out = nonlocal_attention(*a)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, a, do)
    want = torch.autograd.grad(nonlocal_attention_reference(*b), b, do)
    torch.testing.assert_close(out, nonlocal_attention_reference(*b).detach(),
                               rtol=0, atol=0)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6)


def test_no_grad_forward_skips_the_function(rng):
    a = [torch.tensor(x, requires_grad=True) for x in _ops(rng, b=1, n=64)]
    with torch.no_grad():
        assert nonlocal_attention(*a).grad_fn is None


# keys per block of the bf16 backward by head width (csrc/nonlocal_attn_bwd.cu,
# hop::Cfg<D>::kKeys): each block adds its partial dtheta into an f32
# workspace
BWD_KEY_BLOCK = {128: 128, 256: 64}


def _emulate_bwd(t, p, g, do, p_dtype=torch.bfloat16, delta_scale=1.0):
    """K2's numerics (csrc/nonlocal_attn_bwd.cu) in plain PyTorch: f32
    scores of the bf16 operands, P = exp(S - lse) rounded to `p_dtype` as
    the operand of dg, dS = P o (dP - Delta) rounded to `p_dtype` as the
    operand of dtheta and dphi, Delta = rowsum(dO o O) of the bf16 forward
    output (times `delta_scale`, to model a broken kernel), each gradient
    rounded once to bf16.  Since the one-pass kernel, dtheta is the f32
    sum of one partial product per block of BWD_KEY_BLOCK[D] keys (128 at
    D=128, 64 at D=256), added in no fixed order (here the last block
    first) before its bf16 rounding, where the two-pass kernel it replaced
    summed it in one f32 accumulator in key order."""
    o = nonlocal_attention_reference(t, p, g)
    s = torch.matmul(t.float(), p.float().transpose(1, 2))
    prob = torch.exp(s - torch.logsumexp(s, -1, keepdim=True))
    delta = (do.float() * o.float()).sum(-1, keepdim=True) * delta_scale
    dp = torch.matmul(do.float(), g.float().transpose(1, 2))
    dg = torch.matmul(prob.to(p_dtype).float().transpose(1, 2), do.float())
    ds = (prob * (dp - delta)).to(p_dtype).float()
    n, keys = t.shape[1], BWD_KEY_BLOCK[t.shape[2]]
    dt = torch.zeros(t.shape)
    for j in reversed(range(0, n, keys)):
        dt += torch.matmul(ds[..., j:j + keys], p.float()[:, j:j + keys])
    dph = torch.matmul(ds.transpose(1, 2), t.float())
    return dt.bfloat16(), dph.bfloat16(), dg.bfloat16()


def _bwd_case(b, n, d):
    rng = np.random.default_rng(0)
    t, p, g = _bf16_ops(b, n, d)
    do = torch.tensor(rng.normal(size=(b, n, d)).astype(np.float32))
    return t, p, g, do.bfloat16()


def _within_bwd_tolerance(out, ref):
    for o, r in zip(out, ref):
        atol, rtol = bwd_tolerance(r, torch.bfloat16)
        if not bool(((o.float() - r.float()).abs()
                     <= atol + rtol * r.float().abs()).all()):
            return False
    return True


# the main path's widths, ragged N, N=1 (dtheta and dphi zero in exact
# arithmetic), N around the 64-query tile and the 128-key block, and
# short N, where the gradients are largest
@pytest.mark.parametrize("b,n,d", [(8, 1024, 128), (2, 200, 128),
                                   (4, 1024, 256), (300, 64, 128),
                                   (2, 1, 128), (2, 65, 128), (2, 127, 128),
                                   (2, 129, 128)])
def test_bwd_tolerance_admits_the_kernels_numerics(b, n, d):
    t, p, g, do = _bwd_case(b, n, d)
    ref = nonlocal_attention_bwd_reference(t, p, g, do)
    assert _within_bwd_tolerance(_emulate_bwd(t, p, g, do), ref)


# at the train step's shape, and at the RGB width and at short N, where the
# atol (in proportion to the largest gradient) is widest
@pytest.mark.parametrize("b,n,d", [(8, 1024, 128), (4, 1024, 256),
                                   (300, 64, 128)])
@pytest.mark.parametrize("p_dtype,delta_scale", [
    (torch.float8_e4m3fn, 1.0),    # P and dS rounded to fp8, not bf16
    (torch.bfloat16, 1.03),        # rowsum(dO o O) off by 3%
])
def test_bwd_tolerance_rejects_broken_numerics(p_dtype, delta_scale, b, n,
                                               d):
    t, p, g, do = _bwd_case(b, n, d)
    ref = nonlocal_attention_bwd_reference(t, p, g, do)
    out = _emulate_bwd(t, p, g, do, p_dtype, delta_scale)
    assert not _within_bwd_tolerance(out, ref)


def test_bwd_tolerance_scales_with_the_gradient():
    # atol follows each gradient's largest magnitude, floored
    share, rtol = KERNEL_BWD_TOLERANCE[torch.bfloat16]
    ref = torch.tensor([[-2.0, 0.5]])
    assert bwd_tolerance(ref, torch.bfloat16) == (2.0 * share, rtol)
    assert bwd_tolerance(0 * ref, torch.bfloat16) == (
        BWD_SCALE_FLOOR * share, rtol)


# ------------------------------------------------------- f32: 3xTF32
# The f32 kernels run both products of K1 and all five of K2 on the tensor
# cores as 3xTF32 (csrc/hopper.cuh): each operand x splits into big =
# tf32(x) and small = x - big, which the tensor cores read truncated to
# TF32, and a product sums small.big + big.small + big.big in f32.  The
# emulations below run those products in plain PyTorch and show that the
# f32 tolerances, unchanged from the CUDA-core kernels, admit them and
# reject one TF32 pass or a split that drops small.big.

# keys per tile of K1's f32 kernel (csrc/nonlocal_attn.cu, f32::kKeys)
# and keys per block of K2's (csrc/nonlocal_attn_bwd.cu, f32::kKeys)
F32_KEY_TILE = 32
F32_BWD_KEY_BLOCK = 64


@pytest.fixture
def two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _tf32(x):
    """x rounded to TF32 (10 stored mantissa bits) to nearest, ties away
    from zero, as the kernels' split does (hopper.cuh:split_tf32); f32."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_truncated(x):
    """x truncated to TF32, as the tensor cores read an f32 operand."""
    bits = x.float().contiguous().view(torch.int32)
    return (bits & -0x2000).view(torch.float32)


def _mm3(a, b, passes="3x"):
    """a @ b as the f32 kernels take it: the products of TF32 parts summed
    in f32.  "3x": small.big + big.small + big.big; "1x": big.big alone
    (one TF32 pass); "2x": big.small + big.big (small.big dropped)."""
    a_big, b_big = _tf32(a), _tf32(b)
    a_small = _tf32_truncated(a - a_big)
    b_small = _tf32_truncated(b - b_big)
    out = torch.matmul(a_big, b_big)
    if passes in ("3x", "2x"):
        out = out + torch.matmul(a_big, b_small)
    if passes == "3x":
        out = out + torch.matmul(a_small, b_big)
    return out


def _emulate_f32_kernel(t, p, g, passes="3x"):
    """K1's f32 numerics (csrc/nonlocal_attn.cu, f32::attn_fwd_f32) in
    plain PyTorch: S = theta phi^T as `passes` TF32 products (at D=256 its
    two halves of D summed apart, then added), an online softmax in f32
    over F32_KEY_TILE-key tiles, each tile's exp(S - running max) g as
    `passes` products added into the f32 accumulator, one divide at the
    end.  Returns (out, row logsumexp)."""
    b, n, d = g.shape
    halves = [slice(0, d)] if d == 128 else [slice(0, 128), slice(128, d)]
    s = sum(_mm3(t[..., h], p[..., h].transpose(1, 2), passes)
            for h in halves)
    tile = F32_KEY_TILE
    m = torch.full((b, n, 1), -float("inf"))
    total = torch.zeros(b, n, 1)
    acc = torch.zeros(b, n, d)
    for n0 in range(0, n, tile):
        block = s[..., n0:n0 + tile]
        mx = torch.maximum(m, block.amax(-1, keepdim=True))
        alpha = torch.exp(m - mx)
        e = torch.exp(block - mx)
        total = total * alpha + e.sum(-1, keepdim=True)
        acc = acc * alpha + _mm3(e, g[:, n0:n0 + tile], passes)
        m = mx
    return acc / total, (m + torch.log(total))[..., 0]


def _emulate_f32_bwd(t, p, g, do, passes="3x"):
    """K2's f32 numerics (csrc/nonlocal_attn_bwd.cu, f32::bwd_f32): the
    emulated forward's output and logsumexp, Delta = rowsum(dO o O) in
    f32, S^T = phi theta^T and dP^T = g dO^T as `passes` products, P =
    exp(S - lse), dS = P o (dP - Delta), dg = P^T dO and dphi = dS^T theta
    as `passes` products, dtheta = dS phi as one product per block of
    F32_BWD_KEY_BLOCK keys, added in block order."""
    o, lse = _emulate_f32_kernel(t, p, g, passes)
    delta = (do * o).sum(-1, keepdim=True)
    s = _mm3(p, t.transpose(1, 2), passes).transpose(1, 2)
    dp = _mm3(g, do.transpose(1, 2), passes).transpose(1, 2)
    prob = torch.exp(s - lse[..., None])
    ds = prob * (dp - delta)
    dg = _mm3(prob.transpose(1, 2), do, passes)
    dph = _mm3(ds.transpose(1, 2), t, passes)
    dt = torch.zeros(t.shape)
    for j in range(0, t.shape[1], F32_BWD_KEY_BLOCK):
        dt = dt + _mm3(ds[..., j:j + F32_BWD_KEY_BLOCK],
                       p[:, j:j + F32_BWD_KEY_BLOCK], passes)
    return dt, dph, dg


def _f32_case(b, n, d):
    """theta, phi, g of 0.3 randn and dout of randn (numpy seed 0), the
    scales the f32 kernels are held at on the card."""
    rng = np.random.default_rng(0)
    t, p, g = (torch.tensor(x) for x in _ops(rng, b, n, d))
    do = torch.tensor(rng.normal(size=(b, n, d)).astype(np.float32))
    return t, p, g, do


def _within_f32_tolerance(out, ref):
    atol, rtol = KERNEL_TOLERANCE[torch.float32]
    return bool(((out - ref).abs() <= atol + rtol * ref.abs()).all())


def _within_f32_bwd_tolerance(out, ref):
    for o, r in zip(out, ref):
        atol, rtol = bwd_tolerance(r, torch.float32)
        if not bool(((o - r).abs() <= atol + rtol * r.abs()).all()):
            return False
    return True


# every f32 shape at which phases 9-18 of chip_smoke.py launch K1 (the
# evaluators at N=1024, the 128 px goldens at N=256, the f32 train steps
# at N=64), and ragged N at both widths
F32_FWD_SHAPES = [(1, 1024, 128), (2, 1024, 128), (4, 1024, 128),
                  (5, 1024, 128), (8, 1024, 128), (10, 1024, 128),
                  (16, 1024, 128), (40, 1024, 128), (80, 1024, 128),
                  (10, 1024, 256), (80, 1024, 256), (2, 256, 128),
                  (1, 256, 256), (4, 64, 128), (8, 64, 128), (8, 64, 256),
                  (2, 65, 128), (2, 200, 128), (2, 65, 256), (2, 200, 256)]


@pytest.mark.parametrize("b,n,d", F32_FWD_SHAPES)
def test_f32_tolerance_admits_3xtf32(two_threads, b, n, d):
    t, p, g, _ = _f32_case(b, n, d)
    ref = nonlocal_attention_reference(t, p, g)
    out, lse = _emulate_f32_kernel(t, p, g)
    assert _within_f32_tolerance(out, ref)
    ref_lse = torch.logsumexp(torch.matmul(t, p.transpose(1, 2)), dim=-1)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("passes", ["1x", "2x"])
@pytest.mark.parametrize("b,n,d", [(8, 1024, 128), (10, 1024, 256),
                                   (4, 64, 128), (2, 200, 256)])
def test_f32_tolerance_rejects_fewer_passes(two_threads, passes, b, n, d):
    t, p, g, _ = _f32_case(b, n, d)
    ref = nonlocal_attention_reference(t, p, g)
    assert not _within_f32_tolerance(_emulate_f32_kernel(t, p, g, passes)[0],
                                     ref)


# every f32 shape at which phases 9-18 launch K2 (the f32 train steps at
# N=64), the full-width train step's batch cut to 8 and 4 at N=1024, and
# ragged N at both widths
F32_BWD_SHAPES = [(4, 64, 128), (8, 64, 128), (8, 64, 256), (8, 1024, 128),
                  (4, 1024, 256), (2, 65, 128), (2, 200, 128),
                  (2, 65, 256), (2, 200, 256)]


@pytest.mark.parametrize("b,n,d", F32_BWD_SHAPES)
def test_f32_bwd_tolerance_admits_3xtf32(two_threads, b, n, d):
    t, p, g, do = _f32_case(b, n, d)
    ref = nonlocal_attention_bwd_reference(t, p, g, do)
    assert _within_f32_bwd_tolerance(_emulate_f32_bwd(t, p, g, do), ref)


@pytest.mark.parametrize("passes", ["1x", "2x"])
@pytest.mark.parametrize("b,n,d", [(8, 64, 128), (8, 64, 256),
                                   (2, 200, 128)])
def test_f32_bwd_tolerance_rejects_fewer_passes(two_threads, passes, b, n,
                                                d):
    t, p, g, do = _f32_case(b, n, d)
    ref = nonlocal_attention_bwd_reference(t, p, g, do)
    out = _emulate_f32_bwd(t, p, g, do, passes)
    assert not _within_f32_bwd_tolerance(out, ref)


def test_tf32_rounding_and_split():
    # 1 + 2^-11 is a tie: away from zero; the split keeps what one pass
    # drops, so big + small as the tensor cores read it is x to ~2^-21
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 3 * 2.0 ** -12, 0.1])
    big = _tf32(x)
    assert big.tolist()[:3] == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10),
                                1.0 + 2.0 ** -10]
    small = _tf32_truncated(x - big)
    assert bool(((big + small - x).abs() <= 2.0 ** -21 * x.abs()).all())
    assert bool(((big - x).abs() > 2.0 ** -14 * x.abs())[3])


@pytest.mark.parametrize("fn,shape,expected,bound_by", [
    ("fwd", (80, 1024, 128), 0.2603, "operations"),
    ("fwd", (80, 1024, 256), 0.5206, "operations"),
    ("fwd", (1, 1024, 128), 0.0033, "operations"),
    ("bwd", (64, 1024, 128), 0.5206, "operations"),
    ("bwd", (4, 64, 128), 0.0003, "bytes"),
])
def test_f32_bounds_are_three_tf32_passes(fn, shape, expected, bound_by):
    # chip_smoke.py's bounds: f32 products to f32 accuracy as three TF32
    # passes at 495 TFLOP/s, against the bytes
    import chip_smoke

    bound = (chip_smoke.attention_bound_ms if fn == "fwd"
             else chip_smoke.attention_bwd_bound_ms)
    ms, by = bound(*shape, torch.float32)
    assert ms == pytest.approx(expected, abs=5e-5)
    assert by == bound_by
    # bf16 stays one pass at the dense bf16 rate
    ms16, _ = bound(*shape, torch.bfloat16)
    assert ms16 < ms
