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
    KERNEL_BWD_TOLERANCE,
    KERNEL_TOLERANCE,
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


def _emulate_bwd(t, p, g, do, p_dtype=torch.bfloat16, delta_scale=1.0):
    """K2's numerics (csrc/nonlocal_attn_bwd.cu) in plain PyTorch: f32
    scores of the bf16 operands, P = exp(S - lse) rounded to `p_dtype` as
    the operand of dg, dS = P o (dP - Delta) rounded to `p_dtype` as the
    operand of dtheta and dphi, Delta = rowsum(dO o O) of the bf16 forward
    output (times `delta_scale`, to model a broken kernel), each gradient
    rounded once to bf16."""
    o = nonlocal_attention_reference(t, p, g)
    s = torch.matmul(t.float(), p.float().transpose(1, 2))
    prob = torch.exp(s - torch.logsumexp(s, -1, keepdim=True))
    delta = (do.float() * o.float()).sum(-1, keepdim=True) * delta_scale
    dp = torch.matmul(do.float(), g.float().transpose(1, 2))
    dg = torch.matmul(prob.to(p_dtype).float().transpose(1, 2), do.float())
    ds = (prob * (dp - delta)).to(p_dtype).float()
    dt = torch.matmul(ds, p.float())
    dph = torch.matmul(ds.transpose(1, 2), t.float())
    return dt.bfloat16(), dph.bfloat16(), dg.bfloat16()


def _bwd_case(b, n, d):
    rng = np.random.default_rng(0)
    t, p, g = _bf16_ops(b, n, d)
    do = torch.tensor(rng.normal(size=(b, n, d)).astype(np.float32))
    return t, p, g, do.bfloat16()


def _within_bwd_tolerance(out, ref):
    atol, rtol = KERNEL_BWD_TOLERANCE[torch.bfloat16]
    return all(bool(((o.float() - r.float()).abs()
                     <= atol + rtol * r.float().abs()).all())
               for o, r in zip(out, ref))


@pytest.mark.parametrize("b,n,d", [(8, 1024, 128), (2, 200, 128),
                                   (4, 1024, 256)])
def test_bwd_tolerance_admits_the_kernels_numerics(b, n, d):
    t, p, g, do = _bwd_case(b, n, d)
    ref = nonlocal_attention_bwd_reference(t, p, g, do)
    assert _within_bwd_tolerance(_emulate_bwd(t, p, g, do), ref)


def test_bwd_tolerance_stops_short_of_short_n():
    # the scope of KERNEL_BWD_TOLERANCE: at N=64 the gradients reach ~2.3
    # and K2's own rounding of P and dS, with the exact forward output,
    # already lies outside it, so the card tests leave (300, 64, 128) out
    # of their K2 cases
    t, p, g, do = _bwd_case(300, 64, 128)
    ref = nonlocal_attention_bwd_reference(t, p, g, do)
    assert not _within_bwd_tolerance(_emulate_bwd(t, p, g, do), ref)


@pytest.mark.parametrize("p_dtype,delta_scale", [
    (torch.float8_e4m3fn, 1.0),    # P and dS rounded to fp8, not bf16
    (torch.bfloat16, 1.03),        # rowsum(dO o O) off by 3%
])
def test_bwd_tolerance_rejects_broken_numerics(p_dtype, delta_scale):
    t, p, g, do = _bwd_case(8, 1024, 128)
    ref = nonlocal_attention_bwd_reference(t, p, g, do)
    out = _emulate_bwd(t, p, g, do, p_dtype, delta_scale)
    assert not _within_bwd_tolerance(out, ref)
