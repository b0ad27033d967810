"""Port's NonLocal attention (ops/nonlocal_attn.py) against the JAX package's
attention: the XLA path and the Pallas kernel run by the Pallas interpreter.

On the CPU the wrapper takes the plain version; the Hopper kernel itself is
held against the plain version on the card by
tests/test_torch_kernels_cuda.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blindshadowremoval_tpu.ops.pallas.nonlocal_attn import (
    _attention_xla,
    _pallas_attention,
)
from blindshadowremoval_tpu_torch.ops.nonlocal_attn import (
    KERNEL_TOLERANCE,
    nonlocal_attention,
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


def _emulate_kernel(t, p, g, p_dtype=torch.bfloat16, rescale=1.0):
    """The bf16 kernel's numerics (csrc/nonlocal_attn.cu) in plain PyTorch:
    64-key tiles, an online softmax in f32, exp(s - running max) rounded to
    `p_dtype` as the operand of the second product, the row sum taken over
    the unrounded values, one divide at the end.  `rescale` multiplies the
    fourth tile's rescale factor, to model a broken kernel."""
    s = torch.matmul(t.float(), p.float().transpose(1, 2))
    b, n, d = g.shape
    m = torch.full((b, n, 1), -float("inf"))
    total = torch.zeros(b, n, 1)
    acc = torch.zeros(b, n, d)
    for i, n0 in enumerate(range(0, n, 64)):
        tile = s[..., n0:n0 + 64]
        mx = torch.maximum(m, tile.amax(-1, keepdim=True))
        alpha = torch.exp(m - mx) * (rescale if i == 3 else 1.0)
        e = torch.exp(tile - mx)
        total = total * alpha + e.sum(-1, keepdim=True)
        acc = acc * alpha + torch.matmul(e.to(p_dtype).float(),
                                         g[:, n0:n0 + 64].float())
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
    # must admit the kernel's own rounding at the main path's widths
    t, p, g = _bf16_ops(b, n, d)
    ref = nonlocal_attention_reference(t, p, g).float()
    assert _within_kernel_tolerance(_emulate_kernel(t, p, g), ref)


@pytest.mark.parametrize("p_dtype,rescale", [
    (torch.float8_e4m3fn, 1.0),    # weights rounded to fp8, not bf16
    (torch.bfloat16, 1.03),        # one tile's rescale off by 3%
])
def test_kernel_tolerance_rejects_broken_numerics(p_dtype, rescale):
    t, p, g = _bf16_ops(8, 1024, 128)
    ref = nonlocal_attention_reference(t, p, g).float()
    out = _emulate_kernel(t, p, g, p_dtype, rescale)
    assert not _within_kernel_tolerance(out, ref)
