"""Port's generator blocks (models/blocks.py) against the Flax blocks, in
eval mode and f32, at small widths, with weights carried across by the
port's weight bridge (models/weights.py:block_from_jax)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blindshadowremoval_tpu.models import blocks as jb
from blindshadowremoval_tpu_torch.models import blocks as tb
from blindshadowremoval_tpu_torch.models.weights import block_from_jax

# f32 on both sides; the convolutions sum in another order (XLA vs ATen)
ATOL = 2e-5


def _randomize_bn(variables, rng):
    """Flax init leaves BatchNorm at the identity; give every BatchNorm
    non-trivial statistics and affine so the test sees its semantics."""
    def walk(params, stats):
        for name, child in params.items():
            if name.startswith("BatchNorm_"):
                c = child["scale"].shape
                child["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
                child["bias"] = rng.normal(0, 0.1, c).astype(np.float32)
                stats[name]["mean"] = rng.normal(0, 0.1, c).astype(np.float32)
                stats[name]["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            elif isinstance(child, dict) and not {"kernel", "bias"} >= set(child):
                walk(child, stats.get(name, {}))
            else:
                child["bias"] = rng.normal(0, 0.1, child["bias"].shape).astype(
                    np.float32)

    variables = jax.tree.map(np.array, variables)
    walk(variables["params"], variables.get("batch_stats", {}))
    return variables


def _compare(flax_block, torch_block, kind, x, rng, atol=ATOL):
    variables = flax_block.init(jax.random.PRNGKey(0), jnp.asarray(x))
    variables = _randomize_bn(variables, rng)
    ref = np.asarray(flax_block.apply(variables, jnp.asarray(x)))
    torch_block.load_state_dict(block_from_jax(
        variables["params"], variables.get("batch_stats", {}), kind))
    torch_block.eval()
    with torch.no_grad():
        out = torch_block(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref,
                               atol=atol)


def _x(rng, c, s=16, b=2):
    return rng.normal(size=(b, s, s, c)).astype(np.float32)


@pytest.mark.parametrize("ksize,stride,norm,act", [
    (3, 1, True, True),
    (3, 2, True, True),      # stride-2 SAME: pad after only
    (7, 1, False, False),    # the output head
    (1, 1, True, True),
])
def test_conv_block(rng, ksize, stride, norm, act):
    flax_block = jb.ConvBlock(8, ksize=ksize, stride=stride,
                              norm="batch" if norm else None, act=act)
    torch_block = tb.ConvBlock(5, 8, ksize=ksize, stride=stride, norm=norm,
                               act=act)
    _compare(flax_block, torch_block, "conv", _x(rng, 5), rng)


def test_conv_transpose_block(rng):
    flax_block = jb.ConvTBlock(6)
    torch_block = tb.ConvTBlock(5, 6)
    _compare(flax_block, torch_block, "conv", _x(rng, 5, s=8), rng)


def test_nonlocal_block(rng):
    flax_block = jb.NonLocalBlock(16, 16)
    torch_block = tb.NonLocalBlock(16)
    # inputs scaled so the softmax is neither flat nor one-hot
    _compare(flax_block, torch_block, "nonlocal", 0.5 * _x(rng, 16, s=8), rng)


@pytest.mark.parametrize("in_ch", [9, 20])   # residual padded / block padded
def test_res_bottleneck(rng, in_ch):
    flax_block = jb.ResBottleneck(17)
    torch_block = tb.ResBottleneck(in_ch, 17)
    _compare(flax_block, torch_block, "res", 0.5 * _x(rng, in_ch, s=8), rng)


@pytest.mark.parametrize("cx,cy", [(3, 5), (5, 3), (4, 4)])
def test_pad_channels_to_match(rng, cx, cy):
    x, y = _x(rng, cx, s=4), _x(rng, cy, s=4)
    jx, jy = jb._pad_channels_to_match(jnp.asarray(x), jnp.asarray(y))
    tx, ty = tb._pad_channels_to_match(
        torch.from_numpy(x).permute(0, 3, 1, 2),
        torch.from_numpy(y).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(tx.permute(0, 2, 3, 1).numpy(), jx)
    np.testing.assert_array_equal(ty.permute(0, 2, 3, 1).numpy(), jy)
