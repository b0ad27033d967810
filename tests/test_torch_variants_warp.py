"""The port's dense bilinear warp (geometry/warp.py: batch_map_coordinates,
batch_map_offsets), the TSM ShareLayer's sampler, against the JAX package's
functions and the scipy oracle of tests/test_warp.py, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import map_coordinates as sp_map_coordinates

from blindshadowremoval_tpu.geometry import warp as jax_warp
from blindshadowremoval_tpu_torch.geometry.warp import (
    batch_map_coordinates,
    batch_map_offsets,
    resize_bilinear,
)


def _oracle(inputs, coords):
    """tests/test_warp.py's sp_batch_map_coordinates, per channel."""
    coords = coords.clip(0, inputs.shape[1] - 1)
    return np.stack([np.stack([
        sp_map_coordinates(inp[..., k], coord.T, mode="nearest", order=1)
        for k in range(inp.shape[-1])], -1)
        for inp, coord in zip(inputs, coords)])


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("lo,hi", [(0.0, 16.0),     # inside
                                   (-3.0, 20.0)])   # past both edges: clamped
def test_map_coordinates_matches_jax_and_scipy(rng, lo, hi):
    x = rng.uniform(size=(3, 17, 17, 4)).astype(np.float32)
    coords = rng.uniform(lo, hi, size=(3, 50, 2)).astype(np.float32)
    ours = batch_map_coordinates(_t(x), _t(coords)).numpy()
    ref = np.asarray(jax_warp.batch_map_coordinates(jnp.asarray(x),
                                                    jnp.asarray(coords)))
    # one f32 lerp, the same operations in the same order
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(ours, _oracle(x, coords), rtol=0, atol=1e-5)


def test_map_coordinates_integer_coords_exact(rng):
    x = rng.uniform(size=(2, 8, 8, 3)).astype(np.float32)
    rr, cc = np.meshgrid(np.arange(8), np.arange(8), indexing="ij")
    coords = np.stack([rr.ravel(), cc.ravel()], -1)[None].repeat(2, 0)
    out = batch_map_coordinates(_t(x), _t(coords.astype(np.float32)))
    np.testing.assert_array_equal(out.numpy().reshape(x.shape), x)


@pytest.mark.parametrize("side,field", [(12, 12),    # same resolution
                                        (32, 256)])  # the ShareLayer's
def test_map_offsets_matches_jax(rng, side, field):
    """The offset field resized to the side (bilinear, TF semantics),
    scaled by it and added to the grid."""
    x = rng.uniform(size=(2, side, side, 5)).astype(np.float32)
    off = rng.uniform(-0.1, 0.1, size=(2, field, field, 3)).astype(np.float32)
    ours = batch_map_offsets(_t(x), _t(off)).numpy()
    ref = np.asarray(jax_warp.batch_map_offsets(jnp.asarray(x),
                                                jnp.asarray(off)))
    # the resize's products sum in another order (matmul vs einsum); a
    # coordinate off by 1 ulp of ~side moves the sample by 1e-6 * slope
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)
    if side == field:
        grid = np.stack(np.mgrid[:side, :side], -1).reshape(-1, 2)
        coords = off[..., :2].reshape(2, -1, 2) * side + grid[None]
        np.testing.assert_allclose(
            ours, _oracle(x, coords).reshape(x.shape), rtol=0, atol=1e-4)


def test_map_offsets_zero_field_is_identity(rng):
    x = rng.uniform(size=(2, 16, 16, 3)).astype(np.float32)
    out = batch_map_offsets(_t(x), torch.zeros(2, 64, 64, 3))
    np.testing.assert_array_equal(out.numpy(), x)


def test_map_offsets_bf16_input(rng):
    """A bf16 input with an f32 field samples in f32 (the corner
    differences in bf16, the lerp weights f32), as in the JAX package."""
    x = rng.uniform(size=(2, 32, 32, 8)).astype(np.float32)
    off = rng.uniform(-0.05, 0.05, size=(2, 256, 256, 3)).astype(np.float32)
    ours = batch_map_offsets(_t(x).to(torch.bfloat16), _t(off))
    ref = jax_warp.batch_map_offsets(jnp.asarray(x, jnp.bfloat16),
                                     jnp.asarray(off))
    assert ours.dtype == torch.float32 and ref.dtype == jnp.float32
    # bf16 corner differences (2^-8 relative) times a weight <= 1
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=4e-3)


def test_map_offsets_gradient_matches_jax(rng):
    """The input gradient: a scatter-add of the four corner weights."""
    x = rng.uniform(size=(2, 16, 16, 3)).astype(np.float32)
    off = rng.uniform(-0.1, 0.1, size=(2, 64, 64, 3)).astype(np.float32)
    w = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    xt = _t(x).requires_grad_()
    (batch_map_offsets(xt, _t(off)) * _t(w)).sum().backward()
    ref = jax.grad(lambda a: jnp.sum(jax_warp.batch_map_offsets(
        a, jnp.asarray(off)) * w))(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)


def test_resize_then_warp_equals_warp_of_low_res_field(rng):
    """A coarse field is upsampled before the warp (warp.py:137)."""
    x = rng.uniform(size=(1, 16, 16, 2)).astype(np.float32)
    off = rng.uniform(-0.1, 0.1, size=(1, 4, 4, 3)).astype(np.float32)
    up = resize_bilinear(_t(off[..., :2]), (16, 16))
    np.testing.assert_allclose(batch_map_offsets(_t(x), _t(off)).numpy(),
                               batch_map_offsets(_t(x), up).numpy(),
                               rtol=0, atol=1e-6)
