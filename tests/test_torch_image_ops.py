"""Port's image ops (ops/image.py), filters (ops/filters.py) and the
matrix bilinear resize (geometry/warp.py) against the JAX package, on the
same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blindshadowremoval_tpu.geometry import warp as jwarp
from blindshadowremoval_tpu.ops import filters as jfilt
from blindshadowremoval_tpu.ops import image as jimg
from blindshadowremoval_tpu_torch.geometry import warp as twarp
from blindshadowremoval_tpu_torch.ops import filters as tfilt
from blindshadowremoval_tpu_torch.ops import image as timg


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _img(rng, b=2, s=16, c=3):
    return rng.uniform(size=(b, s, s, c)).astype(np.float32)


@pytest.mark.parametrize("src,dst", [(17, 9), (16, 256), (256, 32),
                                     (32, 256), (100, 256)])
def test_resize_bilinear_matches_jax(rng, src, dst):
    # the taps are placed in f64 on both sides and applied as two f32
    # products: equal within 1e-6 (the F.interpolate version was ~1e-6
    # relative apart at 17 -> 9)
    x = rng.uniform(size=(2, src, src, 3)).astype(np.float32)
    ref = np.asarray(jwarp.resize_bilinear(jnp.asarray(x), (dst, dst)))
    out = twarp.resize_bilinear(_t(x), (dst, dst)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)
    # NCHW, both as a channels-last view and as a contiguous tensor
    for xc in (_t(x).permute(0, 3, 1, 2),
               _t(x).permute(0, 3, 1, 2).contiguous()):
        nchw = twarp.resize_bilinear_nchw(xc, (dst, dst))
        np.testing.assert_allclose(nchw.permute(0, 2, 3, 1).numpy(), ref,
                                   atol=1e-6, rtol=0)


def test_resize_matrix_is_the_jax_matrix():
    for out_size, in_size in ((9, 17), (256, 16), (32, 256)):
        np.testing.assert_array_equal(
            twarp._interp_matrix(out_size, in_size),
            jwarp._interp_matrix(out_size, in_size))


def test_resize_bilinear_bf16_casts_the_matrix(rng):
    x = rng.uniform(size=(1, 256, 256, 3)).astype(np.float32)
    ref = np.asarray(jwarp.resize_bilinear(jnp.asarray(x, jnp.bfloat16),
                                           (32, 32)).astype(jnp.float32))
    out = twarp.resize_bilinear(_t(x).bfloat16(), (32, 32)).float().numpy()
    # both round each product to bf16; a sum rounded the other way moves
    # one bf16 ulp (2^-8 near 1)
    np.testing.assert_allclose(out, ref, atol=2 ** -7, rtol=0)


def test_resize_cached_in_inference_mode_still_differentiates(rng):
    # serving resizes under inference_mode first; the train step's gradient
    # loss then saves the same cached matrix for backward
    x = _t(rng.uniform(size=(1, 23, 23, 1)))
    with torch.inference_mode():
        twarp.resize_bilinear(x, (7, 7))
    y = x.clone().requires_grad_()
    twarp.resize_bilinear(y, (7, 7)).sum().backward()
    assert y.grad is not None and torch.isfinite(y.grad).all()


def test_rgb_to_yuv(rng):
    x = _img(rng)
    np.testing.assert_allclose(timg.rgb_to_yuv(_t(x)).numpy(),
                               np.asarray(jimg.rgb_to_yuv(jnp.asarray(x))),
                               atol=1e-6)


def test_hsv_round_trip_matches_jax(rng):
    x = _img(rng, s=32)
    x[0, :4] = x[0, :4, :, :1]          # grays: diff = 0
    x[1, :2] = 0.0                      # black: max = 0
    hsv = timg.rgb_to_hsv(_t(x)).numpy()
    np.testing.assert_allclose(hsv, np.asarray(jimg.rgb_to_hsv(jnp.asarray(x))),
                               atol=1e-6)
    rgb = timg.hsv_to_rgb(_t(hsv)).numpy()
    np.testing.assert_allclose(rgb, np.asarray(jimg.hsv_to_rgb(jnp.asarray(hsv))),
                               atol=1e-6)
    np.testing.assert_allclose(rgb, x, atol=1e-5)


@pytest.mark.parametrize("factor", [0.5, 1.3, 2.0])
def test_adjust_saturation(rng, factor):
    x = (1.2 * _img(rng) - 0.1).astype(np.float32)   # clipped inside
    np.testing.assert_allclose(
        timg.adjust_saturation(_t(x), factor).numpy(),
        np.asarray(jimg.adjust_saturation(jnp.asarray(x), factor)), atol=1e-6)


def test_image_gradients_and_flip(rng):
    x = _img(rng, c=2)
    for a, b in zip(timg.image_gradients(_t(x)),
                    jimg.image_gradients(jnp.asarray(x))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(timg.flip_left_right(_t(x)).numpy(),
                                  np.asarray(jimg.flip_left_right(jnp.asarray(x))))


@pytest.mark.parametrize("src,dst", [(3, 64), (5, 32), (9, 32), (16, 16)])
def test_resize_nearest(rng, src, dst):
    x = rng.uniform(size=(2, src, src, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        timg.resize_nearest(_t(x), (dst, dst)).numpy(),
        np.asarray(jimg.resize_nearest(jnp.asarray(x), (dst, dst))))


@pytest.mark.parametrize("n,pad", [(16, 3), (16, 15), (8, 20), (20, 96)])
def test_reflect_pad_matches_jnp_pad(rng, n, pad):
    # including pads wider than the image (the ssscatter levels at 64 px)
    x = rng.uniform(size=(1, n, n, 1)).astype(np.float32)
    ref = np.pad(x, ((0, 0), (pad, pad), (pad, pad), (0, 0)), mode="reflect")
    np.testing.assert_array_equal(tfilt.reflect_pad(_t(x), pad).numpy(), ref)
    np.testing.assert_array_equal(
        ref, np.asarray(jnp.pad(jnp.asarray(x), ((0, 0), (pad, pad),
                                                 (pad, pad), (0, 0)),
                                mode="reflect")))


@pytest.mark.parametrize("sigma,max_radius", [(0.7, 4), (3.3, 8), (9.0, 32),
                                              (40.0, 96)])
def test_gaussian_blur(rng, sigma, max_radius):
    x = _img(rng, b=1, s=48, c=1)
    ref = np.asarray(jfilt.gaussian_blur(jnp.asarray(x), sigma,
                                         max_radius=max_radius))
    out = tfilt.gaussian_blur(_t(x), sigma, max_radius=max_radius).numpy()
    # f32 depthwise convolutions summed in another order
    np.testing.assert_allclose(out, ref, atol=2e-6)


def test_gaussian_blur_per_sample_sigma(rng):
    x = _img(rng, b=3, s=32, c=2)
    sigmas = np.array([0.5, 2.0, 6.5], np.float32)
    out = tfilt.gaussian_blur(_t(x), torch.from_numpy(sigmas), 16).numpy()
    for i, s in enumerate(sigmas):
        ref = np.asarray(jfilt.gaussian_blur(jnp.asarray(x[i:i + 1]), s, 16))
        np.testing.assert_allclose(out[i:i + 1], ref, atol=2e-6)


def test_dilate_and_find_edge(rng):
    mask = (rng.uniform(size=(2, 32, 32, 3)) > 0.8).astype(np.float32)
    mask[1] *= rng.uniform(size=(32, 32, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tfilt.dilate(_t(mask), 5).numpy(),
        np.asarray(jfilt.dilate(jnp.asarray(mask), 5)))
    np.testing.assert_array_equal(
        tfilt.find_edge(_t(mask)).numpy(),
        np.asarray(jfilt.find_edge(jnp.asarray(mask))))


@pytest.mark.parametrize("radius", [1, 4, 11])
def test_disc_blur(rng, radius):
    x = _img(rng, b=1, s=40, c=2)
    ref = np.asarray(jfilt.disc_blur(jnp.asarray(x[0]), radius))
    out = tfilt.disc_blur(_t(x), radius)[0].numpy()
    # two f32 FFT libraries (XLA's and pocketfft): ~1e-7 of the plane's sum
    np.testing.assert_allclose(out, ref, atol=2e-6)


def test_disc_blur_per_sample_radius(rng):
    x = _img(rng, b=2, s=32, c=1)
    out = tfilt.disc_blur(_t(x), torch.tensor([2.0, 7.0])).numpy()
    for i, r in enumerate((2, 7)):
        ref = np.asarray(jfilt.disc_blur(jnp.asarray(x[i]), r))
        np.testing.assert_allclose(out[i], ref, atol=2e-6)


def test_box_blur(rng):
    x = _img(rng, s=24)
    np.testing.assert_allclose(
        tfilt.box_blur(_t(x), 5).numpy(),
        np.asarray(jfilt.box_blur(jnp.asarray(x), 5)), atol=1e-6)
