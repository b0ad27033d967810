"""Port's ShadowRemovalService (eval/serving.py) against the JAX service on
the same weights and requests, on the CPU at 128 px, f32, batch 2: three
requests make one full batch and one padded tail."""

import jax
import numpy as np
import pytest
import torch

from blindshadowremoval_tpu.config import get_config as jax_config
from blindshadowremoval_tpu.eval.serving import (
    ShadowRemovalService as JaxService,
)
from blindshadowremoval_tpu.geometry.landmarks import LM_REF
from blindshadowremoval_tpu.models.tf_checkpoint import (
    generator_mapping,
    load_weights_dict,
    synthetic_tf_weights,
)
from blindshadowremoval_tpu.train.trainer import build_generator
from blindshadowremoval_tpu_torch.config import get_config
from blindshadowremoval_tpu_torch.eval.serving import ShadowRemovalService
from blindshadowremoval_tpu_torch.models.weights import from_jax_variables

S = 128
N_RES = 2      # two ResBottlenecks: one per half of the generator


@pytest.fixture(scope="module")
def variables():
    cfg = jax_config("in_the_wild", img_size=S, compute_dtype="float32",
                     n_res=N_RES)
    z = np.zeros((1, 64, 64, 3), np.float32)
    v = jax.jit(build_generator(cfg).init)(
        jax.random.PRNGKey(0), z, z, np.zeros((1, 64, 64, 6), np.float32))
    mapping = generator_mapping(n_res=N_RES)
    weights = synthetic_tf_weights(v, mapping, seed=0)
    weights["generator/clr_conv3/conv/bias"] += 0.5
    return jax.tree.map(np.asarray, load_weights_dict(weights, v, mapping))


@pytest.fixture(scope="module")
def requests():
    rng = np.random.default_rng(0)
    images, lms = [], []
    for i in range(3):
        images.append(rng.uniform(size=(220 + 10 * i, 200, 3)).astype(
            np.float32))
        lms.append((LM_REF * 130 + 35 + rng.normal(scale=1.0, size=(68, 2))
                    ).astype(np.float32))
    return images, lms


@pytest.mark.parametrize("device_geometry,compact", [
    (True, False),     # the serving default: maps rasterized on the device
    (False, False),    # host-rasterized maps
    (True, True),      # uint16 ingress, uint8 / f16 egress
])
def test_service_matches_jax(variables, requests, device_geometry, compact):
    images, lms = requests
    wires = dict(device_geometry=device_geometry, compact_output=compact,
                 compact_ingress=compact)
    ref = JaxService(jax_config("in_the_wild", img_size=S,
                                compute_dtype="float32", n_res=N_RES),
                     variables, batch_size=2, **wires).remove_shadows(
        images, lms)
    svc = ShadowRemovalService(
        get_config(img_size=S, compute_dtype="float32", n_res=N_RES,
                   compact_output=compact, compact_ingress=compact),
        from_jax_variables(variables), batch_size=2, device="cpu",
        device_geometry=device_geometry)
    out = svc.remove_shadows(images, lms)
    assert len(out) == len(ref) == 3
    for ours, theirs in zip(out, ref):
        assert ours["pred"].shape == (S, S, 3)
        assert ours["mask_pred"].shape == (S, S, 1)
        np.testing.assert_array_equal(ours["box"], theirs["box"])
        # f32 end to end: the crops differ by ~1e-6 (numpy vs the JAX
        # package's g++ resampler), the maps and the generator by float
        # summation order.  Compact egress quantizes pred to 1/255 steps,
        # so a value on a rounding edge moves by one step.
        atol = 1.0 / 255 + 1e-6 if compact else 1e-4
        np.testing.assert_allclose(ours["pred"], theirs["pred"], atol=atol)
        # mask_pred leaves as f16 when compact: 2^-11 relative
        np.testing.assert_allclose(ours["mask_pred"],
                                   np.asarray(theirs["mask_pred"], np.float32),
                                   atol=2e-3 if compact else 1e-4)


def test_service_raises_when_batch_overflows(variables):
    svc = ShadowRemovalService(
        get_config(img_size=S, compute_dtype="float32", n_res=N_RES),
        from_jax_variables(variables), batch_size=2, device="cpu")
    with pytest.raises(ValueError, match="exceeds batch_size"):
        svc.stage([{}] * 3)


@pytest.mark.parametrize("device_geometry", [True, False])
def test_bf16_egress_arrives_bf16_exact(variables, requests, device_geometry):
    # numpy has no bf16: the port hands a bf16 egress to the host as f32
    # arrays that hold bf16 values (the JAX service returns ml_dtypes bf16
    # arrays); every pred value must survive a round trip through bf16.
    # mask_pred is the bf16 map times the f32 face map, promoted to f32 in
    # both packages.
    images, lms = requests
    svc = ShadowRemovalService(
        get_config(img_size=S, compute_dtype="bfloat16", fold_bn=True,
                   egress_dtype="bfloat16", n_res=N_RES),
        from_jax_variables(variables), batch_size=2, device="cpu",
        device_geometry=device_geometry)
    out = svc.remove_shadows(images, lms)
    assert len(out) == 3
    for r in out:
        pred = torch.from_numpy(r["pred"])
        assert pred.dtype == torch.float32 and pred.shape == (S, S, 3)
        assert torch.equal(pred, pred.to(torch.bfloat16).float())
        assert r["mask_pred"].dtype == np.float32
