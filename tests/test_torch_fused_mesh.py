"""The fused k-image UCB step over a mesh (eval/fused.py,
`build_fused_ucb_batch_step(..., mesh=)`) on a (2,) mesh of two CPU
entries: identical to the one-device step in f32, and within the port's
fused-eval bars of the JAX package's batched step on the same inputs."""

import jax
import numpy as np
import pytest
import torch

from blindshadowremoval_tpu.eval.fused import (
    PartInputs as JaxPartInputs,
    build_fused_ucb_batch_step as jax_batch_step,
)
from blindshadowremoval_tpu.eval.postprocess import (
    PostprocessParams as JaxParams,
)
from blindshadowremoval_tpu.models.generator import GSCGenerator as JaxGSC
from blindshadowremoval_tpu.models.tf_checkpoint import (
    generator_mapping as jax_mapping,
    load_weights_dict,
    synthetic_tf_weights as jax_synthetic,
)
from blindshadowremoval_tpu_torch.config import get_config
from blindshadowremoval_tpu_torch.eval.fused import (
    PartInputs,
    build_fused_ucb_batch_step,
    prep_part_inputs,
)
from blindshadowremoval_tpu_torch.eval.postprocess import PostprocessParams
from blindshadowremoval_tpu_torch.models import build_generator
from blindshadowremoval_tpu_torch.models.weights import from_jax_variables
from blindshadowremoval_tpu_torch.parallel.mesh import (
    batch_sharding,
    make_mesh,
)

S = 64
N_RES = 2
VIEWS = 2
OUT_NAMES = ("detected", "composite", "shadow map", "psnr", "ssim")


@pytest.fixture(autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def variables():
    """JAX GSC variables from the TF-golden recipe (synthetic_tf_weights
    seed 0, the RGB head bias lifted by 0.5), as numpy."""
    z = np.zeros((1, S, S, 3), np.float32)
    v = jax.jit(JaxGSC(n_res=N_RES).init)(jax.random.PRNGKey(0), z, z)
    mapping = jax_mapping(n_res=N_RES)
    weights = jax_synthetic(v, mapping, seed=0)
    weights["generator/clr_conv3/conv/bias"] += 0.5
    return jax.tree.map(np.asarray, load_weights_dict(weights, v, mapping))


@pytest.fixture(scope="module")
def mesh_setup(variables):
    """(one-device step, mesh step, mesh) over the same weights."""
    cfg = get_config("ucb", img_size=S, n_res=N_RES, compute_dtype="float32")
    sd = from_jax_variables(variables)
    mesh = make_mesh((2,), ("data",), devices=["cpu", "cpu"])
    gens = [build_generator(cfg, sd, d)
            for d in batch_sharding(mesh).devices]
    assert gens[0] is not gens[1]

    def forward(gen):
        return lambda views: gen(views["img"], views["uv"])

    params = PostprocessParams()
    one = build_fused_ucb_batch_step(forward(build_generator(cfg, sd, "cpu")),
                                     params, S)
    sharded = build_fused_ucb_batch_step([forward(g) for g in gens], params,
                                         S, mesh=mesh)
    return one, sharded, mesh


def _parts(rng):
    """The 7 part masks at S px: rectangles placed as chip_smoke's
    UCB_PARTS at 256 px, each moved by up to 2 px."""
    from chip_smoke import UCB_PARTS

    out = {}
    for key, ((a, b), (c, e)) in UCB_PARTS.items():
        dy, dx = rng.integers(-2, 3, 2)
        m = np.zeros((S, S, 3), np.float32)
        m[a // 4 + dy:b // 4 + dy, c // 4 + dx:e // 4 + dx] = 1.0
        out[key] = m
    return out


def _inputs(k, seed=0):
    """A k-image batch (numpy): views [k,V,S,S,3], sizes [k], PartInputs."""
    rng = np.random.default_rng(seed)
    batch = {key: rng.uniform(size=(k, VIEWS, S, S, 3)).astype(np.float32)
             for key in ("img", "uv", "gt")}
    batch["img"][:, :, 20:40, 16:40] *= 0.4          # a shadowed patch
    sizes = rng.integers(S // 2, S + 1, size=k).astype(np.float32)
    pis = PartInputs.stack([prep_part_inputs(_parts(rng), PostprocessParams())
                            for _ in range(k)])
    return batch, sizes, pis


def _run(step, k, seed=0):
    batch, sizes, pis = _inputs(k, seed)
    report: dict = {}
    out = step({key: torch.from_numpy(v) for key, v in batch.items()},
               torch.from_numpy(sizes), pis.to("cpu"), report)
    return [o.numpy() for o in out], report["label_iterations"]


@pytest.mark.parametrize("k", [4, 2])
def test_mesh_step_equals_one_device(mesh_setup, k):
    one, sharded, _ = mesh_setup
    ref, ref_iters = _run(one, k, seed=k)
    out, iters = _run(sharded, k, seed=k)
    for name, a, b in zip(OUT_NAMES, out, ref):
        assert a.shape[0] == k and a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    # the slowest shard's count: the one-device loop's
    assert iters == ref_iters
    assert out[0].any() and not out[0].all()     # some pixels detected


def test_mesh_step_refuses_a_k_the_mesh_does_not_divide(mesh_setup):
    _, sharded, mesh = mesh_setup
    with pytest.raises(ValueError, match="not divisible by the 2 shards"):
        _run(sharded, 3)
    with pytest.raises(ValueError, match="1 forwards for the 2 shards"):
        build_fused_ucb_batch_step([lambda views: None], PostprocessParams(),
                                   S, mesh=mesh)


def test_mesh_step_matches_jax(mesh_setup, variables):
    """The JAX package's batched step (vmap over the k images, one device)
    on the same inputs, within the port's fused-eval bars
    (tests/test_torch_eval_ucb.py)."""
    _, sharded, _ = mesh_setup
    k = 4
    out, _ = _run(sharded, k)
    batch, sizes, pis = _inputs(k)
    gen = JaxGSC(n_res=N_RES)
    step = jax_batch_step(
        lambda v, b: gen.apply(v, b["img"], b["uv"], None, train=False),
        JaxParams(), S)
    jpi = JaxPartInputs(**{name: getattr(pis, name)
                           for name in pis.__dataclass_fields__})
    ref = [np.asarray(o) for o in step(variables, batch, sizes, jpi)]
    assert np.mean(out[0] != ref[0]) <= 1e-3
    assert np.abs(out[1].astype(int) - ref[1].astype(int)).max() <= 1
    np.testing.assert_allclose(out[3], ref[3], atol=0.01)
    np.testing.assert_allclose(out[4], ref[4], atol=1e-4)
