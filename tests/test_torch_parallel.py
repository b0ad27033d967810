"""The port's meshes and single-process helpers (parallel/mesh.py,
parallel/distributed.py), its `Config` mesh fields and
`ShadowRemovalService(mesh=...)` against the JAX package, on the CPU.  The
JAX side runs on the tests' 8 virtual CPU devices; the port's CPU meshes
list the CPU device once per position.  The runs over several processes
are in tests/test_torch_distributed.py."""

import jax
import numpy as np
import pytest
import torch

from blindshadowremoval_tpu.config import get_config as jax_config
from blindshadowremoval_tpu.eval.serving import (
    ShadowRemovalService as JaxService,
)
from blindshadowremoval_tpu.parallel import distributed as jdist
from blindshadowremoval_tpu.parallel import mesh as jmesh
from blindshadowremoval_tpu.train.trainer import build_generator
from blindshadowremoval_tpu_torch.config import get_config
from blindshadowremoval_tpu_torch.eval.serving import ShadowRemovalService
from blindshadowremoval_tpu_torch.models.generator_tsm import ShareLayer
from blindshadowremoval_tpu_torch.models.weights import from_jax_variables
from blindshadowremoval_tpu_torch.parallel import distributed, mesh

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _threads():
    """Six test workers share the machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _cpus(n):
    return [CPU] * n


@pytest.mark.parametrize("shape,names", [((4, 2), ("data", "frame")),
                                         ((8, 1), ("data", "frame")),
                                         ((8,), ("data",)),
                                         (None, ("data", "frame"))])
def test_mesh_shapes_match_jax(shape, names):
    ref = jmesh.make_mesh(shape, names)
    got = mesh.make_mesh(shape, names, devices=_cpus(8))
    assert got.shape == dict(ref.shape)
    assert got.size == ref.size == 8
    assert got.axis_names == tuple(ref.axis_names)
    assert all(d == CPU for d in got.devices.flat)


@pytest.mark.parametrize("shape", [(4, 4), (3, 2), (16,)])
def test_make_mesh_refuses_a_shape_the_devices_cannot_fill(shape):
    names = ("data", "frame")[:len(shape)]
    with pytest.raises(ValueError) as ref:
        jmesh.make_mesh(shape, names)
    with pytest.raises(ValueError) as got:
        mesh.make_mesh(shape, names, devices=_cpus(8))
    assert str(got.value) == str(ref.value)


def test_make_mesh_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_mesh((1, 1))


@pytest.mark.parametrize("frame_axis", [False, True])
def test_batch_sharding_specs_match_jax(frame_axis):
    ref = jmesh.batch_sharding(jmesh.make_mesh((4, 2)),
                               frame_axis=frame_axis)
    m = mesh.make_mesh((4, 2), devices=_cpus(8))
    got = mesh.batch_sharding(m, frame_axis=frame_axis)
    assert tuple(got.spec) == tuple(ref.spec)
    assert got.num_shards == (8 if frame_axis else 4)
    assert tuple(mesh.replicate(m).spec) == tuple(
        jmesh.replicate(jmesh.make_mesh((4, 2))).spec) == ()
    assert mesh.replicate(m).num_shards == 1


def test_shard_batch_and_gather_round_trip():
    m = mesh.make_mesh((2, 2), devices=_cpus(4))
    x = torch.arange(24.0).reshape(8, 3)
    for sharding, n in ((mesh.batch_sharding(m), 2),
                        (mesh.batch_sharding(m, frame_axis=True), 4),
                        (mesh.replicate(m), 1)):
        parts = mesh.shard_batch(x, sharding)
        assert len(parts) == n and len(sharding.devices) == n
        # contiguous row blocks, in order
        assert torch.equal(parts[-1], x[-8 // n:])
        assert torch.equal(mesh.gather(parts), x)
    with pytest.raises(ValueError, match="not divisible"):
        mesh.shard_batch(torch.zeros(6, 1),
                         mesh.batch_sharding(m, frame_axis=True))


def test_shard_devices_follow_the_split_axis():
    """Shard i lies on the device at data index i (frame index 0), as JAX
    places P("data")'s block i on the mesh's row i."""
    devs = [torch.device("cpu", i) for i in range(4)]
    m = mesh.Mesh(np.array(devs, dtype=object).reshape(2, 2),
                  ("data", "frame"))
    assert mesh.batch_sharding(m).devices == [devs[0], devs[2]]
    assert mesh.batch_sharding(m, frame_axis=True).devices == devs
    by_frame = mesh.NamedSharding(m, mesh.P("frame"))
    assert by_frame.devices == [devs[0], devs[1]]


@pytest.mark.parametrize("global_batch", [8, 12, 1])
def test_host_local_batch_on_one_process_matches_jax(global_batch):
    assert distributed.host_local_batch(global_batch) == \
        jdist.host_local_batch(global_batch) == (global_batch, 0)


def test_initialize_is_a_noop_for_one_process(monkeypatch):
    monkeypatch.setattr(distributed._LOCAL, "device", None)
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                 "LOCAL_RANK", "JAX_COORDINATOR_ADDRESS",
                 "JAX_NUM_PROCESSES"):
        monkeypatch.delenv(name, raising=False)
    for args in ((), ("127.0.0.1:1", 1, 0), (None, 4, 0)):
        assert jdist.initialize(*args) is None
        assert distributed.initialize(*args, device="cpu") is None
        assert not torch.distributed.is_initialized()
    # torchrun's environment of a one-process job
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1")
    monkeypatch.setenv("WORLD_SIZE", "1")
    distributed.initialize(device="cpu")
    assert not torch.distributed.is_initialized()
    # the one-process mesh: every helper answers as for one device
    gm = distributed.global_mesh()
    assert gm.shape == {"data": 1, "frame": 1} and gm.rank == 0
    assert gm.local_device == CPU
    assert mesh.batch_group() is None
    with gm:
        assert mesh.active_mesh() is gm and mesh.batch_group() is None
    assert mesh.active_mesh() is None
    shard = distributed.make_global_array(np.zeros((4, 2)), gm,
                                          mesh.P(("data", "frame")))
    assert (shard.offset, shard.global_rows) == (0, 4)


def test_local_device_defaults_to_cuda(monkeypatch):
    # as every entry point of the port: CUDA unless the caller asks for the
    # CPU, cuda:LOCAL_RANK under torchrun, and the CPU only when asked for
    for name in ("MASTER_ADDR", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(distributed._LOCAL, "device", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert distributed.local_device() == torch.device("cuda")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert distributed.local_device() == torch.device("cuda", 1)
    # a one-process initialize records the device before it returns
    distributed.initialize()
    assert not torch.distributed.is_initialized()
    assert distributed.local_device() == torch.device("cuda", 1)
    assert distributed.global_mesh().local_device == torch.device("cuda", 1)
    distributed.initialize(device="cpu")
    assert distributed.global_mesh().local_device == CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(distributed._LOCAL, "device", None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        distributed.local_device()


@pytest.mark.parametrize("shape", [(2, 1), (2, 2), (1, 4)])
def test_config_accepts_meshes(shape):
    cfg = get_config(mesh_shape=shape)
    ref = jax_config(mesh_shape=shape)
    assert cfg.mesh_shape == tuple(ref.mesh_shape) == shape
    assert cfg.mesh_axis_names == tuple(ref.mesh_axis_names)
    # checked where a mesh is built: 2 devices fill (2, 1) only
    if shape == (2, 1):
        m = mesh.make_mesh(cfg.mesh_shape, cfg.mesh_axis_names,
                           devices=_cpus(2))
        assert m.shape == {"data": 2, "frame": 1}
    else:
        with pytest.raises(ValueError, match="!= 2 devices"):
            mesh.make_mesh(cfg.mesh_shape, cfg.mesh_axis_names,
                           devices=_cpus(2))
    # a list, as the JAX Config takes it, is kept hashable
    assert hash(get_config(mesh_shape=list(shape))) == hash(cfg)


def test_collective_share_layer_needs_a_mesh_over_processes():
    x = torch.randn(2, 4, 8, 8)
    reg = torch.zeros(2, 32, 32, 6)
    layer = ShareLayer(axis_name="frame")
    with pytest.raises(RuntimeError, match="with mesh:"):
        layer(x, reg, frame=1)
    with mesh.make_mesh((1, 2), devices=_cpus(2)):
        with pytest.raises(RuntimeError, match="global_mesh"):
            layer(x, reg, frame=1)
    # the gate off needs no collective
    torch.testing.assert_close(layer(x, reg, 1, share=False),
                               torch.cat([x, x], 1), rtol=0, atol=0)


# ------------------------------------------------------- the service mesh
S = 64
N_RES = 2


@pytest.fixture(scope="module")
def service_case():
    """JAX init variables of a 64 px, n_res=2 GSC generator, 13 synthetic
    requests (tests/test_sharding.py:94-121's) and the JAX one-device
    service's outputs on them."""
    cfg = jax_config("in_the_wild", img_size=S, compute_dtype="float32",
                     n_res=N_RES)
    z = np.zeros((1, S, S, 3), np.float32)
    variables = jax.tree.map(np.asarray, jax.jit(build_generator(cfg).init)(
        jax.random.PRNGKey(0), z, z, np.zeros((1, S, S, 6), np.float32)))
    rng = np.random.default_rng(0)
    img = rng.uniform(size=(400, 400, 3)).astype(np.float32)
    lm = rng.uniform(120, 280, size=(68, 2)).astype(np.float32)
    images, lms = [img] * 13, [lm] * 13
    ref = JaxService(cfg, variables, batch_size=8).remove_shadows(images, lms)
    return variables, images, lms, ref


def test_service_over_a_two_device_mesh_matches_one_device_and_jax(
        service_case):
    variables, images, lms, jax_out = service_case
    cfg = get_config(img_size=S, n_res=N_RES, compute_dtype="float32")
    sd = from_jax_variables(variables)
    one = ShadowRemovalService(cfg, sd, batch_size=8, device="cpu")
    two = ShadowRemovalService(cfg, sd, batch_size=8,
                               mesh=mesh.make_mesh((2,), ("data",),
                                                   devices=_cpus(2)))
    assert two.device == CPU and len(two._replicas) == 2
    # one full batch of 8 and a padded tail of 5, both through the mesh
    ref = one.remove_shadows(images, lms)
    out = two.remove_shadows(images, lms)
    assert len(out) == len(ref) == len(jax_out) == 13
    for o, r, j in zip(out, ref, jax_out):
        for key in ("pred", "mask_pred"):
            np.testing.assert_allclose(o[key], r[key], rtol=0, atol=2e-5)
            np.testing.assert_allclose(o[key], np.asarray(j[key]), rtol=0,
                                       atol=2e-5)
        np.testing.assert_array_equal(o["box"], r["box"])


def test_service_mesh_refuses_a_batch_it_cannot_split(service_case):
    cfg = get_config(img_size=S, n_res=N_RES, compute_dtype="float32")
    m = mesh.make_mesh((2, 2), devices=_cpus(4))
    with pytest.raises(ValueError,
                       match="batch_size 6 not divisible by the 4-device"):
        ShadowRemovalService(cfg, None, batch_size=6, mesh=m)
    svc = ShadowRemovalService(cfg, from_jax_variables(service_case[0]),
                               batch_size=8, mesh=m)
    # split over "data" (2 shards): a replica on each shard's device
    assert len(svc._replicas) == 2
