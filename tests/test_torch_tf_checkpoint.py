"""The port's TF checkpoint reader (models/tf_checkpoint.py) and the
discriminator mapping (models/weights.py) against the committed bundle
fixture (tools/make_tf_bundle_golden.py) and the JAX package's bridge."""

import json
import os
import shutil
import struct

import jax
import numpy as np
import pytest
import torch

from blindshadowremoval_tpu.models.discriminator import (
    MultiScaleDiscriminators as JaxDiscs,
)
from blindshadowremoval_tpu.models.tf_checkpoint import (
    discriminator_mapping as jax_disc_mapping,
    load_weights_dict,
    synthetic_tf_weights as jax_synthetic,
)
from blindshadowremoval_tpu_torch.models import tf_checkpoint
from blindshadowremoval_tpu_torch.models.discriminator import (
    MultiScaleDiscriminators,
)
from blindshadowremoval_tpu_torch.models.generator import GSCGenerator
from blindshadowremoval_tpu_torch.models.tf_checkpoint import (
    VAL_SUFFIX,
    list_variables,
    load_tf_checkpoint,
    read_bundle,
    verify_against_index,
)
from blindshadowremoval_tpu_torch.models.weights import (
    discriminator_from_jax,
    discriminator_mapping,
    generator_mapping,
    load_tf_weights,
    synthetic_tf_weights,
)

FIXTURE = os.path.join(os.path.dirname(__file__), "goldens", "tf_bundle")
PREFIX = os.path.join(FIXTURE, "ckpt-1")
MANY = os.path.join(FIXTURE, "many-1")
# the generator layers the fixture holds (tools/make_tf_bundle_golden.py)
GEN_LAYERS = ("generator/conv1/", "generator/conv2/", "generator/conv3/",
              "generator/up3/")


def _manifest():
    with open(os.path.join(FIXTURE, "manifest.json")) as f:
        return json.load(f)


def _gen_mapping():
    return [e for e in generator_mapping("gsc", n_res=2)
            if e[1].startswith(GEN_LAYERS)]


def _expected():
    """{tf_name: array} the fixture holds: synthetic_tf_weights(seed=0), a
    pure function of the name and the seed."""
    out = synthetic_tf_weights(MultiScaleDiscriminators().state_dict(),
                               discriminator_mapping(), 0)
    out.update(synthetic_tf_weights(GSCGenerator(n_res=2).state_dict(),
                                    _gen_mapping(), 0))
    return out


def test_reader_is_bitwise_the_synthetic_values():
    got = read_bundle(PREFIX)
    want = _expected()
    assert set(got) == {n + VAL_SUFFIX for n in want} | {
        "save_counter" + VAL_SUFFIX}
    for name, value in want.items():
        a = got[name + VAL_SUFFIX]
        assert a.dtype == np.float32 and a.shape == value.shape, name
        np.testing.assert_array_equal(a, value, err_msg=name)
    counter = got["save_counter" + VAL_SUFFIX]
    assert counter.dtype == np.int64 and counter.shape == () and counter == 1


def test_list_variables_equals_the_manifest():
    listed = list_variables(PREFIX)
    assert listed == [(n, s) for n, s in _manifest()["variables"]]
    # the object graph is listed, as tf.train.list_variables lists it
    assert ("_CHECKPOINTABLE_OBJECT_GRAPH", []) in listed


def test_index_over_two_blocks():
    """TF's table blocks hold 256 KiB: `many-1`'s index spans two data
    blocks, every entry read back in order."""
    n = _manifest()["many"]
    num_shards, entries = tf_checkpoint.read_index(MANY)
    assert num_shards == 1 and len(entries) == n
    with open(MANY + ".index", "rb") as f:
        data = f.read()
    footer = data[-tf_checkpoint.FOOTER_BYTES:]
    _, pos = tf_checkpoint._varint(footer, 0)
    _, pos = tf_checkpoint._varint(footer, pos)
    index = tf_checkpoint._block(data, footer[pos:])
    assert len(list(tf_checkpoint._block_entries(index))) == 2
    got = read_bundle(MANY)
    for i in range(n):
        name = f"generator/res_stack/{i}/conv/kernel{VAL_SUFFIX}"
        np.testing.assert_array_equal(got[name], [i, -i])


def test_discriminator_mapping_matches_jax():
    """The port's mapping names the JAX mapping's TF tensors in its order,
    and its loaded state_dict equals `discriminator_from_jax` of JAX's
    `load_weights_dict` on the same synthetic weights."""
    mapping = discriminator_mapping()
    jax_map = jax_disc_mapping()
    assert [tf for _, tf, _ in mapping] == [e[1] for e in jax_map]
    variables = jax.jit(JaxDiscs().init)(
        jax.random.PRNGKey(0), np.zeros((2, 64, 64, 6), np.float32))
    weights = jax_synthetic(variables, jax_map, seed=0)
    ported = synthetic_tf_weights(MultiScaleDiscriminators().state_dict(),
                                  mapping, 0)
    assert set(ported) == set(weights)
    for name in weights:
        np.testing.assert_array_equal(ported[name], weights[name])
    ref = discriminator_from_jax(jax.tree.map(
        np.asarray, load_weights_dict(weights, variables, jax_map)))
    got = load_tf_weights(weights, mapping)
    sd = MultiScaleDiscriminators().state_dict()
    assert set(got) == set(ref) == set(sd)
    for name in ref:
        torch.testing.assert_close(got[name], ref[name], rtol=0, atol=0,
                                   msg=name)
    MultiScaleDiscriminators().load_state_dict(got)


def test_load_tf_checkpoint_restores_the_fixture():
    disc = load_tf_checkpoint(PREFIX, discriminator_mapping())
    want = load_tf_weights(_expected(), discriminator_mapping())
    MultiScaleDiscriminators().load_state_dict(disc)
    for name in want:
        torch.testing.assert_close(disc[name], want[name], rtol=0, atol=0)
    gen = load_tf_checkpoint(PREFIX, _gen_mapping())
    sd = GSCGenerator(n_res=2).state_dict()
    assert {"conv1.conv.weight", "head.conv.weight", "head.conv.bias",
            "up3.conv.weight", "up3.bn.running_var"} <= set(gen)
    for name, t in gen.items():
        assert t.shape == sd[name].shape, name
    # the two 1-channel TF heads land in the fused head's channels
    np.testing.assert_array_equal(
        gen["head.conv.weight"][1].numpy(),
        _expected()["generator/conv3/conv/kernel"][..., 0].transpose(2, 0, 1))


def test_verify_against_index_on_the_fixture():
    disc = verify_against_index(PREFIX, MultiScaleDiscriminators().state_dict(),
                                discriminator_mapping())
    assert disc["matched"] == len(discriminator_mapping()) == 78
    assert disc["missing_in_tf"] == [] and disc["shape_mismatch"] == []
    # the generator's covered layers, and nothing but save_counter and the
    # object graph left unmapped (both dropped, as JAX drops them)
    assert disc["unmapped_tf"] == sorted(
        e[1] for e in _gen_mapping())
    gen = verify_against_index(PREFIX, GSCGenerator(n_res=2).state_dict(),
                               generator_mapping("gsc", n_res=2))
    assert gen["matched"] == len(_gen_mapping()) == 16
    assert set(gen["missing_in_tf"]) == {
        e[1] for e in generator_mapping("gsc", n_res=2)} - {
        e[1] for e in _gen_mapping()}
    assert gen["shape_mismatch"] == []
    # a model of other widths: every covered tensor mismatches
    wide = verify_against_index(PREFIX,
                                MultiScaleDiscriminators(in_ch=3).state_dict(),
                                discriminator_mapping())
    assert [m[0] for m in wide["shape_mismatch"]] == [
        f"discriminator_{d}/conv_stack/0/conv/kernel" for d in (1, 2, 3)]
    assert wide["shape_mismatch"][0][1:] == ((4, 4, 6, 32), (32, 3, 4, 4))


def test_stripped_data_raises(tmp_path):
    prefix = str(tmp_path / "ckpt-1")
    shutil.copy(PREFIX + ".index", prefix + ".index")
    # the index alone lists and verifies
    assert list_variables(prefix) == list_variables(PREFIX)
    with pytest.raises(RuntimeError, match="ships index files only"):
        load_tf_checkpoint(prefix, discriminator_mapping())
    # a truncated shard is a stripped blob as well
    with open(PREFIX + ".data-00000-of-00001", "rb") as f:
        data = f.read()
    with open(prefix + ".data-00000-of-00001", "wb") as f:
        f.write(data[:len(data) // 2])
    with pytest.raises(RuntimeError, match="cannot read 'discriminator_"):
        load_tf_checkpoint(prefix, discriminator_mapping())


def test_compressed_block_raises(tmp_path):
    """A block whose trailer's compression byte is not 0 (snappy is 1)."""
    with open(PREFIX + ".index", "rb") as f:
        data = bytearray(f.read())
    footer = bytes(data[-tf_checkpoint.FOOTER_BYTES:])
    _, pos = tf_checkpoint._varint(footer, 0)
    _, pos = tf_checkpoint._varint(footer, pos)
    offset, p2 = tf_checkpoint._varint(footer, pos)
    size, _ = tf_checkpoint._varint(footer, p2)
    assert data[offset + size] == 0           # TF writes them uncompressed
    data[offset + size] = 1
    prefix = str(tmp_path / "ckpt-1")
    with open(prefix + ".index", "wb") as f:
        f.write(bytes(data))
    with pytest.raises(ValueError, match=r"compressed \(type 1\)"):
        list_variables(prefix)
    # and a file that is no table at all
    with open(prefix + ".index", "wb") as f:
        f.write(bytes(data[:-8]) + struct.pack("<Q", 0))
    with pytest.raises(ValueError, match="bad table magic"):
        list_variables(prefix)


@pytest.mark.slow    # imports TensorFlow, as tests/test_tf_checkpoint.py
def test_whole_gsc_bundle_round_trip_against_jax(tmp_path):
    """A whole GSC generator written by TF, loaded through the port's
    reader and through JAX's `load_tf_checkpoint`: the f32 forwards agree
    within tests/test_torch_generator.py's 2e-5."""
    tf = pytest.importorskip("tensorflow")
    from blindshadowremoval_tpu.models.generator import GSCGenerator as JaxGSC
    from blindshadowremoval_tpu.models.tf_checkpoint import (
        generator_mapping as jax_gen_mapping,
        load_tf_checkpoint as jax_load,
    )

    gen = JaxGSC(n_res=2)
    rng = np.random.default_rng(123)
    img = rng.uniform(size=(1, 64, 64, 3)).astype(np.float32)
    uv = rng.uniform(size=(1, 64, 64, 3)).astype(np.float32)
    variables = gen.init(jax.random.PRNGKey(0), img, uv)
    jax_map = jax_gen_mapping("gsc", n_res=2)
    weights = jax_synthetic(variables, jax_map, seed=0)
    prefix = str(tmp_path / "ckpt-2")
    tf.raw_ops.SaveV2(prefix=prefix,
                      tensor_names=[n + VAL_SUFFIX for n in weights],
                      shape_and_slices=[""] * len(weights),
                      tensors=[tf.constant(v) for v in weights.values()])
    ref = gen.apply(jax_load(prefix, variables, jax_map), img, uv)
    model = GSCGenerator(n_res=2).eval()
    mapping = generator_mapping("gsc", n_res=2)
    assert verify_against_index(prefix, model.state_dict(), mapping)[
        "matched"] == len(mapping)
    model.load_state_dict(load_tf_checkpoint(prefix, mapping))
    with torch.no_grad():
        out = model(torch.from_numpy(img), torch.from_numpy(uv))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5)
