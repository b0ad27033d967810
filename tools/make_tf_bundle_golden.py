"""Write the TF tensor-bundle fixture that the port's bundle reader is held
against (tests/test_torch_tf_checkpoint.py, chip_smoke.py phase 17).

TensorFlow writes the bundle itself (`tf.raw_ops.SaveV2`), under the real
checkpoints' `<name>/.ATTRIBUTES/VARIABLE_VALUE` keys, so the fixture is in
exactly the format of the reference's log/*/ckpt-* files.  It holds
`synthetic_tf_weights(seed=0)` (a pure function of the TF name and the
seed, so a reader needs no second copy of the values) for:

  * the whole discriminator trio (`discriminator_mapping()`);
  * the generator's conv1, its conv2/conv3 heads (the slices of the port's
    fused `head`) and one transposed conv, up3;

plus a `save_counter` int64 scalar and a `_CHECKPOINTABLE_OBJECT_GRAPH`
string entry, as `tf.train.Checkpoint` writes them.  TF's table blocks
hold 256 KiB, so that whole index is one data block; a second bundle,
`many-1`, holds MANY_TENSORS two-element tensors (tensor i is [i, -i])
whose index spans two.  `manifest.json` records `tf.train.list_variables`
of both.

Needs TensorFlow and the JAX package (for the variable shapes and the
synthetic values); the port and its reader need neither.

    python tools/make_tf_bundle_golden.py
"""

from __future__ import annotations

import json
import os
import shutil
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_DIR = os.path.join(REPO, "tests", "goldens", "tf_bundle")
PREFIX = os.path.join(OUT_DIR, "ckpt-1")
VAL_SUFFIX = "/.ATTRIBUTES/VARIABLE_VALUE"
SEED = 0
# the generator layers in the fixture: conv1, the two heads, one ConvT
GENERATOR_LAYERS = ("generator/conv1/", "generator/conv2/",
                    "generator/conv3/", "generator/up3/")
OBJECT_GRAPH = b"fixture: no object graph"
MANY_PREFIX = os.path.join(OUT_DIR, "many-1")
MANY_TENSORS = 4500


def many_name(i: int) -> str:
    return f"generator/res_stack/{i}/conv/kernel{VAL_SUFFIX}"


def fixture_weights() -> dict:
    """{tf_name: float32 array} of the fixture, from the JAX package."""
    import jax

    from blindshadowremoval_tpu.models.discriminator import (
        MultiScaleDiscriminators,
    )
    from blindshadowremoval_tpu.models.generator import GSCGenerator
    from blindshadowremoval_tpu.models.tf_checkpoint import (
        discriminator_mapping,
        generator_mapping,
        synthetic_tf_weights,
    )

    key = jax.random.PRNGKey(0)
    z = np.zeros((1, 64, 64, 3), np.float32)
    gen_vars = GSCGenerator(n_res=2).init(key, z, z)
    disc_vars = MultiScaleDiscriminators().init(
        key, np.zeros((2, 64, 64, 6), np.float32))
    gen_map = [e for e in generator_mapping("gsc", n_res=2)
               if e[1].startswith(GENERATOR_LAYERS)]
    out = synthetic_tf_weights(disc_vars, discriminator_mapping(), SEED)
    out.update(synthetic_tf_weights(gen_vars, gen_map, SEED))
    return out


def main() -> None:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, REPO)
    import tensorflow as tf

    weights = fixture_weights()
    names = [n + VAL_SUFFIX for n in weights]
    tensors = [tf.constant(v) for v in weights.values()]
    names.append("save_counter" + VAL_SUFFIX)
    tensors.append(tf.constant(1, tf.int64))
    names.append("_CHECKPOINTABLE_OBJECT_GRAPH")
    tensors.append(tf.constant(OBJECT_GRAPH))
    shutil.rmtree(OUT_DIR, ignore_errors=True)
    os.makedirs(OUT_DIR)
    tf.raw_ops.SaveV2(prefix=PREFIX, tensor_names=names,
                      shape_and_slices=[""] * len(names), tensors=tensors)
    tf.raw_ops.SaveV2(
        prefix=MANY_PREFIX,
        tensor_names=[many_name(i) for i in range(MANY_TENSORS)],
        shape_and_slices=[""] * MANY_TENSORS,
        tensors=[tf.constant([i, -i], tf.float32)
                 for i in range(MANY_TENSORS)])
    listed = tf.train.list_variables(PREFIX)
    assert tf.train.list_variables(MANY_PREFIX) == sorted(
        (many_name(i), [2]) for i in range(MANY_TENSORS))
    lines = [json.dumps([n, list(s)]) for n, s in listed]
    with open(os.path.join(OUT_DIR, "manifest.json"), "w") as f:
        f.write('{"seed": %d, "many": %d, "variables": [\n%s\n]}\n'
                % (SEED, MANY_TENSORS, ",\n".join(lines)))
    size = sum(os.path.getsize(os.path.join(OUT_DIR, n))
               for n in os.listdir(OUT_DIR))
    print(f"wrote {len(listed)} + {MANY_TENSORS} entries, {size} bytes, "
          f"to {OUT_DIR}")


if __name__ == "__main__":
    main()
