"""TF checkpoints without TensorFlow (port of
`blindshadowremoval_tpu/models/tf_checkpoint.py`: `verify_against_index`,
`load_tf_checkpoint`).

A `tf.train.Checkpoint` is a tensor bundle: `<prefix>.index`, a LevelDB
table (SSTable) mapping each tensor's name to a `BundleEntryProto`, and
`<prefix>.data-<shard>-of-<shards>`, the tensors' raw little-endian bytes.
This module reads both in plain Python and numpy:

  * the table from its end: the 48-byte footer holds the block handles of
    the metaindex and index blocks and the magic number; the index block's
    values are the handles of the data blocks; every block is entries with
    prefix-compressed keys (varints shared / non-shared / value length),
    then a uint32 restart array and its count, and is followed by a 5-byte
    trailer (the compression type, then a crc);
  * the key "" holds the `BundleHeaderProto` (num_shards, endianness),
    every other key a `BundleEntryProto` (dtype, shape, shard_id, offset,
    size), each decoded by a minimal protobuf wire-format reader.

Only uncompressed blocks are read (TensorFlow writes bundles so); any other
compression type raises.  The entries' crc32c is not checked (TF's own
reader checks it); the size of every tensor read is checked against its
shape and dtype.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np
import torch

from blindshadowremoval_tpu_torch.models.weights import _tf_shape, load_tf_weights

VAL_SUFFIX = "/.ATTRIBUTES/VARIABLE_VALUE"
TABLE_MAGIC = 0xDB4775248B80FB57
FOOTER_BYTES = 48
BLOCK_TRAILER_BYTES = 5     # compression type (1 byte) + crc32c (4)
DT_STRING = 7
# TF's DataType enum -> numpy, for the numeric types a checkpoint holds
DTYPES = {1: np.float32, 2: np.float64, 3: np.int32, 4: np.uint8,
          5: np.int16, 6: np.int8, 9: np.int64, 10: np.bool_,
          17: np.uint16, 19: np.float16, 22: np.uint32, 23: np.uint64}


@dataclasses.dataclass(frozen=True)
class BundleEntry:
    """One tensor's `BundleEntryProto`: where its bytes lie."""

    dtype: int
    shape: tuple
    shard_id: int
    offset: int
    size: int
    sliced: bool


# ----------------------------------------------------------- wire format
def _varint(buf: bytes, pos: int) -> tuple[int, int]:
    """(value, next position) of the varint at buf[pos]."""
    value = shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos]
        value |= (b & 0x7F) << shift
        pos += 1
        if b < 0x80:
            return value, pos
        shift += 7


def _fields(buf: bytes):
    """(field number, wire type, value) of each field of a protobuf
    message: an int for varint (0), fixed64 (1) and fixed32 (5), bytes for
    length-delimited (2)."""
    pos = 0
    while pos < len(buf):
        key, pos = _varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _varint(buf, pos)
        elif wire == 1:
            value, pos = struct.unpack_from("<Q", buf, pos)[0], pos + 8
        elif wire == 5:
            value, pos = struct.unpack_from("<I", buf, pos)[0], pos + 4
        elif wire == 2:
            n, pos = _varint(buf, pos)
            value, pos = buf[pos:pos + n], pos + n
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield field, wire, value


def _shape(buf: bytes) -> tuple:
    """A TensorShapeProto's dims (field 2, each a Dim whose size is field
    1)."""
    dims = []
    for field, _, dim in _fields(buf):
        if field == 2:
            dims.append(next((v for f, _, v in _fields(dim) if f == 1), 0))
    return tuple(dims)


def _entry(buf: bytes) -> BundleEntry:
    kw = dict(dtype=0, shape=(), shard_id=0, offset=0, size=0, sliced=False)
    for field, _, value in _fields(buf):
        if field == 1:
            kw["dtype"] = value
        elif field == 2:
            kw["shape"] = _shape(value)
        elif field in (3, 4, 5):
            kw[("shard_id", "offset", "size")[field - 3]] = value
        elif field == 7:
            kw["sliced"] = True
    return BundleEntry(**kw)


# ------------------------------------------------------------- the table
def _block(data: bytes, handle: bytes) -> bytes:
    """The block a BlockHandle (varint offset, varint size) points at,
    checked to be uncompressed."""
    offset, pos = _varint(handle, 0)
    size, _ = _varint(handle, pos)
    end = offset + size
    if end + BLOCK_TRAILER_BYTES > len(data):
        raise ValueError("block handle past the end of the index file")
    if data[end] != 0:
        raise ValueError(f"index block at {offset} is compressed (type "
                         f"{data[end]}); only uncompressed bundles are read")
    return data[offset:end]


def _block_entries(block: bytes):
    """(key, value) of every entry of one table block, in order."""
    num_restarts = struct.unpack_from("<I", block, len(block) - 4)[0]
    end = len(block) - 4 - 4 * num_restarts
    pos, key = 0, b""
    while pos < end:
        shared, pos = _varint(block, pos)
        non_shared, pos = _varint(block, pos)
        value_len, pos = _varint(block, pos)
        key = key[:shared] + block[pos:pos + non_shared]
        pos += non_shared
        yield key, block[pos:pos + value_len]
        pos += value_len


def read_index(prefix: str) -> tuple[int, dict[str, BundleEntry]]:
    """(num_shards, {name: BundleEntry}) of the bundle at `prefix`."""
    with open(prefix + ".index", "rb") as f:
        data = f.read()
    if len(data) < FOOTER_BYTES:
        raise ValueError(f"{prefix}.index: too short for a table footer")
    footer = data[-FOOTER_BYTES:]
    if struct.unpack_from("<Q", footer, 40)[0] != TABLE_MAGIC:
        raise ValueError(f"{prefix}.index: not a TF tensor bundle index "
                         "(bad table magic)")
    _, pos = _varint(footer, 0)                     # metaindex handle
    _, pos = _varint(footer, pos)
    index = _block(data, footer[pos:])
    num_shards, entries = 1, {}
    for _, handle in _block_entries(index):
        for key, value in _block_entries(_block(data, handle)):
            if key == b"":                          # BundleHeaderProto
                for field, _, v in _fields(value):
                    if field == 1:
                        num_shards = v
                    elif field == 2 and v != 0:
                        raise ValueError(f"{prefix}: a big-endian bundle")
            else:
                entries[key.decode()] = _entry(value)
    return num_shards, entries


def list_variables(prefix: str) -> list[tuple[str, list]]:
    """[(name, shape)] of every entry, sorted by name, as
    `tf.train.list_variables` gives them (string entries such as
    `_CHECKPOINTABLE_OBJECT_GRAPH` included)."""
    _, entries = read_index(prefix)
    return [(name, list(e.shape)) for name, e in sorted(entries.items())]


def _data_path(prefix: str, shard: int, num_shards: int) -> str:
    return f"{prefix}.data-{shard:05d}-of-{num_shards:05d}"


def _tensors(prefix: str, names):
    """(name, array) of each named numeric tensor of the bundle at
    `prefix`, in order, read from its `.data` shards; a name is yielded
    only once its tensor has been read whole."""
    num_shards, entries = read_index(prefix)
    files = {}
    try:
        for name in names:
            e = entries[name]
            if e.dtype not in DTYPES:
                raise ValueError(f"{name}: TF dtype {e.dtype} is not read")
            if e.sliced:
                raise ValueError(f"{name}: a partitioned (sliced) tensor")
            dtype = np.dtype(DTYPES[e.dtype])
            if e.size != dtype.itemsize * int(np.prod(e.shape)):
                raise ValueError(f"{name}: {e.size} bytes for shape "
                                 f"{e.shape} of {dtype}")
            if e.shard_id not in files:
                files[e.shard_id] = open(
                    _data_path(prefix, e.shard_id, num_shards), "rb")
            f = files[e.shard_id]
            f.seek(e.offset)
            raw = f.read(e.size)
            if len(raw) != e.size:
                raise ValueError(f"{name}: the data shard ends at "
                                 f"{e.offset + len(raw)} of "
                                 f"{e.offset + e.size}")
            yield name, np.frombuffer(raw, dtype.newbyteorder("<")).astype(
                dtype).reshape(e.shape)
    finally:
        for f in files.values():
            f.close()


def read_bundle(prefix: str, names=None) -> dict[str, np.ndarray]:
    """{name: array} of the numeric tensors of the bundle at `prefix`: all
    of them (string entries skipped), or those named."""
    if names is None:
        _, entries = read_index(prefix)
        names = sorted(n for n, e in entries.items() if e.dtype != DT_STRING)
    return dict(_tensors(prefix, names))


# -------------------------------------------------- against a mapping
def verify_against_index(prefix: str, state_dict: dict, mapping) -> dict:
    """Every mapped torch tensor against the bundle's index: its TF name
    present and the shape consistent (a sliced entry against its slice).
    `mapping` is `weights.generator_mapping` or `discriminator_mapping`;
    `state_dict` the model's of that mapping.  Returns {"matched": int,
    "missing_in_tf": [...], "shape_mismatch": [(tf_name, tf shape, torch
    shape)], "unmapped_tf": [...]}, all empty lists for a complete
    bridge."""
    tf_vars = {name[:-len(VAL_SUFFIX)]: tuple(shape)
               for name, shape in list_variables(prefix)
               if name.endswith(VAL_SUFFIX) and ".OPTIMIZER_SLOT" not in name}
    missing, mismatch, matched = [], [], 0
    mapped = set()
    for torch_name, tf_name, dst in mapping:
        mapped.add(tf_name)
        if tf_name not in tf_vars:
            missing.append(tf_name)
            continue
        shape = tuple(state_dict[torch_name].shape)
        if dst is not None:
            shape = (dst[1] - dst[0],) + shape[1:]
        if _tf_shape(shape) != tf_vars[tf_name]:
            mismatch.append((tf_name, tf_vars[tf_name], shape))
            continue
        matched += 1
    unmapped = sorted(
        n for n in tf_vars
        if n not in mapped and n != "_CHECKPOINTABLE_OBJECT_GRAPH"
        and not n.startswith("save_counter"))
    return {"matched": matched, "missing_in_tf": missing,
            "shape_mismatch": mismatch, "unmapped_tf": unmapped}


def load_tf_checkpoint(prefix: str, mapping) -> dict[str, torch.Tensor]:
    """The mapped tensors of the TF checkpoint at `prefix` as a state_dict
    of the port's model (through `weights.load_tf_weights`).  Needs the
    `.data` shards (the reference repository ships the indexes only) and
    raises a RuntimeError naming them when they are missing."""
    names = [tf_name + VAL_SUFFIX for _, tf_name, _ in mapping]
    tensors = _tensors(prefix, names)
    weights = {}
    for name in names:
        tf_name = name[:-len(VAL_SUFFIX)]
        try:
            weights[tf_name] = next(tensors)[1]
        except (OSError, KeyError, ValueError) as e:   # stripped blobs
            raise RuntimeError(
                f"cannot read {tf_name!r} from {prefix!r} — the reference "
                "repo ships index files only (.MISSING_LARGE_BLOBS); supply "
                "a full checkpoint") from e
    return load_tf_weights(weights, mapping)
