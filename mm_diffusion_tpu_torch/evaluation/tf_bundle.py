"""Pure-Python reader and writer of TensorFlow TensorBundle checkpoints,
and the TF-Hub I3D's weights as this port's ``state_dict``.

A copy of ``mm_diffusion_tpu/evaluation/tf_bundle.py``'s format code: the
LevelDB / TF table (SSTable) blocks with prefix-compressed keys, restart
arrays, masked-CRC32C trailers and optional snappy compression (a small
snappy decompressor is included), and minimal protobuf wire decoding of
BundleHeaderProto / BundleEntryProto / TensorShapeProto -- no TensorFlow,
no protobuf runtime.  The published FVD network is the DeepMind I3D TF-Hub
module (``i3d-kinetics-400``), whose weights ship as such a bundle;
:func:`convert_tf_i3d` maps its variable names
(``RGB/inception_i3d/Mixed_4d/Branch_1/Conv3d_0a_1x1/conv_3d/w``, ...) onto
:class:`~mm_diffusion_tpu_torch.evaluation.i3d.InceptionI3d`'s ``state_dict``
(the TF kernels ``[kT, kH, kW, I, O]`` transposed to ``[O, I, kT, kH, kW]``;
sonnet's BatchNorms carry no gamma, so ``weight`` is ones).
:func:`write_bundle` writes the same format (round-trip tests, exports).
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli) + TF's masking
# ---------------------------------------------------------------------------

_CRC_TABLE: List[int] = []


def _crc_table() -> List[int]:
    if not _CRC_TABLE:
        poly = 0x82F63B78  # reflected Castagnoli polynomial
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ poly if (c & 1) else c >> 1
            _CRC_TABLE.append(c)
    return _CRC_TABLE


def crc32c(data: bytes, value: int = 0) -> int:
    table = _crc_table()
    crc = value ^ 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TF stores CRCs masked so CRCs-of-CRCs don't degenerate."""
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# snappy (decompress only — enough to read TF-written blocks)
# ---------------------------------------------------------------------------


def snappy_decompress(data: bytes) -> bytes:
    n, pos = _read_varint(data, 0)
    out = bytearray()
    end = len(data)
    while pos < end:
        tag = data[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:  # literal
            length = (tag >> 2) + 1
            if length > 60:
                nbytes = length - 60
                length = int.from_bytes(data[pos : pos + nbytes], "little") + 1
                pos += nbytes
            out += data[pos : pos + length]
            pos += length
            continue
        if kind == 1:  # copy, 1-byte offset
            length = ((tag >> 2) & 0x7) + 4
            offset = ((tag >> 5) << 8) | data[pos]
            pos += 1
        elif kind == 2:  # copy, 2-byte offset
            length = (tag >> 2) + 1
            offset = int.from_bytes(data[pos : pos + 2], "little")
            pos += 2
        else:  # copy, 4-byte offset
            length = (tag >> 2) + 1
            offset = int.from_bytes(data[pos : pos + 4], "little")
            pos += 4
        if offset == 0 or offset > len(out):
            raise ValueError("corrupt snappy stream: bad copy offset")
        start = len(out) - offset
        for i in range(length):  # copies may overlap — byte-at-a-time semantics
            out.append(out[start + i])
    if len(out) != n:
        raise ValueError(f"corrupt snappy stream: {len(out)} != {n}")
    return bytes(out)


# ---------------------------------------------------------------------------
# varints / protobuf wire format
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def _write_varint(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _proto_fields(buf: bytes):
    """Yield (field_number, wire_type, value) for one message level.

    varint fields yield ints; length-delimited yield bytes; fixed32/64 ints.
    """
    pos = 0
    while pos < len(buf):
        header, pos = _read_varint(buf, pos)
        field, wire = header >> 3, header & 7
        if wire == 0:
            value, pos = _read_varint(buf, pos)
        elif wire == 1:
            value = int.from_bytes(buf[pos : pos + 8], "little")
            pos += 8
        elif wire == 2:
            length, pos = _read_varint(buf, pos)
            value = buf[pos : pos + length]
            pos += length
        elif wire == 5:
            value = int.from_bytes(buf[pos : pos + 4], "little")
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, value


def _proto_field_bytes(field: int, payload: bytes) -> bytes:
    return _write_varint((field << 3) | 2) + _write_varint(len(payload)) + payload


def _proto_field_varint(field: int, value: int) -> bytes:
    return _write_varint(field << 3) + _write_varint(value)


def _proto_field_fixed32(field: int, value: int) -> bytes:
    return _write_varint((field << 3) | 5) + struct.pack("<I", value)


# TF DataType enum -> numpy dtype (tensorflow/core/framework/types.proto).
_DTYPES = {
    1: np.dtype("float32"),
    2: np.dtype("float64"),
    3: np.dtype("int32"),
    4: np.dtype("uint8"),
    5: np.dtype("int16"),
    6: np.dtype("int8"),
    9: np.dtype("int64"),
    10: np.dtype("bool"),
    17: np.dtype("uint16"),
    19: np.dtype("float16"),
    22: np.dtype("uint32"),
    23: np.dtype("uint64"),
}


def _np_dtype(dt: int) -> np.dtype:
    if dt == 14:  # DT_BFLOAT16, through ml_dtypes
        import ml_dtypes

        return np.dtype(ml_dtypes.bfloat16)
    if dt not in _DTYPES:
        raise ValueError(f"unsupported TF DataType enum {dt}")
    return _DTYPES[dt]


def _dt_enum(dtype: np.dtype) -> int:
    try:
        import ml_dtypes

        if dtype == np.dtype(ml_dtypes.bfloat16):
            return 14
    except ImportError:
        pass
    for enum, dt in _DTYPES.items():
        if dt == dtype:
            return enum
    raise ValueError(f"unsupported dtype {dtype}")


class BundleEntry:
    """Decoded BundleEntryProto (tensorflow/core/protobuf/tensor_bundle.proto)."""

    __slots__ = ("dtype", "shape", "shard_id", "offset", "size", "crc32c")

    def __init__(self, buf: bytes):
        self.dtype = 0
        self.shape: Tuple[int, ...] = ()
        self.shard_id = 0
        self.offset = 0
        self.size = 0
        self.crc32c = None
        for field, _wire, value in _proto_fields(buf):
            if field == 1:
                self.dtype = value
            elif field == 2:  # TensorShapeProto
                dims = []
                for f2, _w2, v2 in _proto_fields(value):
                    if f2 == 2:  # Dim
                        size = 0
                        for f3, _w3, v3 in _proto_fields(v2):
                            if f3 == 1:
                                size = v3
                        dims.append(size)
                self.shape = tuple(dims)
            elif field == 3:
                self.shard_id = value
            elif field == 4:
                self.offset = value
            elif field == 5:
                self.size = value
            elif field == 6:
                self.crc32c = value
            elif field == 7:
                raise ValueError("sliced bundle entries are not supported")


# ---------------------------------------------------------------------------
# SSTable (LevelDB/TF table format) — reader
# ---------------------------------------------------------------------------

_TABLE_MAGIC = 0xDB4775248B80FB57
_FOOTER_LEN = 48  # 2 * BlockHandle::kMaxEncodedLength (20) + 8-byte magic


def _parse_block_entries(contents: bytes) -> List[Tuple[bytes, bytes]]:
    """Decode one table block: prefix-compressed entries + restart array."""
    if len(contents) < 4:
        raise ValueError("block too small")
    num_restarts = struct.unpack("<I", contents[-4:])[0]
    data_end = len(contents) - 4 * (num_restarts + 1)
    if data_end < 0:
        raise ValueError("corrupt block: restart array overruns block")
    entries: List[Tuple[bytes, bytes]] = []
    pos = 0
    key = b""
    while pos < data_end:
        shared, pos = _read_varint(contents, pos)
        unshared, pos = _read_varint(contents, pos)
        vlen, pos = _read_varint(contents, pos)
        key = key[:shared] + contents[pos : pos + unshared]
        pos += unshared
        entries.append((key, contents[pos : pos + vlen]))
        pos += vlen
    return entries


def _read_raw_block(buf: bytes, offset: int, size: int, verify: bool) -> bytes:
    contents = buf[offset : offset + size]
    ctype = buf[offset + size]
    if verify:
        stored = struct.unpack("<I", buf[offset + size + 1 : offset + size + 5])[0]
        actual = masked_crc32c(buf[offset : offset + size + 1])
        if stored != actual:
            raise ValueError(f"block crc mismatch at offset {offset}")
    if ctype == 0:
        return contents
    if ctype == 1:
        return snappy_decompress(contents)
    raise ValueError(f"unsupported block compression type {ctype}")


def read_table(path: str, verify: bool = True) -> Dict[bytes, bytes]:
    """Read a whole TF/LevelDB table file into an ordered key->value dict."""
    with open(path, "rb") as f:
        buf = f.read()
    if len(buf) < _FOOTER_LEN:
        raise ValueError(f"{path}: too small to be a table file")
    footer = buf[-_FOOTER_LEN:]
    magic = int.from_bytes(footer[40:48], "little")
    if magic != _TABLE_MAGIC:
        raise ValueError(f"{path}: bad table magic {magic:#x}")
    pos = 0
    _mi_off, pos = _read_varint(footer, pos)  # metaindex handle (unused)
    _mi_size, pos = _read_varint(footer, pos)
    idx_off, pos = _read_varint(footer, pos)
    idx_size, pos = _read_varint(footer, pos)

    index = _parse_block_entries(_read_raw_block(buf, idx_off, idx_size, verify))
    table: Dict[bytes, bytes] = {}
    for _sep_key, handle in index:
        hpos = 0
        boff, hpos = _read_varint(handle, hpos)
        bsize, hpos = _read_varint(handle, hpos)
        for k, v in _parse_block_entries(_read_raw_block(buf, boff, bsize, verify)):
            table[k] = v
    return table


# ---------------------------------------------------------------------------
# Bundle reader
# ---------------------------------------------------------------------------


def _shard_path(prefix: str, shard_id: int, num_shards: int) -> str:
    return f"{prefix}.data-{shard_id:05d}-of-{num_shards:05d}"


def find_bundle_prefix(path: str) -> str:
    """Resolve a SavedModel / hub-module dir, a ``variables`` dir, a
    ``*.index`` file, or an explicit prefix down to the bundle prefix."""
    if path.endswith(".index"):
        return path[: -len(".index")]
    if os.path.isfile(path + ".index"):
        return path
    if os.path.isdir(path):
        for sub in ("", "variables"):
            d = os.path.join(path, sub) if sub else path
            if not os.path.isdir(d):
                continue
            idx = [n for n in os.listdir(d) if n.endswith(".index")]
            if len(idx) == 1:
                return os.path.join(d, idx[0][: -len(".index")])
            if len(idx) > 1:
                raise ValueError(f"{d}: multiple .index files, pass one explicitly")
    raise FileNotFoundError(f"no TensorBundle index found under {path!r}")


class BundleReader:
    """Random access to a TensorBundle checkpoint (pure Python).

    >>> r = BundleReader("/path/to/module/variables/variables")
    >>> r.keys()[:2]
    >>> arr = r.get("RGB/inception_i3d/Conv3d_1a_7x7/conv_3d/w")
    """

    def __init__(self, prefix: str, verify: bool = True):
        self.prefix = find_bundle_prefix(prefix)
        self.verify = verify
        table = read_table(self.prefix + ".index", verify=verify)
        header = table.pop(b"", None)
        self.num_shards = 1
        if header is not None:
            for field, _wire, value in _proto_fields(header):
                if field == 1:
                    self.num_shards = value
                elif field == 2 and value != 0:
                    raise ValueError("big-endian bundles are not supported")
        self.entries: Dict[str, BundleEntry] = {
            k.decode("utf-8"): BundleEntry(v) for k, v in table.items()
        }
        self._shards: Dict[int, "np.memmap"] = {}

    def keys(self) -> List[str]:
        return list(self.entries)

    def dtype(self, name: str) -> np.dtype:
        return _np_dtype(self.entries[name].dtype)

    def shape(self, name: str) -> Tuple[int, ...]:
        return self.entries[name].shape

    def _shard(self, shard_id: int):
        if shard_id not in self._shards:
            path = _shard_path(self.prefix, shard_id, self.num_shards)
            self._shards[shard_id] = np.memmap(path, dtype=np.uint8, mode="r")
        return self._shards[shard_id]

    def get(self, name: str) -> np.ndarray:
        if name not in self.entries and name.endswith(":0"):
            name = name[:-2]  # graph names carry the output slot; keys don't
        e = self.entries[name]
        raw = bytes(self._shard(e.shard_id)[e.offset : e.offset + e.size])
        if self.verify and e.crc32c is not None:
            if masked_crc32c(raw) != e.crc32c:
                raise ValueError(f"tensor crc mismatch for {name!r}")
        dtype = _np_dtype(e.dtype)
        if dtype == np.dtype("bool"):
            arr = np.frombuffer(raw, dtype=np.uint8).astype(bool)
        else:
            arr = np.frombuffer(raw, dtype=dtype.newbyteorder("<")).astype(dtype)
        return arr.reshape(self.shape(name))

    def as_dict(self) -> Dict[str, np.ndarray]:
        return {k: self.get(k) for k in self.entries}


# ---------------------------------------------------------------------------
# Bundle writer (round-trip tests + exporting trees to the TF ecosystem)
# ---------------------------------------------------------------------------

_BLOCK_SIZE = 4096
_RESTART_INTERVAL = 16


class _BlockBuilder:
    def __init__(self):
        self.buf = bytearray()
        self.restarts = [0]
        self.count = 0
        self.last_key = b""

    def add(self, key: bytes, value: bytes) -> None:
        shared = 0
        if self.count % _RESTART_INTERVAL == 0:
            if self.buf:  # restart point: key stored uncompressed
                self.restarts.append(len(self.buf))
        else:
            m = min(len(key), len(self.last_key))
            while shared < m and key[shared] == self.last_key[shared]:
                shared += 1
        self.buf += _write_varint(shared)
        self.buf += _write_varint(len(key) - shared)
        self.buf += _write_varint(len(value))
        self.buf += key[shared:]
        self.buf += value
        self.last_key = key
        self.count += 1

    def finish(self) -> bytes:
        out = bytes(self.buf)
        restarts = self.restarts if self.buf else [0]
        for r in restarts:
            out += struct.pack("<I", r)
        out += struct.pack("<I", len(restarts))
        return out

    def size(self) -> int:
        return len(self.buf) + 4 * (len(self.restarts) + 1)


def _emit_block(out: bytearray, contents: bytes) -> bytes:
    """Append an uncompressed block + trailer; return its encoded handle."""
    offset = len(out)
    out += contents
    out += b"\x00"  # kNoCompression
    out += struct.pack("<I", masked_crc32c(contents + b"\x00"))
    return _write_varint(offset) + _write_varint(len(contents))


def write_bundle(prefix: str, tensors: Dict[str, np.ndarray]) -> None:
    """Write ``tensors`` as a single-shard TensorBundle at ``prefix``."""
    names = sorted(tensors)
    os.makedirs(os.path.dirname(os.path.abspath(prefix)), exist_ok=True)

    data = bytearray()
    entries: List[Tuple[bytes, bytes]] = []
    for name in names:
        arr = np.asarray(tensors[name])  # .tobytes() below emits C order
        if arr.dtype == np.dtype("bool"):
            raw = arr.astype(np.uint8).tobytes()
        else:
            raw = arr.astype(arr.dtype.newbyteorder("<"), copy=False).tobytes()
        shape = b"".join(
            _proto_field_bytes(2, _proto_field_varint(1, d)) for d in arr.shape
        )
        entry = (
            _proto_field_varint(1, _dt_enum(arr.dtype))
            + _proto_field_bytes(2, shape)
            + _proto_field_varint(4, len(data))
            + _proto_field_varint(5, len(raw))
            + _proto_field_fixed32(6, masked_crc32c(raw))
        )
        data += raw
        entries.append((name.encode("utf-8"), entry))
    with open(_shard_path(prefix, 0, 1), "wb") as f:
        f.write(bytes(data))

    header = _proto_field_varint(1, 1)  # num_shards=1, little-endian, no version
    records = [(b"", header)] + entries

    out = bytearray()
    index = _BlockBuilder()
    block = _BlockBuilder()
    for key, value in records:
        block.add(key, value)
        if block.size() >= _BLOCK_SIZE:
            index.add(block.last_key, _emit_block(out, block.finish()))
            block = _BlockBuilder()
    if block.count:
        index.add(block.last_key, _emit_block(out, block.finish()))
    meta_handle = _emit_block(out, _BlockBuilder().finish())
    index_handle = _emit_block(out, index.finish())
    footer = meta_handle + index_handle
    footer += b"\x00" * (40 - len(footer))
    footer += struct.pack("<Q", _TABLE_MAGIC)
    out += footer
    with open(prefix + ".index", "wb") as f:
        f.write(bytes(out))


# ---------------------------------------------------------------------------
# I3D variable-name mapping (TF-Hub deepmind/i3d-kinetics-*)
# ---------------------------------------------------------------------------

_I3D_PREFIX = "RGB/inception_i3d/"


def _i3d_unit_path(segs: Sequence[str]) -> str:
    """The ``state_dict`` prefix of one Unit3D.  Branch convs are
    ``Mixed_*/Branch_{i}/Conv3d_0{a,b}_{1x1,3x3}``: Branch_0 holds the lone
    1x1 (``b0``), Branch_3 the post-pool 1x1 (``b3b``), Branches 1/2 a 1x1
    then a 3x3 (``b{i}a`` / ``b{i}b``).  Mixed_5b's Branch_2 names both
    convs '0a' (an upstream typo), so the kernel-size suffix decides, not
    the letter."""
    if segs[0] == "Logits":
        return "logits"
    if segs[0].startswith("Conv3d"):
        return segs[0]
    if segs[0].startswith("Mixed"):
        mixed, branch_s, conv = segs[0], segs[1], segs[2]
        branch = int(branch_s.split("_")[-1])
        if branch == 0:
            return f"{mixed}.b0"
        if branch == 3:
            return f"{mixed}.b3b"
        return f"{mixed}.b{branch}{'a' if conv.endswith('1x1') else 'b'}"
    raise ValueError(f"unrecognized I3D unit path {'/'.join(segs)!r}")


def convert_tf_i3d(variables: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The TF-Hub I3D's variables -> :class:`InceptionI3d`'s ``state_dict``."""
    sd: Dict[str, torch.Tensor] = {}

    def put(key, value):
        sd[key] = torch.from_numpy(np.ascontiguousarray(value, np.float32))

    for name, value in variables.items():
        key = name[len(_I3D_PREFIX) :] if name.startswith(_I3D_PREFIX) else name
        if key.endswith(":0"):
            key = key[:-2]
        segs = key.split("/")
        leaf, kind = segs[-1], segs[-2]
        unit = _i3d_unit_path(segs[:-2])
        value = np.asarray(value)
        if kind == "conv_3d":
            if leaf == "w":  # [kT, kH, kW, I, O] -> [O, I, kT, kH, kW]
                put(f"{unit}.conv3d.weight", np.transpose(value, (4, 3, 0, 1, 2)))
            else:
                put(f"{unit}.conv3d.bias", value)
        elif kind == "batch_norm":
            flat = value.reshape(-1)  # sonnet stores [1, 1, 1, 1, C]
            if leaf == "beta":
                put(f"{unit}.bn.bias", flat)
                put(f"{unit}.bn.weight", np.ones_like(flat))  # no gamma in the module
            elif leaf == "moving_mean":
                put(f"{unit}.bn.running_mean", flat)
            elif leaf == "moving_variance":
                put(f"{unit}.bn.running_var", flat)
            else:
                raise ValueError(f"unrecognized batch_norm leaf {name!r}")
        else:
            raise ValueError(f"unrecognized I3D variable {name!r}")
    return sd


def load_tf_i3d(path: str, verify: bool = True) -> Dict[str, torch.Tensor]:
    """A TF-Hub module directory (or bundle prefix) -> the I3D ``state_dict``."""
    return convert_tf_i3d(BundleReader(path, verify=verify).as_dict())
