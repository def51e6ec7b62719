"""A TensorBoard event-file writer without TensorFlow (copy of
``rsrgan_tpu/training/tensorboard.py``): the training CLI writes one
events file each under ``save_dir/train`` and ``save_dir/eval`` beside its
JSONL metrics, so TensorBoard reads the run.

Event files are TFRecord streams of serialized ``tensorflow.Event``
protos, both emitted here directly:

* TFRecord framing: ``len(u64) | masked_crc32c(len) | data | masked_crc32c``
  with CRC32C (Castagnoli) and TF's rotate-and-add masking.
* Event proto (event.proto): wall_time (field 1, double), step (field 2,
  int64), file_version (3, string) or summary (5, message).
* Summary proto (summary.proto): repeated Value (field 1); Value.tag
  (field 1, string) and Value.simple_value (field 2, float).

The records equal the JAX package's on the same metrics but for their
wall times (``tests/test_torch_checkpoints.py``). ``read_scalar_events``
reads such a file back, every CRC checked.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict, Iterator, List, Tuple

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), table-driven, + TFRecord masking
# ---------------------------------------------------------------------------

_CRC_TABLE = []
for _i in range(256):
    _crc = _i
    for _ in range(8):
        _crc = (_crc >> 1) ^ (0x82F63B78 if _crc & 1 else 0)
    _CRC_TABLE.append(_crc)


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return ((((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF)


# ---------------------------------------------------------------------------
# protobuf wire-format encoding (just what Event/Summary need)
# ---------------------------------------------------------------------------

def _varint(value: int) -> bytes:
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _key(field: int, wire_type: int) -> bytes:
    return _varint((field << 3) | wire_type)


def _double_field(field: int, value: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", value)


def _float_field(field: int, value: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", value)


def _int64_field(field: int, value: int) -> bytes:
    return _key(field, 0) + _varint(value & 0xFFFFFFFFFFFFFFFF)


def _bytes_field(field: int, value: bytes) -> bytes:
    return _key(field, 2) + _varint(len(value)) + value


def encode_scalar_event(wall_time: float, step: int,
                        scalars: Dict[str, float]) -> bytes:
    """Serialize one Event proto holding simple_value summaries."""
    summary = b"".join(
        _bytes_field(1, _bytes_field(1, tag.encode("utf-8")) +
                     _float_field(2, float(value)))
        for tag, value in scalars.items())
    return (_double_field(1, wall_time) + _int64_field(2, step) +
            _bytes_field(5, summary))


def encode_version_event(wall_time: float) -> bytes:
    return (_double_field(1, wall_time) +
            _bytes_field(3, b"brain.Event:2"))


def tfrecord_frame(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", masked_crc32c(header)) +
            payload + struct.pack("<I", masked_crc32c(payload)))


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

class EventFileWriter:
    """Append-only scalar summary writer, one events file per instance.

    Drop-in stand-in for the reference's ``tf.summary.FileWriter`` scalar
    usage; point TensorBoard at the parent directory.
    """

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = (f"events.out.tfevents.{int(time.time())}."
                 f"{socket.gethostname()}.{os.getpid()}")
        self.path = os.path.join(logdir, fname)
        self._f = open(self.path, "ab")
        self._f.write(tfrecord_frame(encode_version_event(time.time())))
        self._f.flush()

    def add_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        payload = encode_scalar_event(time.time(), int(step), scalars)
        self._f.write(tfrecord_frame(payload))
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def __enter__(self) -> "EventFileWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# reader (what the writer emits: checks, and for tools that read a run)
# ---------------------------------------------------------------------------

def iter_records(path: str) -> Iterator[bytes]:
    """The payloads of a TFRecord file, each record's two masked CRCs
    checked (ValueError on a bad CRC or a truncated record)."""
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if not header:
                return
            crcs = f.read(4)
            if len(header) < 8 or len(crcs) < 4:
                raise ValueError(f"{path}: truncated record header")
            if struct.unpack("<I", crcs)[0] != masked_crc32c(header):
                raise ValueError(f"{path}: bad length CRC")
            (length,) = struct.unpack("<Q", header)
            payload = f.read(length)
            crc = f.read(4)
            if len(payload) < length or len(crc) < 4:
                raise ValueError(f"{path}: truncated record")
            if struct.unpack("<I", crc)[0] != masked_crc32c(payload):
                raise ValueError(f"{path}: bad payload CRC")
            yield payload


def _fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """(field, wire type, value) of a protobuf message: varints as ints,
    fixed64/fixed32 as raw bytes, length-delimited as bytes."""
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _read_varint(buf, pos)
        elif wire == 1:
            value, pos = buf[pos:pos + 8], pos + 8
        elif wire == 5:
            value, pos = buf[pos:pos + 4], pos + 4
        elif wire == 2:
            n, pos = _read_varint(buf, pos)
            value, pos = buf[pos:pos + n], pos + n
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, value


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def decode_event(payload: bytes) -> dict:
    """An Event proto: {"wall_time", "step", and "file_version" or
    "scalars" {tag: simple_value}} (step 0 where the proto omits it)."""
    event = {"step": 0}
    for field, _, value in _fields(payload):
        if field == 1:
            event["wall_time"] = struct.unpack("<d", value)[0]
        elif field == 2:
            event["step"] = value
        elif field == 3:
            event["file_version"] = value.decode("utf-8")
        elif field == 5:
            scalars = event.setdefault("scalars", {})
            for _, _, item in _fields(value):
                tag = simple = None
                for f, _, v in _fields(item):
                    if f == 1:
                        tag = v.decode("utf-8")
                    elif f == 2:
                        simple = struct.unpack("<f", v)[0]
                scalars[tag] = simple
    return event


def read_scalar_events(path: str) -> List[dict]:
    """Every event of an events file, CRCs checked, in file order."""
    return [decode_event(p) for p in iter_records(path)]
