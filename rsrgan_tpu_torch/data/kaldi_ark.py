"""Kaldi binary/text ark and scp codec (numpy).

A numpy copy of ``rsrgan_tpu/data/kaldi_ark.py``: the JAX package's
``data`` package imports jax when it is imported, and the port runs where
there is no jax. Reads binary float/double and text matrices; writes
binary float, compressed (Kaldi ``CompressedMatrix`` formats 1 and 2) and
text matrices, byte-identical to the JAX package's writer; reads
compressed formats 1, 2 and 3 to the same arrays as its reader
(``tests/test_torch_data.py`` holds them against each other). The JAX
package's optional C codec (``rsrgan_tpu/native``) is a speed-up of the
same arithmetic and is not copied: the numpy codec here gives the bytes
and arrays that both of the JAX package's codecs give.
"""

from __future__ import annotations

import os
import struct
from typing import Iterator, List, Optional, Tuple

import numpy as np

class ArkFormatError(ValueError):
    """Raised when an ark payload does not match the expected format."""


def parse_scp_line(line: str) -> Tuple[str, str, int]:
    """Parse one scp line ``utt path:offset`` -> (utt_id, path, offset)."""
    utt_id, path_pos = line.strip().split(None, 1)
    if ":" in path_pos:
        path, pos = path_pos.rsplit(":", 1)
        return utt_id, path, int(pos)
    return utt_id, path_pos, 0


def read_scp(scp_path: str) -> List[Tuple[str, str, int]]:
    """Read a .scp file into a list of (utt_id, ark_path, offset)."""
    entries = []
    with open(scp_path, "r") as fin:
        for line in fin:
            line = line.strip()
            if line:
                entries.append(parse_scp_line(line))
    return entries


_GLOBAL_HEADER = struct.Struct("<ffii")  # min_value, range, rows, cols


def _decode_compressed(payload: bytes, min_value: float, value_range: float,
                       num_rows: int, num_cols: int) -> np.ndarray:
    """Kaldi CompressedMatrix format 1 ("BCM "): ``num_cols`` column
    headers of four uint16 percentiles, then the uint8 payload stored
    column-major, each byte mapped piecewise-linearly over [p0, p25],
    (p25, p75], (p75, p100] (64/128/63 steps)."""
    headers = np.frombuffer(payload, dtype="<u2", count=num_cols * 4)
    headers = headers.reshape(num_cols, 4).astype(np.float64)
    perc = min_value + value_range * (1.0 / 65535.0) * headers
    p0, p25, p75, p100 = perc[:, 0], perc[:, 1], perc[:, 2], perc[:, 3]
    data = np.frombuffer(payload, dtype=np.uint8, offset=num_cols * 8,
                         count=num_rows * num_cols)
    v = data.reshape(num_cols, num_rows).astype(np.float64)
    lo = p0[:, None] + (p25 - p0)[:, None] * v * (1.0 / 64.0)
    mid = p25[:, None] + (p75 - p25)[:, None] * (v - 64.0) * (1.0 / 128.0)
    hi = p75[:, None] + (p100 - p75)[:, None] * (v - 192.0) * (1.0 / 63.0)
    out = np.where(v < 64, lo, np.where(v <= 192, mid, hi))
    return np.ascontiguousarray(out.T, dtype=np.float32)


def _read_compressed(buf, kind: bytes) -> np.ndarray:
    """The body of a compressed matrix after its 5-byte header: format 1
    ("CM "), or formats 2 and 3 ("CM2 "/"CM3 ": row-major uint16/uint8
    codes, value = min + range * code / 65535 or / 255)."""
    if kind in (b"CM2", b"CM3"):
        buf.read(1)  # the token's trailing space
        min_value, value_range, rows, cols = _GLOBAL_HEADER.unpack(
            buf.read(_GLOBAL_HEADER.size))
        if kind == b"CM2":
            data = np.frombuffer(buf.read(rows * cols * 2), dtype="<u2")
            scale = 1.0 / 65535.0
        else:
            data = np.frombuffer(buf.read(rows * cols), dtype=np.uint8)
            scale = 1.0 / 255.0
        mat = min_value + value_range * scale * data.astype(np.float64)
        return mat.reshape(rows, cols).astype(np.float32)
    if kind != b"CM ":
        raise ArkFormatError(f"unsupported compressed format {kind!r}")
    min_value, value_range, rows, cols = _GLOBAL_HEADER.unpack(
        buf.read(_GLOBAL_HEADER.size))
    if cols == 0:
        raise ArkFormatError("empty compressed matrix")
    payload = buf.read(cols * 8 + rows * cols)
    return _decode_compressed(payload, min_value, value_range, rows, cols)


def _read_text_matrix(buf, first: bytes) -> np.ndarray:
    """Parse a Kaldi TEXT matrix ("[\\n r0c0 r0c1\\n r1c0 r1c1 ]");
    ``first`` holds bytes already consumed by the caller."""
    chunks = [first]
    while b"]" not in chunks[-1]:
        chunk = buf.read(4096)
        if not chunk:
            raise ArkFormatError("unterminated text matrix (no ']')")
        chunks.append(chunk)
    blob = b"".join(chunks)
    end = blob.index(b"]")
    tail = blob[end + 1:]
    if tail.startswith(b"\n"):
        tail = tail[1:]
    buf.seek(-len(tail), os.SEEK_CUR)
    body = blob[:end].lstrip()
    if not body.startswith(b"["):
        raise ArkFormatError("text matrix must start with '['")
    rows = [r for r in body[1:].decode("utf-8").strip().splitlines()
            if r.strip()]
    if not rows:
        return np.zeros((0, 0), np.float32)
    mat = [np.array(r.split(), dtype=np.float32) for r in rows]
    if any(len(r) != len(mat[0]) for r in mat):
        raise ArkFormatError("ragged text matrix")
    return np.stack(mat)


def read_matrix(buf) -> np.ndarray:
    """Read one Kaldi matrix (binary at "\\0B", else text) from a file
    object positioned at its first byte."""
    header = buf.read(5)
    if len(header) < 5 or header[1:2] != b"B":
        if header.lstrip()[:1] == b"[":
            return _read_text_matrix(buf, header)
        raise ArkFormatError("not a Kaldi matrix (no \\0B header or '[')")
    kind = header[2:5]
    if kind[:1] == b"C":
        return _read_compressed(buf, kind)
    _, rows = struct.unpack("<bi", buf.read(5))
    _, cols = struct.unpack("<bi", buf.read(5))
    if kind[:1] == b"F":
        mat = np.frombuffer(buf.read(rows * cols * 4), dtype="<f4")
    elif kind[:1] == b"D":
        mat = np.frombuffer(buf.read(rows * cols * 8), dtype="<f8")
    else:
        raise ArkFormatError(f"unsupported matrix kind {kind!r}")
    return mat.reshape(rows, cols)


def read_ark_matrix(ark_path: str, offset: int = 0) -> np.ndarray:
    """Read the matrix stored at ``offset`` in ``ark_path``."""
    with open(ark_path, "rb") as f:
        f.seek(int(offset))
        return read_matrix(f)


class ScpReader:
    """Random and sequential access over an scp index."""

    def __init__(self, scp_path: str):
        self.entries = read_scp(scp_path)
        self._by_id = {u: (p, o) for u, p, o in self.entries}

    def __len__(self) -> int:
        return len(self.entries)

    @property
    def utt_ids(self) -> List[str]:
        return [u for u, _, _ in self.entries]

    def read_utt(self, utt_id: str) -> np.ndarray:
        path, offset = self._by_id[utt_id]
        return read_ark_matrix(path, offset)

    def read_index(self, index: int) -> Tuple[str, np.ndarray]:
        utt_id, path, offset = self.entries[index]
        return utt_id, read_ark_matrix(path, offset)

    def __iter__(self) -> Iterator[Tuple[str, np.ndarray]]:
        for i in range(len(self.entries)):
            yield self.read_index(i)


def _encode_compressed(mat: np.ndarray) -> bytes:
    """A matrix as a Kaldi CompressedMatrix body, as Kaldi's automatic
    method picks it: format 2 ("BCM2": one uint16 code per element,
    row-major) for at most 8 rows, else format 1 ("BCM ": a global float32
    [min, range], four uint16 percentile anchors per column (0/25/75/100,
    forced strictly increasing) and one uint8 per element, quantized
    piecewise-linearly against the dequantized anchors)."""
    # quantized from the float32 values, whatever the input dtype
    mat64 = np.asarray(mat, dtype=np.float32).astype(np.float64)
    if mat64.ndim != 2 or mat64.shape[1] == 0 or mat64.shape[0] == 0:
        raise ValueError(f"cannot compress matrix of shape {mat64.shape}")
    if not np.all(np.isfinite(mat64)):
        raise ValueError("cannot compress a matrix with non-finite values")
    rows, cols = mat64.shape
    # the header holds float32: quantize against what a reader parses back
    min_value = float(np.float32(mat64.min()))
    value_range = float(np.float32(mat64.max() - min_value))
    if value_range <= 0.0:
        value_range = 1.0  # Kaldi's guard for constant matrices

    def to_u16(x: np.ndarray) -> np.ndarray:
        f = np.clip((x - min_value) / value_range, 0.0, 1.0)
        return np.floor(f * 65535.0 + 0.499).astype(np.int64)

    if rows <= 8:
        return (b"\0BCM2 " + _GLOBAL_HEADER.pack(min_value, value_range,
                                                 rows, cols)
                + to_u16(mat64).astype("<u2").tobytes())

    col = np.ascontiguousarray(mat64.T)          # [cols, rows]
    s = np.sort(col, axis=1)
    i25 = min(rows // 4, rows - 1)
    i75 = min(3 * (rows // 4), rows - 1)
    p0 = np.minimum(to_u16(s[:, 0]), 65532)
    p25 = np.minimum(np.maximum(to_u16(s[:, i25]), p0 + 1), 65533)
    p75 = np.minimum(np.maximum(to_u16(s[:, i75]), p25 + 1), 65534)
    p100 = np.maximum(to_u16(s[:, rows - 1]), p75 + 1)
    headers = np.stack([p0, p25, p75, p100], axis=1).astype("<u2")
    f = min_value + value_range * (1.0 / 65535.0) * headers.astype(np.float64)
    f0, f25, f75, f100 = (f[:, k:k + 1] for k in range(4))
    lo = np.clip(np.floor((col - f0) / (f25 - f0) * 64.0 + 0.5), 0, 64)
    mid = np.clip(64.0 + np.floor((col - f25) / (f75 - f25) * 128.0 + 0.5),
                  64, 192)
    hi = np.clip(192.0 + np.floor((col - f75) / (f100 - f75) * 63.0 + 0.5),
                 192, 255)
    quant = np.where(col < f25, lo, np.where(col < f75, mid, hi))
    return (b"\0BCM " + _GLOBAL_HEADER.pack(min_value, value_range, rows,
                                            cols)
            + headers.tobytes() + quant.astype(np.uint8).tobytes())


def _format_text_matrix(mat: np.ndarray) -> bytes:
    """Kaldi text-mode matrix body; 9 significant digits so float32 values
    round-trip exactly."""
    lines = [b" ["]
    for row in mat:
        lines.append(b"\n  " + " ".join(f"{v:.9g}" for v in row)
                     .encode("ascii"))
    lines.append(b" ]\n")
    return b"".join(lines)


def _binary_matrix(mat: np.ndarray) -> bytes:
    rows, cols = mat.shape
    return (b"\0BFM " + struct.pack("<bi", 4, rows)
            + struct.pack("<bi", 4, cols) + mat.tobytes())


class ArkWriter:
    """Write float32 matrices to .ark with a paired .scp. Emits the
    Kaldi-standard space between utt id and binary marker; ``compress``
    writes compressed matrices (per writer, or per call of
    ``write_next_utt``), ``text=True`` ``copy-feats ark,t:``-style text
    archives."""

    def __init__(self, scp_path: str, compress: bool = False,
                 text: bool = False):
        if compress and text:
            raise ValueError("text archives cannot be compressed")
        self.scp_path = scp_path
        self.compress = compress
        self.text = text
        self._scp = open(scp_path, "w")
        self._arks = {}

    def write_next_utt(self, ark_path: str, utt_id: str,
                       utt_mat: np.ndarray,
                       compress: Optional[bool] = None) -> None:
        mat = np.ascontiguousarray(utt_mat, dtype="<f4")
        if mat.ndim != 2:
            raise ValueError(f"expected a 2-D matrix, got shape {mat.shape}")
        ark = self._arks.get(ark_path)
        if ark is None:
            ark = open(ark_path, "ab")
            self._arks[ark_path] = ark
        ark.write(utt_id.encode("utf-8") + b" ")
        pos = ark.tell()
        if self.text:
            ark.write(_format_text_matrix(mat))
        elif self.compress if compress is None else compress:
            ark.write(_encode_compressed(mat))
        else:
            ark.write(_binary_matrix(mat))
        ark.flush()
        self._scp.write(f"{utt_id} {ark_path}:{pos}\n")
        self._scp.flush()

    def close(self) -> None:
        for ark in self._arks.values():
            ark.close()
        self._arks.clear()
        self._scp.close()

    def __enter__(self) -> "ArkWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def write_matrix(buf, mat: np.ndarray, compress: bool = False) -> None:
    """Write one binary matrix body (no key) to a file object: float32
    ("\\0BFM "), or with ``compress`` a compressed matrix
    (``_encode_compressed``)."""
    if compress:
        buf.write(_encode_compressed(mat))
        return
    buf.write(_binary_matrix(np.ascontiguousarray(mat, dtype="<f4")))
