"""The ``.rtu`` utterance store, byte for byte as
``rsrgan_tpu/data/store.py`` writes and reads it (numpy copy).

File layout (little-endian)::

    b"RTU1" | float32 payload ... | index JSON | uint64 json_len | b"RTU1"
"""

from __future__ import annotations

import json
import os
import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

_MAGIC = b"RTU1"


class StoreWriter:
    """Append utterances to a single store shard."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "wb")
        self._f.write(_MAGIC)
        self._index: List[dict] = []

    def add(self, utt_id: str, inputs: np.ndarray,
            labels: Optional[np.ndarray] = None) -> None:
        inputs = np.ascontiguousarray(inputs, dtype="<f4")
        entry = {"id": utt_id, "io": self._f.tell(),
                 "ir": int(inputs.shape[0]), "ic": int(inputs.shape[1])}
        self._f.write(inputs.tobytes())
        if labels is not None:
            labels = np.ascontiguousarray(labels, dtype="<f4")
            if labels.shape[0] != inputs.shape[0]:
                raise ValueError(
                    f"utt {utt_id}: inputs have {inputs.shape[0]} frames "
                    f"but labels have {labels.shape[0]} — paired "
                    "utterances must be frame-aligned")
            entry.update({"lo": self._f.tell(), "lr": int(labels.shape[0]),
                          "lc": int(labels.shape[1])})
            self._f.write(labels.tobytes())
        self._index.append(entry)

    def close(self) -> None:
        blob = json.dumps(self._index).encode("utf-8")
        self._f.write(blob)
        self._f.write(struct.pack("<Q", len(blob)))
        self._f.write(_MAGIC)
        self._f.close()

    def __enter__(self) -> "StoreWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class UtteranceStore:
    """Memory-mapped random access over one or more store shards."""

    def __init__(self, paths: Sequence[str]):
        if isinstance(paths, (str, os.PathLike)):
            paths = [paths]
        self._mmaps: List[np.memmap] = []
        self._entries: List[Tuple[int, dict]] = []  # (shard, index entry)
        for shard_idx, path in enumerate(paths):
            size = os.path.getsize(path)
            with open(path, "rb") as f:
                if f.read(4) != _MAGIC:
                    raise ValueError(f"{path}: not an RTU1 store")
                f.seek(size - 12)
                json_len, tail = struct.unpack("<Q", f.read(8))[0], f.read(4)
                if tail != _MAGIC:
                    raise ValueError(f"{path}: truncated store (bad footer)")
                f.seek(size - 12 - json_len)
                index = json.loads(f.read(json_len).decode("utf-8"))
            self._mmaps.append(np.memmap(path, dtype=np.uint8, mode="r"))
            self._entries.extend((shard_idx, e) for e in index)

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def utt_ids(self) -> List[str]:
        return [e["id"] for _, e in self._entries]

    @property
    def lengths(self) -> np.ndarray:
        """Per-utterance frame counts, available without touching payloads."""
        return np.array([e["ir"] for _, e in self._entries], dtype=np.int64)

    @property
    def has_labels(self) -> bool:
        return bool(self._entries) and "lo" in self._entries[0][1]

    @property
    def input_dim(self) -> int:
        return self._entries[0][1]["ic"]

    @property
    def output_dim(self) -> Optional[int]:
        return self._entries[0][1].get("lc")

    def _matrix(self, shard: int, off: int, rows: int,
                cols: int) -> np.ndarray:
        raw = self._mmaps[shard][off:off + rows * cols * 4]
        return np.frombuffer(raw, dtype="<f4").reshape(rows, cols)

    def inputs(self, i: int) -> np.ndarray:
        shard, e = self._entries[i]
        return self._matrix(shard, e["io"], e["ir"], e["ic"])

    def labels(self, i: int) -> Optional[np.ndarray]:
        shard, e = self._entries[i]
        if "lo" not in e:
            return None
        return self._matrix(shard, e["lo"], e["lr"], e["lc"])

    def __getitem__(self, i: int):
        _, e = self._entries[i]
        return e["id"], self.inputs(i), self.labels(i)


def read_list_file(list_file: str) -> List[str]:
    """Read a newline-separated list of shard paths."""
    with open(list_file) as f:
        return [line.strip() for line in f if line.strip()]


class StoreView:
    """The utterances ``indices`` of a store, behind the store interface
    ``SequenceBatcher`` and the device feed read (numpy copy of
    ``rsrgan_tpu/data/store.py`` ``StoreView``). The rotating device feed
    batches one resident shard at a time through one view a shard; views
    share the parent's mmaps and cost only the index array."""

    def __init__(self, store, indices):
        self._store = store
        self._ix = np.asarray(indices, dtype=np.int64)
        self._lengths = store.lengths[self._ix]
        ids = store.utt_ids
        self._utt_ids = [ids[i] for i in self._ix]

    def __len__(self) -> int:
        return len(self._ix)

    @property
    def utt_ids(self) -> List[str]:
        return self._utt_ids

    @property
    def lengths(self) -> np.ndarray:
        return self._lengths

    @property
    def has_labels(self) -> bool:
        return self._store.has_labels

    @property
    def input_dim(self) -> int:
        return self._store.input_dim

    @property
    def output_dim(self) -> Optional[int]:
        return self._store.output_dim

    def inputs(self, i: int) -> np.ndarray:
        return self._store.inputs(int(self._ix[i]))

    def labels(self, i: int) -> Optional[np.ndarray]:
        return self._store.labels(int(self._ix[i]))

    def __getitem__(self, i: int):
        return self._store[int(self._ix[i])]
