"""The ``.rtu`` utterance store, byte for byte as
``rsrgan_tpu/data/store.py`` writes and reads it (numpy copy), and the
store's preparation: ``build_store_from_scp`` (Kaldi scp pairs to one
shard, CMVN applied) and ``verify_store``.

File layout (little-endian)::

    b"RTU1" | float32 payload ... | index JSON | uint64 json_len | b"RTU1"
"""

from __future__ import annotations

import json
import os
import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

from rsrgan_tpu_torch.data.cmvn import Cmvn
from rsrgan_tpu_torch.data.kaldi_ark import read_ark_matrix, read_scp

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


def read_rt60_scp(rt60_scp: str) -> dict:
    """An ``utt_id rt60`` table of scalars."""
    table = {}
    with open(rt60_scp) as f:
        for line in f:
            parts = line.split()
            if parts:
                table[parts[0]] = float(parts[1])
    return table


def build_store_from_scp(inputs_scp: str,
                         output_path: str,
                         labels_scp: Optional[str] = None,
                         inputs_cmvn: Optional[Cmvn] = None,
                         labels_cmvn: Optional[Cmvn] = None,
                         rt60_scp: Optional[str] = None) -> int:
    """Paired scp files -> one store shard; returns the utterances
    written. The two scp files must pair line by line (same utt ids);
    global CMVN is applied in float64 before the float32 store; with
    ``rt60_scp`` each utterance's reverberation time is prepended as an
    extra leading input column."""
    in_entries = read_scp(inputs_scp)
    lab_entries = read_scp(labels_scp) if labels_scp else None
    if lab_entries is not None and len(in_entries) != len(lab_entries):
        raise ValueError("inputs/labels scp length mismatch")
    rt60 = read_rt60_scp(rt60_scp) if rt60_scp else None

    count = 0
    with StoreWriter(output_path) as writer:
        for i, (utt_id, path, offset) in enumerate(in_entries):
            inputs = np.asarray(read_ark_matrix(path, offset), np.float64)
            if inputs_cmvn is not None:
                inputs = inputs_cmvn.apply(inputs)
            if rt60 is not None:
                col = np.full((inputs.shape[0], 1), rt60[utt_id])
                inputs = np.concatenate([col, inputs], axis=1)
            labels = None
            if lab_entries is not None:
                lab_id, lab_path, lab_off = lab_entries[i]
                if lab_id != utt_id:
                    raise AssertionError(
                        f"utt id mismatch at line {i}: {utt_id} vs {lab_id}")
                labels = np.asarray(read_ark_matrix(lab_path, lab_off),
                                    np.float64)
                if labels_cmvn is not None:
                    labels = labels_cmvn.apply(labels)
            writer.add(utt_id, inputs, labels)
            count += 1
    return count


def verify_store(path: str) -> Tuple[int, int]:
    """Structural check of a store shard: magic and footer (raises when
    they are bad), and every index entry's payload inside the file with
    labels as long as inputs. Returns (utterances, bad entries)."""
    store = UtteranceStore([path])
    size = os.path.getsize(path)
    bad = 0
    for _, e in store._entries:
        end = e["io"] + e["ir"] * e["ic"] * 4
        ok = e["io"] >= 4 and end <= size
        if "lo" in e:
            lend = e["lo"] + e["lr"] * e["lc"] * 4
            ok = ok and lend <= size and e["lr"] == e["ir"]
        if not ok:
            bad += 1
    return len(store), bad
