"""Checkpoint discovery and the flax-msgpack format, without flax.

The JAX package saves ``flax.serialization.to_bytes(state)`` to
``{save_dir}/{name}-{step}.ckpt``, names the newest in a ``checkpoint``
text file and writes a ``{name}.meta.json`` sidecar
(``rsrgan_tpu/training/checkpoints.py``), and with
``--checkpoint_every_secs`` a ``{name}.periodic.ckpt`` snapshot that a
resume takes when it is newer. The port reads those files with
a pure-Python decoder of the msgpack subset flax writes, and writes them
with a matching encoder whose output ``flax.serialization.msgpack_restore``
reads back identically.

The subset: maps, str/bin, arrays, ints, floats, nil/bool, and the flax
extension types 1 (ndarray) and 3 (numpy scalar), each packed as the
msgpack triple ``(shape, dtype_name, C-order bytes)``. bfloat16 arrays
decode to float32 with the same values (numpy has no bfloat16). flax's
chunked form for arrays above 1 GiB (``__msgpack_chunked_array__``) is
refused: no checkpoint of this system comes near that size.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, List, Optional, Tuple

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"


# ---------------------------------------------------------------------------
# msgpack decoding
# ---------------------------------------------------------------------------

def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    (shape, dtype_name, buf), end = _unpack(data, 0)
    if end != len(data):
        raise ValueError("trailing bytes after an ndarray payload")
    if dtype_name == "bfloat16":
        bits = np.frombuffer(buf, dtype="<u2").astype(np.uint32) << 16
        arr = bits.view(np.float32)
    else:
        arr = np.frombuffer(buf, dtype=np.dtype(dtype_name)).copy()
    return arr.reshape(shape)


def _ext(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    raise ValueError(f"unsupported msgpack extension type {code}")


_FIXED = {  # first byte -> (struct format, size) of a fixed-width scalar
    0xca: (">f", 4), 0xcb: (">d", 8),
    0xcc: (">B", 1), 0xcd: (">H", 2), 0xce: (">I", 4), 0xcf: (">Q", 8),
    0xd0: (">b", 1), 0xd1: (">h", 2), 0xd2: (">i", 4), 0xd3: (">q", 8),
}
_LEN = {1: ">B", 2: ">H", 4: ">I"}


def _length(buf: bytes, pos: int, size: int):
    return struct.unpack_from(_LEN[size], buf, pos)[0], pos + size


def _unpack(buf: bytes, pos: int):
    """Decode one object at ``pos``; returns (object, next position)."""
    b = buf[pos]
    pos += 1
    if b <= 0x7f:
        return b, pos
    if b >= 0xe0:
        return b - 0x100, pos
    if 0x80 <= b <= 0x8f:
        return _unpack_map(buf, pos, b & 0x0f)
    if 0x90 <= b <= 0x9f:
        return _unpack_array(buf, pos, b & 0x0f)
    if 0xa0 <= b <= 0xbf:
        n = b & 0x1f
        return buf[pos:pos + n].decode("utf-8"), pos + n
    if b == 0xc0:
        return None, pos
    if b in (0xc2, 0xc3):
        return b == 0xc3, pos
    if b in _FIXED:
        fmt, size = _FIXED[b]
        return struct.unpack_from(fmt, buf, pos)[0], pos + size
    if b in (0xc4, 0xc5, 0xc6):  # bin 8/16/32
        n, pos = _length(buf, pos, 1 << (b - 0xc4))
        return bytes(buf[pos:pos + n]), pos + n
    if b in (0xd9, 0xda, 0xdb):  # str 8/16/32
        n, pos = _length(buf, pos, 1 << (b - 0xd9))
        return buf[pos:pos + n].decode("utf-8"), pos + n
    if b in (0xc7, 0xc8, 0xc9):  # ext 8/16/32
        n, pos = _length(buf, pos, 1 << (b - 0xc7))
        code = struct.unpack_from(">b", buf, pos)[0]
        pos += 1
        return _ext(code, bytes(buf[pos:pos + n])), pos + n
    if 0xd4 <= b <= 0xd8:  # fixext 1/2/4/8/16
        n = 1 << (b - 0xd4)
        code = struct.unpack_from(">b", buf, pos)[0]
        pos += 1
        return _ext(code, bytes(buf[pos:pos + n])), pos + n
    if b in (0xdc, 0xdd):
        n, pos = _length(buf, pos, 2 if b == 0xdc else 4)
        return _unpack_array(buf, pos, n)
    if b in (0xde, 0xdf):
        n, pos = _length(buf, pos, 2 if b == 0xde else 4)
        return _unpack_map(buf, pos, n)
    raise ValueError(f"unsupported msgpack type byte 0x{b:02x} at {pos - 1}")


def _unpack_array(buf: bytes, pos: int, n: int):
    out = []
    for _ in range(n):
        item, pos = _unpack(buf, pos)
        out.append(item)
    return out, pos


def _unpack_map(buf: bytes, pos: int, n: int):
    out = {}
    for _ in range(n):
        key, pos = _unpack(buf, pos)
        out[key], pos = _unpack(buf, pos)
    if _CHUNKED in out:
        raise ValueError("flax chunked arrays (> 1 GiB leaves) are not "
                         "supported by this reader")
    return out, pos


def msgpack_restore(data: bytes) -> Any:
    """Decode flax msgpack bytes into nested dicts, lists, scalars and
    numpy arrays (the tree ``flax.serialization.msgpack_restore`` gives)."""
    obj, end = _unpack(memoryview(data).tobytes(), 0)
    if end != len(data):
        raise ValueError(f"trailing bytes after msgpack object ({end} of "
                         f"{len(data)})")
    return obj


# ---------------------------------------------------------------------------
# msgpack encoding (same byte choices as msgpack-python, as flax calls it)
# ---------------------------------------------------------------------------

def _pack_len(out: bytearray, n: int, small: Optional[int], codes) -> None:
    """Header for a str/bin/array/map of length n: the fix form when
    ``small`` is set and n < its bound, else the 8/16/32-bit forms."""
    fix, bound = small if small else (None, 0)
    if n < bound:
        out.append(fix | n)
    elif codes[0] is not None and n < 1 << 8:
        out += struct.pack(">BB", codes[0], n)
    elif n < 1 << 16:
        out += struct.pack(">BH", codes[1], n)
    else:
        out += struct.pack(">BI", codes[2], n)


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v + 0x100)
    elif v >= 0:
        for code, fmt, bound in ((0xcc, ">B", 1 << 8), (0xcd, ">H", 1 << 16),
                                 (0xce, ">I", 1 << 32),
                                 (0xcf, ">Q", 1 << 64)):
            if v < bound:
                out += struct.pack(">B", code) + struct.pack(fmt, v)
                return
        raise OverflowError(v)
    else:
        for code, fmt, bound in ((0xd0, ">b", 1 << 7), (0xd1, ">h", 1 << 15),
                                 (0xd2, ">i", 1 << 31),
                                 (0xd3, ">q", 1 << 63)):
            if v >= -bound:
                out += struct.pack(">B", code) + struct.pack(fmt, v)
                return
        raise OverflowError(v)


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    n = len(data)
    fixext = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixext:
        out.append(fixext[n])
    else:
        _pack_len(out, n, None, (0xc7, 0xc8, 0xc9))
    out += struct.pack(">b", code) + data


def _ndarray_to_bytes(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be saved")
    out = bytearray()
    _pack(out, (tuple(int(d) for d in arr.shape), arr.dtype.name,
                arr.tobytes("C")))
    return bytes(out)


def _pack(out: bytearray, obj: Any) -> None:
    if obj is None:
        out.append(0xc0)
    elif isinstance(obj, np.ndarray):
        _pack_ext(out, _EXT_NDARRAY, _ndarray_to_bytes(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _ndarray_to_bytes(np.asarray(obj)))
    elif isinstance(obj, bool):
        out.append(0xc3 if obj else 0xc2)
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, float):
        out += struct.pack(">Bd", 0xcb, obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(out, len(data), (0xa0, 32), (0xd9, 0xda, 0xdb))
        out += data
    elif isinstance(obj, (bytes, bytearray)):
        _pack_len(out, len(obj), None, (0xc4, 0xc5, 0xc6))
        out += obj
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), (0x90, 16), (None, 0xdc, 0xdd))
        for item in obj:
            _pack(out, item)
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), (0x80, 16), (None, 0xde, 0xdf))
        for key, value in obj.items():
            _pack(out, key)
            _pack(out, value)
    else:
        raise TypeError(f"cannot msgpack-encode {type(obj).__name__}")


def msgpack_serialize(tree: Any) -> bytes:
    """Encode nested dicts/lists/scalars/numpy arrays as flax msgpack."""
    out = bytearray()
    _pack(out, tree)
    return bytes(out)


# ---------------------------------------------------------------------------
# checkpoint files
# ---------------------------------------------------------------------------

def _checkpoint_file(save_dir: str) -> str:
    return os.path.join(save_dir, "checkpoint")


def _list_checkpoints(save_dir: str, name: str) -> List[str]:
    if not os.path.isdir(save_dir):
        return []
    files = [f for f in os.listdir(save_dir)
             if f.startswith(name + "-") and f.endswith(".ckpt")]
    return sorted(files, key=lambda f: int(f[len(name) + 1:-5]))


def checkpoint_meta_path(save_dir: str, name: str) -> str:
    return os.path.join(save_dir, f"{name}.meta.json")


def read_checkpoint_meta(save_dir: str, name: str) -> Optional[dict]:
    """The model-config sidecar (None for checkpoints without one)."""
    path = checkpoint_meta_path(save_dir, name)
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        return json.load(f)


def latest_checkpoint(save_dir: str, name: str) -> Optional[str]:
    ckpt_file = _checkpoint_file(save_dir)
    if os.path.isfile(ckpt_file):
        with open(ckpt_file) as f:
            candidate = f.read().strip()
        path = os.path.join(save_dir, candidate)
        if os.path.isfile(path):
            return path
    files = _list_checkpoints(save_dir, name)
    return os.path.join(save_dir, files[-1]) if files else None


def save_checkpoint(save_dir: str, name: str, state: Any, step: int,
                    meta: Optional[dict] = None,
                    max_to_keep: int = 10) -> str:
    """Write a state tree (nested dicts of numpy arrays, in the layout
    flax's ``to_bytes`` gives; ``state_tree`` makes one from a
    ``GanState``) as ``{name}-{step}.ckpt`` plus the ``checkpoint``
    pointer and the optional ``.meta.json`` sidecar, each atomically, and
    keep the newest ``max_to_keep`` checkpoints."""
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, f"{name}-{step}.ckpt")
    with open(path + ".tmp", "wb") as f:
        f.write(msgpack_serialize(state))
    os.replace(path + ".tmp", path)
    if meta is not None:
        mpath = checkpoint_meta_path(save_dir, name)
        with open(mpath + ".tmp", "w") as f:
            json.dump(meta, f, indent=1)
        os.replace(mpath + ".tmp", mpath)
    pointer = _checkpoint_file(save_dir)
    with open(pointer + ".tmp", "w") as f:
        f.write(os.path.basename(path) + "\n")
    os.replace(pointer + ".tmp", pointer)
    for old in _list_checkpoints(save_dir, name)[:-max_to_keep]:
        os.remove(os.path.join(save_dir, old))
    return path


def periodic_snapshot_path(save_dir: str, name: str) -> str:
    return os.path.join(save_dir, f"{name}.periodic.ckpt")


def save_periodic_snapshot(save_dir: str, name: str, state: Any) -> str:
    """Atomically overwrite the mid-iteration crash-recovery snapshot
    ``{name}.periodic.ckpt`` with a state tree (``state_tree``). It stays
    outside the accepted checkpoints' rotation and never enters the
    ``checkpoint`` file."""
    os.makedirs(save_dir, exist_ok=True)
    path = periodic_snapshot_path(save_dir, name)
    with open(path + ".tmp", "wb") as f:
        f.write(msgpack_serialize(state))
    os.replace(path + ".tmp", path)
    return path


def read_checkpoint(path: str) -> dict:
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


def generator_params(state: dict, moving_average: bool = False) -> dict:
    """G's parameter tree from a GanState (``g``) or MseState (``net``)
    state dict; ``moving_average`` takes the EMA shadow instead
    (the JAX ``load_checkpoint(..., moving_average=True)`` swap)."""
    net = state["g"] if "g" in state else state["net"]
    return net["ema" if moving_average else "params"]


def load_generator_params(save_dir: str, name: str,
                          moving_average: bool = False) -> Optional[dict]:
    """G params of the newest checkpoint, or None when there is none."""
    path = latest_checkpoint(save_dir, name)
    if path is None or not os.path.isfile(path):
        return None
    return generator_params(read_checkpoint(path), moving_average)


# ---------------------------------------------------------------------------
# the whole train state
# ---------------------------------------------------------------------------

def _np_tree(flat) -> dict:
    from rsrgan_tpu_torch.models import unflatten_tree
    return unflatten_tree({k: v.detach().float().cpu().numpy()
                           for k, v in flat.items()})


def _opt_tree(tx, opt_state: dict) -> dict:
    """optax's chain state: (EmptyState() of the clip, the transform's)."""
    if tx.name == "adam":
        core = {"count": np.asarray(int(opt_state["count"]), np.int32),
                "mu": _np_tree(opt_state["mu"]),
                "nu": _np_tree(opt_state["nu"])}
    elif tx.name == "rmsprop":
        core = {"nu": _np_tree(opt_state["nu"])}
    else:
        core = {}
    return {"0": {}, "1": core}


def state_tree(state) -> dict:
    """A ``GanState`` as the tree flax's ``to_bytes`` writes for the JAX
    ``GanState`` after a train step (every inner dict's keys sorted)."""
    from rsrgan_tpu_torch.models import module_tree

    def net(ns):
        return {"params": module_tree(ns.module),
                "opt_state": _opt_tree(ns.tx, ns.opt_state),
                "ema": _np_tree(ns.ema), "extra": None}

    return {"g": net(state.g), "d": net(state.d),
            "step": np.asarray(state.step, np.int32)}


def load_state_tree(state, tree: dict) -> None:
    """Copy a checkpoint's tree (a JAX ``GanState``, or one ``state_tree``
    wrote) into ``state`` in place: params, EMA, optimizer state, step.
    Fails on any missing or extra leaf."""
    import torch

    from rsrgan_tpu_torch.models import flatten_tree, load_flax_params

    def tensors(node, like):
        flat = flatten_tree(node)
        if sorted(flat) != sorted(like):
            raise KeyError(f"tree mismatch: {sorted(set(flat) ^ set(like))}")
        return {k: torch.from_numpy(np.array(flat[k], np.float32)).to(
            like[k].device) for k in like}

    for key in ("g", "d"):
        ns, node = getattr(state, key), tree[key]
        load_flax_params(ns.module, node["params"])
        ns.ema = tensors(node["ema"], ns.ema)
        core = node["opt_state"]["1"]
        for field, value in ns.opt_state.items():
            if field == "count":
                ns.opt_state[field] = torch.tensor(
                    int(core["count"]), dtype=torch.int32,
                    device=value.device)
            else:
                ns.opt_state[field] = tensors(core[field], value)
        extra = set(core) - set(ns.opt_state)
        if extra:
            raise KeyError(f"{key} optimizer state has unknown {extra}")
    state.step = int(tree["step"])


def load_checkpoint(save_dir: str, name: str, state) -> Optional[str]:
    """Restore the newest checkpoint into ``state``; returns its path, or
    None when there is none."""
    path = latest_checkpoint(save_dir, name)
    if path is None or not os.path.isfile(path):
        return None
    load_state_tree(state, read_checkpoint(path))
    return path


def load_newest_state(save_dir: str, name: str, state
                      ) -> Tuple[Optional[str], Optional[str]]:
    """Restore into ``state`` the latest accepted checkpoint or, when it
    is newer (by modification time), the periodic snapshot. Returns
    (path, "periodic" or "checkpoint"), or (None, None) when there is
    neither."""
    ckpt = latest_checkpoint(save_dir, name)
    snap = periodic_snapshot_path(save_dir, name)
    snap_t = os.path.getmtime(snap) if os.path.isfile(snap) else None
    ckpt_t = os.path.getmtime(ckpt) if ckpt and os.path.isfile(ckpt) else None
    if snap_t is not None and (ckpt_t is None or snap_t > ckpt_t):
        load_state_tree(state, read_checkpoint(snap))
        return snap, "periodic"
    if ckpt_t is not None:
        return load_checkpoint(save_dir, name, state), "checkpoint"
    return None, None
