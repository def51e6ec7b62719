"""The port's flax-msgpack reader and writer against flax itself, on a
real GanState checkpoint written by rsrgan_tpu's save_checkpoint."""

import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rsrgan_tpu.models.discriminators import LstmDiscriminator
from rsrgan_tpu.models.recurrent import ResLstmGenerator
from rsrgan_tpu.training import GanTrainer
from rsrgan_tpu.training import checkpoints as jax_ckpt
from rsrgan_tpu_torch.training import checkpoints as ckpt


def assert_same_tree(a, b):
    """Same keys, same leaf types; arrays equal bit for bit with equal
    dtype and shape."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b)
        for k in a:
            assert_same_tree(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b)
        for x, y in zip(a, b):
            assert_same_tree(x, y)
    elif isinstance(a, (np.ndarray, np.generic)):
        assert isinstance(b, type(a)) and a.dtype == b.dtype
        assert a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    else:
        assert type(a) is type(b) and a == b


@pytest.fixture(scope="module")
def gan_checkpoint(tmp_path_factory):
    """A small res_lstm_l + LSTM-D GanState whose EMA differs from its
    params, saved by the JAX package."""
    trainer = GanTrainer(
        ResLstmGenerator(output_dim=4, cell_size=13),
        LstmDiscriminator(cell_size=10, num_projection=4),
        output_dim=4, input_dim=9)
    x = jnp.asarray(np.random.default_rng(0).normal(size=(2, 11, 9)),
                    jnp.float32)
    state = trainer.init_state(jax.random.PRNGKey(0), x,
                               jnp.asarray([11, 6], jnp.int32))
    state = state.replace(g=state.g.replace(
        ema=jax.tree.map(lambda a: a * 0.5 + 0.25, state.g.ema)))
    save_dir = str(tmp_path_factory.mktemp("ckpt"))
    path = jax_ckpt.save_checkpoint(save_dir, "GAN_RNN", state, 7,
                                    meta={"g_type": "res_lstm_l"})
    return save_dir, path, state


def test_reader_matches_flax_restore(gan_checkpoint):
    _, path, _ = gan_checkpoint
    with open(path, "rb") as f:
        data = f.read()
    tree = ckpt.msgpack_restore(data)
    assert_same_tree(tree, flax.serialization.msgpack_restore(data))
    assert ckpt.msgpack_serialize(tree) == data  # the writer rebuilds it


@pytest.mark.parametrize("moving_average", [False, True])
def test_generator_params_bit_exact(gan_checkpoint, moving_average):
    save_dir, path, state = gan_checkpoint
    assert ckpt.latest_checkpoint(save_dir, "GAN_RNN") == path
    assert ckpt.read_checkpoint_meta(save_dir, "GAN_RNN") == {
        "g_type": "res_lstm_l"}
    got = ckpt.load_generator_params(save_dir, "GAN_RNN", moving_average)
    want = state.g.ema if moving_average else state.g.params
    assert_same_tree(got, jax.tree.map(np.asarray, dict(want)))


def test_writer_bytes_match_flax_and_round_trip():
    tree = {"params": {"kernel": np.arange(12, dtype=np.float32)
                       .reshape(3, 4),
                       "ids": np.array([[-1, 2]], np.int32),
                       "empty": np.zeros((0, 5), np.float64)},
            "step": np.zeros((), np.int32), "scale": np.float32(2.5),
            "ints": [0, 127, 128, 255, 256, 65536, 2 ** 40, -1, -32, -33,
                     -129, -40000, -2 ** 40],
            "f": 1.5, "none": None, "flags": [True, False],
            "names": ["", "x" * 31, "y" * 32, "z" * 300],
            "blob": b"\x00\x01" * 200,
            "many": {f"k{i}": i for i in range(20)}}
    data = ckpt.msgpack_serialize(tree)
    # in_place=True is the path flax's to_bytes takes (no key re-sorting)
    assert data == flax.serialization.msgpack_serialize(tree, in_place=True)
    back = flax.serialization.msgpack_restore(data)
    assert_same_tree(back, ckpt.msgpack_restore(data))
    assert_same_tree(back["params"], tree["params"])


def test_port_checkpoint_readable_by_jax_latest(tmp_path):
    tree = {"g": {"params": {"dense": {"kernel": np.ones((2, 3),
                                                         np.float32)}},
                  "ema": {"dense": {"kernel": np.zeros((2, 3),
                                                       np.float32)}}},
            "step": np.zeros((), np.int32)}
    path = ckpt.save_checkpoint(str(tmp_path), "GAN_RNN", tree, 4,
                                meta={"trainer": "gan_rnn"})
    assert jax_ckpt.latest_checkpoint(str(tmp_path), "GAN_RNN") == path
    with open(path, "rb") as f:
        assert_same_tree(flax.serialization.msgpack_restore(f.read()), tree)
    ema = ckpt.load_generator_params(str(tmp_path), "GAN_RNN", True)
    np.testing.assert_array_equal(ema["dense"]["kernel"], 0)


def test_bfloat16_leaves_decode_to_float32():
    vals = np.array([[1.0, -2.5, 3.140625]], np.float32)
    data = flax.serialization.msgpack_serialize(
        {"w": np.asarray(jnp.asarray(vals, jnp.bfloat16))})
    got = ckpt.msgpack_restore(data)["w"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, vals)


def test_chunked_arrays_are_refused():
    data = ckpt.msgpack_serialize(
        {"w": {"__msgpack_chunked_array__": True, "shape": {"0": 2}}})
    with pytest.raises(ValueError, match="chunked"):
        ckpt.msgpack_restore(data)


def test_missing_checkpoint_returns_none(tmp_path):
    assert ckpt.load_generator_params(str(tmp_path), "GAN_RNN") is None
    assert not os.listdir(tmp_path)


# ---------------------------------------------------------------------------
# periodic snapshots, both ways
# ---------------------------------------------------------------------------

def port_state_like_jax():
    """The port's GanState for gan_checkpoint's model sizes."""
    from rsrgan_tpu_torch.models.discriminators import (
        LstmDiscriminator as PortDisc)
    from rsrgan_tpu_torch.models.recurrent import (
        ResLstmGenerator as PortGen)
    from rsrgan_tpu_torch.training import GanTrainer as PortTrainer
    return PortTrainer(PortGen(9, 4, cell_size=13),
                       PortDisc(input_dim=4, cell_size=10, num_projection=4),
                       output_dim=4, input_dim=9).init_state()


def test_snapshots_interchange_with_jax(gan_checkpoint, tmp_path):
    """A JAX snapshot loads in the port's load_newest_state (newer than
    the accepted checkpoint, so it wins); the port's snapshot of that
    state holds the same tree (its keys in the sorted order flax writes
    after a step, where a fresh JAX state keeps init order) and loads in
    the JAX load_newest_state to the same tree."""
    _, _, state = gan_checkpoint
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_ckpt.save_checkpoint(jdir, "GAN_RNN", state, 1)
    snap = jax_ckpt.save_periodic_snapshot(jdir, "GAN_RNN", state)
    os.utime(snap, (os.path.getmtime(snap) + 5,) * 2)
    assert ckpt.periodic_snapshot_path(jdir, "GAN_RNN") == snap
    st = port_state_like_jax()
    assert ckpt.load_newest_state(jdir, "GAN_RNN", st) == (snap, "periodic")
    mine = ckpt.save_periodic_snapshot(pdir, "GAN_RNN", ckpt.state_tree(st))
    with open(snap, "rb") as a, open(mine, "rb") as b:
        assert_same_tree(ckpt.msgpack_restore(b.read()),
                         flax.serialization.msgpack_restore(a.read()))
    restored, src = jax_ckpt.load_newest_state(pdir, "GAN_RNN", state)
    assert src == "periodic"
    with open(mine, "rb") as f:
        assert_same_tree(flax.serialization.msgpack_restore(
            flax.serialization.to_bytes(restored)), ckpt.msgpack_restore(
                f.read()))


def test_newest_state_prefers_the_newer_file(gan_checkpoint, tmp_path):
    """An accepted checkpoint newer than the snapshot wins, in both
    packages; with neither file there is nothing to load."""
    _, _, state = gan_checkpoint
    d = str(tmp_path)
    st = port_state_like_jax()
    assert ckpt.load_newest_state(d, "GAN_RNN", st) == (None, None)
    snap = ckpt.save_periodic_snapshot(d, "GAN_RNN", ckpt.state_tree(st))
    path = ckpt.save_checkpoint(d, "GAN_RNN", ckpt.state_tree(st), 3)
    os.utime(snap, (os.path.getmtime(path) - 5,) * 2)
    assert ckpt.load_newest_state(d, "GAN_RNN", st) == (path, "checkpoint")
    assert jax_ckpt.load_newest_state(d, "GAN_RNN", state)[1] == \
        "checkpoint"
    with open(ckpt._checkpoint_file(d)) as f:
        assert f.read().strip() == "GAN_RNN-3.ckpt"   # not the snapshot


# ---------------------------------------------------------------------------
# TensorBoard event files
# ---------------------------------------------------------------------------

def records(path):
    """(payload, length CRC, payload CRC) of each TFRecord record."""
    import struct
    out = []
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if not header:
                return out
            (n,) = struct.unpack("<Q", header)
            len_crc = f.read(4)
            payload = f.read(n)
            out.append((header, payload, len_crc, f.read(4)))


def without_wall_time(payload: bytes) -> bytes:
    """An Event payload with its wall_time (field 1, fixed64, first)
    zeroed."""
    assert payload[:1] == b"\x09"
    return payload[:1] + bytes(8) + payload[9:]


def test_event_records_equal_jax(tmp_path):
    """The same scalars through both writers: the same records but for
    the wall time (steps, tags, float32 values, framing), every CRC
    valid by the JAX package's CRC32C; the port's reader gives them
    back."""
    from rsrgan_tpu.training import tensorboard as jax_tb
    from rsrgan_tpu_torch.training import tensorboard as tb
    rng = np.random.default_rng(1)
    steps = [(1, {"d_loss": 0.25, "g_loss": float(rng.normal()),
                  "train_frames_per_sec": 123456.789}),
             (2, {"d_loss": -1e-30, "g_loss": 3.4e38}),
             (300, {"x": float("inf"), "y": 0.0, "é": 1.0})]
    files = []
    for mod, name in ((jax_tb, "jax"), (tb, "port")):
        w = mod.EventFileWriter(str(tmp_path / name))
        for step, scalars in steps:
            w.add_scalars(step, scalars)
        w.close()
        files.append(w.path)
    assert os.path.basename(files[1]).startswith("events.out.tfevents.")
    got, want = records(files[1]), records(files[0])
    assert len(got) == len(want) == 1 + len(steps)
    for (h, p, lc, pc), (wh, wp, wlc, wpc) in zip(got, want):
        assert h == wh and lc == wlc
        assert without_wall_time(p) == without_wall_time(wp)
        for blob, crc in ((h, lc), (p, pc)):
            assert crc == np.uint32(jax_tb.masked_crc32c(blob)).tobytes()
    events = tb.read_scalar_events(files[1])
    assert events[0]["file_version"] == "brain.Event:2"
    assert [e["step"] for e in events[1:]] == [s for s, _ in steps]
    for e, (_, scalars) in zip(events[1:], steps):
        assert list(e["scalars"]) == list(scalars)
        for k, v in scalars.items():
            assert e["scalars"][k] == np.float32(v)
    assert [e["step"] for e in tb.read_scalar_events(files[0])] == \
        [0] + [s for s, _ in steps]


def test_crc32c_matches_jax_and_reader_rejects_damage(tmp_path):
    from rsrgan_tpu.training import tensorboard as jax_tb
    from rsrgan_tpu_torch.training import tensorboard as tb
    rng = np.random.default_rng(2)
    for n in (0, 1, 7, 100, 4097):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert tb.crc32c(data) == jax_tb.crc32c(data)
        assert tb.masked_crc32c(data) == jax_tb.masked_crc32c(data)
    assert tb.crc32c(b"123456789") == 0xE3069283   # the CRC-32C check value
    w = tb.EventFileWriter(str(tmp_path))
    w.add_scalars(5, {"a": 1.0})
    w.close()
    blob = bytearray(open(w.path, "rb").read())
    blob[-6] ^= 0xFF
    bad = str(tmp_path / "bad")
    open(bad, "wb").write(bytes(blob))
    with pytest.raises(ValueError, match="CRC"):
        tb.read_scalar_events(bad)
    open(bad, "wb").write(bytes(blob[:-3]))
    with pytest.raises(ValueError, match="truncated"):
        tb.read_scalar_events(bad)
