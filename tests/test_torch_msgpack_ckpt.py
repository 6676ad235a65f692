"""The port's msgpack checkpoint format against ``msgpack`` and the JAX
package's ``checkpoint/msgpack_ckpt.py``.

* The port's writer gives the bytes ``msgpack.packb`` gives for the same
  payload (hypothesis-drawn leaves of every stored dtype, 0-d and empty
  arrays, more than 15 and 65535 leaves, keys past 31 and 255 bytes, data
  past 255 and 65535 bytes), and its reader reads ``msgpack.packb``'s
  output, non-minimal widths and bytes keys included.
* The JAX package's ``tests/test_checkpoint.py`` cases on the port's
  module: round trip, atomic write, highest step, empty or missing
  directory, keep-N.
* The module imports and round-trips with ``msgpack`` blocked.
* A heroes run the JAX package's runner saved at round 2 loads in the
  port, and the port's re-save is the same file byte for byte; each
  package loads the other's file.
"""

import importlib.util
import io
import struct
import sys

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from repro.checkpoint import msgpack_ckpt as jckpt
from repro.fl import FLConfig as JConfig
from repro.fl import build_image_setup as j_setup
from repro.fl import build_runner as j_build
from repro_torch.checkpoint import msgpack_ckpt as tckpt
from repro_torch.checkpoint import npz_ckpt
from repro_torch.checkpoint.msgpack_ckpt import (load_checkpoint,
                                                 restore_latest,
                                                 save_checkpoint)
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

DTYPES = ("float32", "float64", "int32", "int64", "uint8", "bool",
          "bfloat16")


def _leaf(rng, dtype, shape):
    """A leaf of ``dtype`` (bf16 as a torch tensor) with random values."""
    x = rng.standard_normal(shape) * 100
    if dtype == "bfloat16":
        return torch.tensor(x, dtype=torch.bfloat16)
    if dtype == "bool":
        return x > 0
    return x.astype(dtype)


def _packb_payload(flat):
    """The payload as the JAX package builds it, through numpy (bf16 as
    its uint16 bits), packed by ``msgpack``."""
    payload = {}
    for k, v in flat.items():
        if isinstance(v, torch.Tensor):
            v = v.view(torch.int16).numpy().view(np.uint16)
            dtype = "bfloat16"
        else:
            v = np.asarray(v)
            dtype = str(v.dtype)
        payload[k] = {"dtype": dtype, "shape": list(v.shape),
                      "data": v.tobytes()}
    return msgpack.packb(payload)


def _port_bytes(flat):
    buf = io.BytesIO()
    metas = {k: tckpt._leaf_meta(v) for k, v in flat.items()}
    tckpt._write_payload(buf, flat, metas)
    return buf.getvalue()


KEYS = st.text(st.characters(blacklist_categories=("Cs",)), max_size=300)
SHAPES = st.one_of(
    st.just(()), st.just((0,)), st.just((3, 0)),
    st.lists(st.integers(1, 9), min_size=1, max_size=3).map(tuple),
    st.sampled_from([(70,), (300, 61), (17000,)]))  # data past 255 / 65535 B


@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(leaves=st.dictionaries(KEYS, st.tuples(st.sampled_from(DTYPES),
                                               SHAPES),
                               min_size=0, max_size=20),
       seed=st.integers(0, 2 ** 32 - 1))
def test_writer_bytes_equal_packb(leaves, seed):
    rng = np.random.default_rng(seed)
    flat = {k: _leaf(rng, d, s) for k, (d, s) in leaves.items()}
    assert _port_bytes(flat) == _packb_payload(flat)


@pytest.mark.parametrize("n", [15, 16, 65535, 65536])
def test_writer_map_widths(n):
    """fixmap, map16 and map32 headers, at their edges."""
    flat = {f"k{i}": np.uint8(i % 256) for i in range(n)}
    got = _port_bytes(flat)
    assert got == _packb_payload(flat)
    assert got[0] == {15: 0x8F, 16: 0xDE, 65535: 0xDE, 65536: 0xDF}[n]


@pytest.mark.parametrize("n", [0, 31, 32, 255, 256, 65535, 65536])
def test_writer_str_and_bin_widths(n):
    """fixstr/str8/str16/str32 keys and bin8/bin16/bin32 data at the
    edges of each width."""
    flat = {"s" * n: np.zeros(n, np.uint8)}
    assert _port_bytes(flat) == _packb_payload(flat)


def test_writer_uint_widths():
    """positive fixint and uint8..uint64 at their edges (a shape's dims)."""
    for d in (0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
              2 ** 64 - 1):
        assert tckpt._uint(d) == msgpack.packb(d)


def test_leaf_of_4gib_raises(tmp_path):
    """msgpack's bin32 takes fewer than 2^32 bytes: such a leaf raises
    before anything is written."""
    big = np.broadcast_to(np.float32(0), (2 ** 30,))
    with pytest.raises(ValueError, match="2\\^32"):
        save_checkpoint(tmp_path, 1, {"big": big})
    t = torch.zeros(1).expand(2 ** 30)
    with pytest.raises(ValueError, match="2\\^32"):
        save_checkpoint(tmp_path, 1, {"big": t})
    assert not list(tmp_path.iterdir())


OBJECTS = st.recursive(
    st.one_of(st.none(), st.booleans(), st.integers(-2 ** 63, 2 ** 64 - 1),
              st.floats(allow_nan=False), st.binary(max_size=300),
              st.text(st.characters(blacklist_categories=("Cs",)),
                      max_size=300)),
    lambda inner: st.one_of(
        st.lists(inner, max_size=20),
        st.dictionaries(st.one_of(st.text(max_size=40),
                                  st.binary(max_size=40)), inner,
                        max_size=20)),
    max_leaves=60)


def _plain(obj):
    """Decoded views as bytes, for comparison with ``msgpack.unpackb``."""
    if isinstance(obj, memoryview):
        return obj.tobytes()
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_plain(v) for v in obj]
    return obj


@settings(max_examples=80, deadline=None)
@given(obj=OBJECTS, single=st.booleans())
def test_reader_reads_packb(obj, single):
    """Every type msgpack writes for these objects: signed and unsigned
    ints, nil, bools, float64 (or float32), str, bin, arrays and maps."""
    blob = msgpack.packb(obj, use_single_float=single)
    got, end = tckpt._unpack(memoryview(blob))
    assert end == len(blob)
    assert _plain(got) == msgpack.unpackb(blob, strict_map_key=False)


def _leaf_record(dtype: bytes, shape: bytes, data: bytes, keys=None):
    """A leaf's record with each field's key as given (non-minimal
    widths built by hand)."""
    keys = keys or (b"\xa5dtype", b"\xa5shape", b"\xa4data")
    return b"\x83" + keys[0] + dtype + keys[1] + shape + keys[2] + data


def test_reader_takes_non_minimal_widths(tmp_path):
    """map16/map32, str8/str16/str32, bin16/bin32, array16/array32 and
    uint8..uint64 / int8..int64 where the smallest form would do, and
    bin keys, as an older or other writer may emit them."""
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    raw = x.tobytes()
    dims = [b"\xcc\x02", b"\xd3" + struct.pack(">q", 3)]
    rec_a = _leaf_record(
        b"\xd9\x07float32",
        b"\xdc\x00\x02" + b"".join(dims),
        b"\xc6" + struct.pack(">I", len(raw)) + raw)
    rec_b = _leaf_record(
        b"\xdb" + struct.pack(">I", 5) + b"int64",
        b"\xdd" + struct.pack(">I", 1) + b"\xcf" + struct.pack(">Q", 2),
        b"\xc5" + struct.pack(">H", 16) + np.array([7, -1]).tobytes(),
        keys=(b"\xc4\x05dtype", b"\xc4\x05shape", b"\xc4\x04data"))
    blob = (b"\xdf" + struct.pack(">I", 2)
            + b"\xda\x00\x03a/x" + rec_a
            + b"\xc4\x03a/y" + rec_b)
    step = tmp_path / "step_00000001"
    step.mkdir()
    (step / "state.msgpack").write_bytes(blob)
    got = load_checkpoint(step)
    np.testing.assert_array_equal(got["a"]["x"], x)
    assert got["a"]["y"].dtype == np.int64
    np.testing.assert_array_equal(got["a"]["y"], [7, -1])
    # the JAX package's reader agrees
    want = jckpt.load_checkpoint(step)
    np.testing.assert_array_equal(want["a"]["x"], x)


def test_reader_refuses_trailing_bytes_and_truncation(tmp_path):
    step = tmp_path / "step_00000001"
    save_checkpoint(tmp_path, 1, {"w": np.arange(4.0)})
    blob = (step / "state.msgpack").read_bytes()
    (step / "state.msgpack").write_bytes(blob + b"\xc0")
    with pytest.raises(ValueError, match="after the payload"):
        load_checkpoint(step)
    (step / "state.msgpack").write_bytes(blob[:-3])
    with pytest.raises(ValueError, match="truncated"):
        load_checkpoint(step)


def test_npz_step_directory_raises(tmp_path):
    """A step directory of the npz format is refused by name, not read."""
    p = npz_ckpt.save_checkpoint(tmp_path, 1, {"w": np.arange(3)})
    with pytest.raises(ValueError, match="npz_ckpt.load_checkpoint"):
        load_checkpoint(p)
    with pytest.raises(ValueError, match="npz_ckpt.load_checkpoint"):
        restore_latest(tmp_path)
    np.testing.assert_array_equal(npz_ckpt.load_checkpoint(p)["w"],
                                  np.arange(3))


# --- the JAX package's tests/test_checkpoint.py cases, on the port ------


def test_roundtrip_preserves_dtypes_and_values(tmp_path):
    rng = np.random.default_rng(0)
    state = {
        "f32": rng.normal(size=(3, 4)).astype(np.float32),
        "f64": rng.normal(size=(5,)),
        "i64": rng.integers(-7, 7, size=(2, 3)),
        "u8": rng.integers(0, 255, size=(4,)).astype(np.uint8),
        "nested": {"list": [np.float32(1.5), np.arange(3)],
                   "bool": np.array([True, False])},
        "bf16": torch.tensor(rng.normal(size=(6,)), dtype=torch.bfloat16),
        "tensor": torch.tensor(rng.normal(size=(2, 3)), dtype=torch.float32),
        "view": torch.arange(12.0).reshape(3, 4).t(),
        "empty": np.zeros((2, 0), np.int32),
    }
    p = save_checkpoint(tmp_path, 3, state)
    assert sorted(f.name for f in p.iterdir()) == ["manifest.json",
                                                   "state.msgpack"]
    got = load_checkpoint(p)
    for k in ("f32", "f64", "i64", "u8", "empty"):
        assert got[k].dtype == state[k].dtype
        np.testing.assert_array_equal(got[k], state[k])
    np.testing.assert_array_equal(got["nested"]["bool"],
                                  state["nested"]["bool"])
    # lists flatten to string-indexed dict nodes; scalars stay 0-d
    assert got["nested"]["list"]["0"].shape == ()
    np.testing.assert_array_equal(got["nested"]["list"]["1"],
                                  state["nested"]["list"][1])
    assert got["bf16"].dtype == torch.bfloat16
    assert torch.equal(got["bf16"].view(torch.int16),
                       state["bf16"].view(torch.int16))
    np.testing.assert_array_equal(got["tensor"], state["tensor"].numpy())
    np.testing.assert_array_equal(got["view"], state["view"].numpy())
    # the JAX package reads the same file: bf16 as its own bfloat16
    want = jckpt.load_checkpoint(p)
    assert want["bf16"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(want["bf16"]).view(np.uint16),
        state["bf16"].view(torch.int16).numpy().view(np.uint16))
    np.testing.assert_array_equal(want["view"], state["view"].numpy())


def test_atomic_write_no_partial_step_on_interrupt(tmp_path, monkeypatch):
    state = {"w": np.arange(8, dtype=np.float32)}
    save_checkpoint(tmp_path, 1, state)
    real_write = tckpt._write_payload

    def boom(f, flat, metas):
        f.write(b"\x81")  # the write dies part of the way in
        raise OSError("disk pulled mid-write")

    monkeypatch.setattr(tckpt, "_write_payload", boom)
    with pytest.raises(OSError, match="disk pulled"):
        save_checkpoint(tmp_path, 2, state)
    monkeypatch.setattr(tckpt, "_write_payload", real_write)

    # the interrupted step left no directory — partial or otherwise
    assert not (tmp_path / "step_00000002").exists()
    assert not list(tmp_path.glob("step_*.tmp.*"))
    # and the previous checkpoint is still the restorable latest
    step, got = restore_latest(tmp_path)
    assert step == 1
    np.testing.assert_array_equal(got["w"], state["w"])
    # a later save on the same directory succeeds normally
    save_checkpoint(tmp_path, 2, {"w": state["w"] + 1})
    step, got = restore_latest(tmp_path)
    assert step == 2
    np.testing.assert_array_equal(got["w"], state["w"] + 1)


def test_restore_latest_picks_highest_step(tmp_path):
    for step in (2, 10, 9):
        save_checkpoint(tmp_path, step, {"s": np.array([step])}, keep=100)
    step, got = restore_latest(tmp_path)
    assert step == 10
    np.testing.assert_array_equal(got["s"], [10])
    # stray non-step entries are never candidates
    (tmp_path / "step_garbage").mkdir()
    (tmp_path / "notes.txt").write_text("x")
    assert restore_latest(tmp_path)[0] == 10


def test_restore_latest_empty_and_missing(tmp_path):
    assert restore_latest(tmp_path) is None
    assert restore_latest(tmp_path / "nope") is None


def test_keep_prunes_oldest(tmp_path):
    for step in range(1, 6):
        save_checkpoint(tmp_path, step, {"s": np.array([step])}, keep=2)
    names = sorted(p.name for p in tmp_path.glob("step_*"))
    assert names == ["step_00000004", "step_00000005"]


def test_no_msgpack_package_needed(tmp_path, monkeypatch):
    """A fresh copy of the module, imported and used while ``import
    msgpack`` fails, writes the file ``msgpack`` would and reads it."""
    monkeypatch.setitem(sys.modules, "msgpack", None)
    with pytest.raises(ImportError):
        import msgpack as _  # noqa: F401
    spec = importlib.util.spec_from_file_location("_ckpt_copy",
                                                  tckpt.__file__)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    state = {"a": {"w": np.arange(20, dtype=np.float32)},
             "b": torch.ones(3, dtype=torch.bfloat16)}
    p = mod.save_checkpoint(tmp_path, 7, state)
    got = mod.load_checkpoint(p)
    np.testing.assert_array_equal(got["a"]["w"], state["a"]["w"])
    assert torch.equal(got["b"], state["b"])
    monkeypatch.undo()
    assert (p / "state.msgpack").read_bytes() == _packb_payload(
        tckpt._flatten(state))


def test_reference_heroes_checkpoint_resaved_byte_identical(tmp_path):
    """The JAX package's runner saves heroes round 2; the port loads it
    and writes it again: the same ``state.msgpack``, byte for byte."""
    jm, jx, jy, jt = j_setup(num_clients=8)
    cfg = JConfig(num_clients=8, clients_per_round=3, eval_every=1,
                  agg_backend="host", forward_impl="rank_space",
                  tau_fixed=2, tau_max=6, checkpoint_every=2,
                  checkpoint_dir=str(tmp_path / "j"))
    jr = j_build("heroes", jm, jx, jy, jt, cfg=cfg)
    jr.run(2)
    src = tmp_path / "j" / "step_00000002"
    step, state = restore_latest(tmp_path / "j")
    assert step == 2
    out = save_checkpoint(tmp_path / "t", step, state)
    assert (out / "state.msgpack").read_bytes() == \
        (src / "state.msgpack").read_bytes()
    assert (out / "manifest.json").read_text() == \
        (src / "manifest.json").read_text()
    # and the reference's own reader takes the port's file
    back = jckpt.load_checkpoint(out)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jckpt.load_checkpoint(src))):
        assert a.dtype == b.dtype and np.array_equal(a, b)
