"""The port's CIFAR-10 and Shakespeare loaders against the JAX package's.

The loaders are numpy on both sides, so every array must be equal bit for
bit, not merely close: the synthetic fallbacks (same ``default_rng(seed)``
draws in the same order), the CIFAR-10 binary-batch and ``cifar10.npz``
readers and the Shakespeare text parser, on files each test writes
itself.  Each package gets its own cache directory and
``REPRO_DATA_CACHE`` is unset, so no test compares an array with itself;
one test then shares one directory between the two on purpose.
"""

import os

import numpy as np
import pytest

from repro.data import load_dataset as j_load
from repro.data import partition_dataset as j_partition
from repro.data.cache import cache_key as j_cache_key
from repro_torch.data import load_dataset as t_load
from repro_torch.data import partition_dataset as t_partition
from repro_torch.data.cache import ENV_VAR, cache_key, cache_path, cached

CIFAR_SMALL = dict(train_size=240, test_size=60, hw=8)
SHAKE_SMALL = dict(train_size=240, test_size=60, num_speakers=8)

SPEECH = """ACT I. A prologue the parser drops.

First Citizen:
Before we proceed any further, hear me speak.
You are all resolved rather to die than to famish?

All:
Resolved. resolved.

First Citizen:
First, you know Caius Marcius is chief enemy to the people.
We know't, we know't.

MENENIUS:
Why, masters, my good friends, mine honest neighbours,
Will you undo yourselves? What work's, my countrymen, in hand?
"""


@pytest.fixture(autouse=True)
def no_env_cache(monkeypatch):
    monkeypatch.delenv(ENV_VAR, raising=False)


def _dirs(tmp_path):
    return tmp_path / "ref_cache", tmp_path / "port_cache"


def _same(jd, td):
    """Two FederatedDatasets hold equal arrays and equal metadata."""
    assert jd.name == td.name
    assert jd.splits.keys() == td.splits.keys()
    for split in jd.splits:
        for a, b in zip(jd.splits[split], td.splits[split]):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    assert jd.metadata.keys() == td.metadata.keys()
    for k, v in jd.metadata.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(v, td.metadata[k])
        else:
            assert v == td.metadata[k], k


def _pair(tmp_path, name, **kw):
    jc, tc = _dirs(tmp_path)
    return (j_load(name, cache_dir=jc, **kw), t_load(name, cache_dir=tc, **kw))


@pytest.mark.parametrize("seed", [0, 3])
def test_cifar10_fallback_equal(tmp_path, seed):
    jd, td = _pair(tmp_path, "cifar10", seed=seed, **CIFAR_SMALL)
    assert td.metadata["source"] == "synthetic"
    _same(jd, td)
    # the cached arrays come back equal too
    _same(jd, t_load("cifar10", cache_dir=_dirs(tmp_path)[1], seed=seed,
                     **CIFAR_SMALL))


def test_cifar10_fallback_at_full_size_equal():
    """The loader's defaults (32x32 images, 2000 + 400) with no cache."""
    _same(j_load("cifar10"), t_load("cifar10"))


def _write_binary(root, rng, per_batch=7, batches=range(1, 6), test=True):
    root.mkdir(parents=True, exist_ok=True)
    names = [f"data_batch_{i}.bin" for i in batches]
    if test:
        names.append("test_batch.bin")
    for name in names:
        rec = rng.integers(0, 256, (per_batch, 3073), dtype=np.uint8)
        rec[:, 0] %= 10
        (root / name).write_bytes(rec.tobytes())


@pytest.mark.parametrize("normalize", [True, False])
def test_cifar10_binary_batches_equal(tmp_path, normalize):
    root = tmp_path / "cifar-10-batches-bin"
    _write_binary(root, np.random.default_rng(1))
    jd, td = _pair(tmp_path, "cifar10", data_root=root, normalize=normalize)
    assert td.metadata["source"] == "files"
    assert td.x.shape == (35, 32, 32, 3) and td.splits["test"][0].shape[0] == 7
    _same(jd, td)


def test_cifar10_npz_equal(tmp_path):
    rng = np.random.default_rng(2)
    root = tmp_path / "npz"
    root.mkdir()
    np.savez(root / "cifar10.npz",
             x_train=rng.integers(0, 256, (12, 32, 32, 3), dtype=np.uint8),
             y_train=rng.integers(0, 10, 12), x_test=rng.integers(
                 0, 256, (5, 32, 32, 3), dtype=np.uint8),
             y_test=rng.integers(0, 10, 5))
    jd, td = _pair(tmp_path, "cifar10", data_root=root)
    assert td.metadata["source"] == "files"
    _same(jd, td)


def test_cifar10_partial_binary_set_raises(tmp_path):
    root = tmp_path / "partial"
    _write_binary(root, np.random.default_rng(3), batches=(1, 2, 4))
    for load in (j_load, t_load):
        with pytest.raises(FileNotFoundError, match="data_batch_3.bin"):
            load("cifar10", data_root=root)
    # a record count that is not whole is refused as well
    (root / "data_batch_3.bin").write_bytes(b"\0" * 3073)
    (root / "data_batch_5.bin").write_bytes(b"\0" * 100)
    for load in (j_load, t_load):
        with pytest.raises(ValueError, match="not a CIFAR-10 binary batch"):
            load("cifar10", data_root=root)


def test_cifar10_cache_follows_the_files_mtime(tmp_path):
    """A file rewritten under the same root (same size, new mtime) is a
    cache miss: both packages load the new pixels."""
    root = tmp_path / "bin"
    _write_binary(root, np.random.default_rng(4))
    jc, tc = _dirs(tmp_path)
    before = t_load("cifar10", data_root=root, cache_dir=tc)
    assert len(list((tc / "cifar10").glob("*.npz"))) == 1
    path = root / "data_batch_1.bin"
    raw = bytearray(path.read_bytes())
    raw[1:3074] = bytes(255 - b for b in raw[1:3074])
    path.write_bytes(bytes(raw))
    st = path.stat()
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
    after = t_load("cifar10", data_root=root, cache_dir=tc)
    assert len(list((tc / "cifar10").glob("*.npz"))) == 2
    assert not np.array_equal(before.x[0], after.x[0])
    np.testing.assert_array_equal(before.x[7:], after.x[7:])
    _same(j_load("cifar10", data_root=root, cache_dir=jc), after)


@pytest.mark.parametrize("seed", [0, 5])
def test_shakespeare_fallback_and_natural_partition_equal(tmp_path, seed):
    jd, td = _pair(tmp_path, "shakespeare", seed=seed, **SHAKE_SMALL)
    assert td.metadata["source"] == "synthetic"
    _same(jd, td)
    for clients in (6, 8, 10):
        jp = j_partition(jd, "natural", clients, seed)
        tp = t_partition(td, "natural", clients, seed)
        assert len(jp) == len(tp) == clients
        for a, b in zip(jp, tp):
            np.testing.assert_array_equal(a, b)


def test_shakespeare_fallback_at_full_size_equal():
    """The loader's defaults (T 32, vocab 64, 16 speakers) with no cache."""
    _same(j_load("shakespeare"), t_load("shakespeare"))


@pytest.mark.parametrize("name", ["shakespeare.txt", "plays.txt"])
def test_shakespeare_text_equal(tmp_path, name):
    root = tmp_path / "corpus"
    root.mkdir()
    (root / name).write_text(SPEECH * 3, encoding="utf-8")
    jd, td = _pair(tmp_path, "shakespeare", data_root=root, seq_len=8)
    assert td.metadata["source"] == "files"
    assert td.metadata["num_speakers"] == 3
    _same(jd, td)
    for a, b in zip(j_partition(jd, "natural", 3), t_partition(td, "natural",
                                                               3)):
        np.testing.assert_array_equal(a, b)


def test_one_cache_directory_serves_both_packages(tmp_path):
    """The key format is the reference's: what one package caches, the
    other reads back as a hit, equal bit for bit."""
    fields = dict(seed=1, normalize=True, train_size=24, test_size=6, hw=8,
                  num_classes=10)
    assert cache_key(task="cifar10", **fields) == \
        j_cache_key(task="cifar10", **fields)
    shared = tmp_path / "shared"
    jd = j_load("cifar10", cache_dir=shared, seed=1, train_size=24,
                test_size=6, hw=8)
    path = cache_path(shared, "cifar10", cache_key(task="cifar10", **fields))
    assert path.exists()
    arrays, hit = cached("cifar10", fields, lambda: pytest.fail("rebuilt"),
                         shared)
    assert hit
    np.testing.assert_array_equal(arrays["x_train"], jd.x)
    _same(jd, t_load("cifar10", cache_dir=shared, seed=1, train_size=24,
                     test_size=6, hw=8))


def test_cache_dir_from_the_environment(tmp_path, monkeypatch):
    monkeypatch.setenv(ENV_VAR, str(tmp_path / "env"))
    td = t_load("shakespeare", **SHAKE_SMALL)
    assert len(list((tmp_path / "env" / "shakespeare").glob("*.npz"))) == 1
    _same(td, t_load("shakespeare", **SHAKE_SMALL))
