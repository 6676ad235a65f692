"""CIFAR-10-format image task: binary/npz reader + deterministic fallback.

Real data is read from ``data_root`` in either of two offline formats:

  * the canonical binary batches (``data_batch_{1..5}.bin`` +
    ``test_batch.bin``, 3073-byte records: 1 label byte + 3072
    channel-major pixel bytes), i.e. an extracted
    ``cifar-10-batches-bin/`` directory, or
  * a single ``cifar10.npz`` with ``x_train/y_train/x_test/y_test``
    (pixels uint8 HWC or float).

When neither is present the loader generates a *deterministic synthetic
fallback* with CIFAR shapes — class-conditional Gaussian images around
fixed random prototypes — so CI and the examples never touch the
network.  Which path was taken is recorded in
``metadata["source"]`` (``"files"`` / ``"synthetic"``).

Preprocessing (scale to [0,1], per-channel standardization with the
usual CIFAR-10 statistics) and the fallback generation are both cached
as npz keyed by (task, seed, preprocessing); see
:mod:`repro_torch.data.cache`.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np

from repro_torch.data.base import FederatedDataset, register_dataset
from repro_torch.data.cache import cached

HW = 32
CHANNELS = 3
NUM_CLASSES = 10
_RECORD = 1 + HW * HW * CHANNELS
# standard CIFAR-10 channel statistics (of the [0,1]-scaled pixels)
_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
_STD = np.array([0.2470, 0.2435, 0.2616], np.float32)


def _binary_files(root: Path) -> Optional[list]:
    """The binary-batch file set, or None when the layout is absent.

    A *partial* set (some of the five train batches missing) is an
    error, not a silent fall-through: training on a fraction of the
    data labeled source="files" would quietly diverge from the paper.
    """
    train = [root / f"data_batch_{i}.bin" for i in range(1, 6)]
    test = root / "test_batch.bin"
    present = [p for p in train if p.exists()]
    if not present and not test.exists():
        return None
    missing = [p.name for p in train if not p.exists()]
    if not test.exists():
        missing.append(test.name)
    if missing:
        raise FileNotFoundError(
            f"incomplete CIFAR-10 binary set under {root}: missing "
            f"{missing}")
    return train + [test]


def _read_binary(files: list) -> Dict[str, np.ndarray]:
    def parse(path: Path):
        raw = np.frombuffer(path.read_bytes(), np.uint8)
        if len(raw) % _RECORD:
            raise ValueError(f"{path} is not a CIFAR-10 binary batch "
                             f"({len(raw)} bytes % {_RECORD} != 0)")
        rec = raw.reshape(-1, _RECORD)
        y = rec[:, 0].astype(np.int32)
        # channel-major (C,H,W) bytes -> HWC
        x = rec[:, 1:].reshape(-1, CHANNELS, HW, HW).transpose(0, 2, 3, 1)
        return x, y

    xs, ys = zip(*(parse(p) for p in files[:-1]))
    x_test, y_test = parse(files[-1])
    return {"x_train": np.concatenate(xs), "y_train": np.concatenate(ys),
            "x_test": x_test, "y_test": y_test}


def _read_npz(root: Path) -> Optional[Dict[str, np.ndarray]]:
    path = root / "cifar10.npz"
    if not path.exists():
        return None
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in ("x_train", "y_train", "x_test", "y_test")}


def _normalize(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.float32)
    if x.max() > 2.0:  # raw uint8 pixels
        x = x / 255.0
    return (x - _MEAN) / _STD


def _synthetic_fallback(seed: int, train_size: int, test_size: int,
                        hw: int, num_classes: int) -> Dict[str, np.ndarray]:
    """Class-conditional Gaussian images around fixed prototypes.

    Fully vectorized and keyed only on the arguments, so two processes
    with the same seed produce byte-identical arrays.
    """
    rng = np.random.default_rng(seed)
    d = hw * hw * CHANNELS
    protos = rng.normal(0, 1, (num_classes, d)).astype(np.float32)

    def sample(n):
        y = np.arange(n, dtype=np.int32) % num_classes
        x = protos[y] + 1.2 * rng.normal(0, 1, (n, d)).astype(np.float32)
        perm = rng.permutation(n)
        return (x[perm].reshape(n, hw, hw, CHANNELS).astype(np.float32),
                y[perm])

    x_train, y_train = sample(train_size)
    x_test, y_test = sample(test_size)
    return {"x_train": x_train, "y_train": y_train,
            "x_test": x_test, "y_test": y_test}


@register_dataset("cifar10")
def load_cifar10(data_root=None, cache_dir=None, seed: int = 0,
                 normalize: bool = True, train_size: int = 2000,
                 test_size: int = 400, hw: int = HW,
                 num_classes: int = NUM_CLASSES) -> FederatedDataset:
    """CIFAR-10 (or its deterministic stand-in) as a FederatedDataset.

    ``train_size``/``test_size``/``hw``/``num_classes`` only shape the
    synthetic fallback; real files always load in full at 32x32.
    """
    root = Path(data_root) if data_root else None
    source = "synthetic"
    if root is not None:
        bin_files = _binary_files(root)
        npz_file = root / "cifar10.npz" if (root / "cifar10.npz").exists() \
            else None
        src_files = bin_files or ([npz_file] if npz_file else None)
        if src_files is not None:
            source = "files"
            hw, num_classes = HW, NUM_CLASSES

            def build():
                raw = _read_binary(bin_files) if bin_files \
                    else _read_npz(root)
                x_tr = _normalize(raw["x_train"]) if normalize \
                    else raw["x_train"].astype(np.float32)
                x_te = _normalize(raw["x_test"]) if normalize \
                    else raw["x_test"].astype(np.float32)
                return {"x_train": x_tr,
                        "y_train": raw["y_train"].astype(np.int32),
                        "x_test": x_te,
                        "y_test": raw["y_test"].astype(np.int32)}

            # fingerprint the source files (size + mtime) so swapping
            # data under the same root invalidates the cache, and the
            # parse itself only runs on a miss
            stats = [(p.name, p.stat().st_size, p.stat().st_mtime_ns)
                     for p in src_files]
            fields = dict(normalize=normalize, source=str(root),
                          files=stats)
            arrays, _ = cached("cifar10", fields, build, cache_dir)
    if source == "synthetic":
        fields = dict(seed=seed, normalize=normalize, train_size=train_size,
                      test_size=test_size, hw=hw, num_classes=num_classes)
        arrays, _ = cached(
            "cifar10", fields,
            lambda: _synthetic_fallback(seed, train_size, test_size, hw,
                                        num_classes),
            cache_dir)
    return FederatedDataset(
        name="cifar10",
        splits={"train": (arrays["x_train"], arrays["y_train"]),
                "test": (arrays["x_test"], arrays["y_test"])},
        metadata={"modality": "image", "num_classes": num_classes,
                  "hw": arrays["x_train"].shape[1], "channels": CHANNELS,
                  "source": source, "seed": seed},
    )
