"""Synthetic in-memory image task (the offline stand-in).

SyntheticImageTask — images from class-conditional Gaussians around fixed
random prototypes: separable enough to show convergence curves, noisy
enough to be non-trivial.  Generated with numpy from the seed, so the
arrays are byte-identical to the JAX package's for the same seed.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.data.base import FederatedDataset, register_dataset


@dataclasses.dataclass
class SyntheticImageTask:
    num_classes: int = 10
    hw: int = 8
    channels: int = 3
    train_per_class: int = 200
    test_per_class: int = 50
    noise: float = 1.2
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        d = self.hw * self.hw * self.channels
        self.prototypes = rng.normal(0, 1, (self.num_classes, d)).astype(np.float32)
        self.x_train, self.y_train = self._sample(rng, self.train_per_class)
        self.x_test, self.y_test = self._sample(rng, self.test_per_class)

    def _sample(self, rng, per_class):
        xs, ys = [], []
        d = self.hw * self.hw * self.channels
        for c in range(self.num_classes):
            x = self.prototypes[c][None] + self.noise * rng.normal(0, 1, (per_class, d))
            xs.append(x.astype(np.float32))
            ys.append(np.full(per_class, c, np.int32))
        x = np.concatenate(xs).reshape(-1, self.hw, self.hw, self.channels)
        y = np.concatenate(ys)
        perm = rng.permutation(len(y))
        return x[perm], y[perm]


@register_dataset("synthetic_image")
def load_synthetic_image(seed: int = 0, noise: float = 1.2,
                         **task_kw) -> FederatedDataset:
    """SyntheticImageTask as a registry dataset."""
    task = SyntheticImageTask(seed=seed, noise=noise, **task_kw)
    return FederatedDataset(
        name="synthetic_image",
        splits={"train": (task.x_train, task.y_train),
                "test": (task.x_test, task.y_test)},
        metadata={"modality": "image", "num_classes": task.num_classes,
                  "hw": task.hw, "channels": task.channels,
                  "source": "synthetic", "seed": seed},
    )
