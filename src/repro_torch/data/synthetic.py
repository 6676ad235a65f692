"""Synthetic in-memory tasks (the offline stand-ins).

SyntheticImageTask — images from class-conditional Gaussians around fixed
random prototypes: separable enough to show convergence curves, noisy
enough to be non-trivial.
SyntheticTextTask — token sequences from a fixed sparse bigram table, for
the char-LM / composed-transformer path.

Both are generated with numpy from the seed, drawing in the reference's
order, so the arrays are byte-identical to the JAX package's.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.data.base import FederatedDataset, register_dataset
from repro_torch.data.partition import (  # noqa: F401  (back-compat re-export)
    class_skew_partition,
    dirichlet_partition,
)


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


@dataclasses.dataclass
class SyntheticTextTask:
    vocab: int = 64
    seq_len: int = 32
    num_train: int = 2000
    num_test: int = 400
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # fixed sparse bigram transition table -> predictable sequences
        logits = rng.normal(0, 1, (self.vocab, self.vocab))
        top = np.argsort(-logits, axis=1)[:, :4]
        probs = np.zeros_like(logits)
        for v in range(self.vocab):
            probs[v, top[v]] = [0.55, 0.25, 0.15, 0.05]
        self.table = probs

        def gen(n):
            seqs = np.zeros((n, self.seq_len + 1), np.int32)
            state = rng.integers(0, self.vocab, n)
            seqs[:, 0] = state
            for t in range(1, self.seq_len + 1):
                # one rng.choice per sequence per position: the
                # reference's draw order, kept for byte-equal arrays
                nxt = np.array([
                    rng.choice(self.vocab, p=self.table[s]) for s in state
                ])
                seqs[:, t] = nxt
                state = nxt
            return seqs

        self.train = gen(self.num_train)
        self.test = gen(self.num_test)


def lm_batches(seqs: np.ndarray, batch: int, rng: np.random.Generator):
    """(tokens, labels) next-token batch from (N, L+1) sequences."""
    idx = rng.integers(0, len(seqs), batch)
    chunk = seqs[idx]
    return chunk[:, :-1], chunk[:, 1:]


@register_dataset("synthetic_image")
def load_synthetic_image(seed: int = 0, noise: float = 1.2,
                         data_root=None, cache_dir=None,
                         **task_kw) -> FederatedDataset:
    """SyntheticImageTask as a registry dataset.

    ``data_root``/``cache_dir`` are accepted for loader-signature parity
    but unused: generation is already in-memory deterministic.
    """
    task = SyntheticImageTask(seed=seed, noise=noise, **task_kw)
    return FederatedDataset(
        name="synthetic_image",
        splits={"train": (task.x_train, task.y_train),
                "test": (task.x_test, task.y_test)},
        metadata={"modality": "image", "num_classes": task.num_classes,
                  "hw": task.hw, "channels": task.channels,
                  "source": "synthetic", "seed": seed},
    )


@register_dataset("synthetic_text")
def load_synthetic_text(seed: int = 0, data_root=None, cache_dir=None,
                        **task_kw) -> FederatedDataset:
    """SyntheticTextTask as a registry dataset.

    No natural ids: the ``natural`` partitioner falls back to contiguous
    shards, as in the reference.  ``data_root``/``cache_dir`` are unused,
    as for the image stand-in.
    """
    task = SyntheticTextTask(seed=seed, **task_kw)
    return FederatedDataset(
        name="synthetic_text",
        splits={"train": (task.train[:, :-1], task.train[:, 1:]),
                "test": (task.test[:, :-1], task.test[:, 1:])},
        metadata={"modality": "text", "vocab": task.vocab,
                  "seq_len": task.seq_len, "source": "synthetic",
                  "seed": seed},
    )
