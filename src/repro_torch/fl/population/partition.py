"""Lazy population-scale partitioning: the partition as a pure function.

A copy of the JAX package's ``fl/population/partition.py`` (it is pure
numpy), so the two engines give every client bit-equal indices.

The eager partitioners (repro_torch.data.partition) materialize one index
array per client and, for the paper's Γ/φ schemes, pop samples from
shared per-class pools *sequentially* — both O(population) in time and
memory, and each client's shard depends on every client before it.
Neither survives 10^5+ clients.

:class:`VirtualPartition` replaces the list with a pure index function:
``indices(n)`` draws client ``n``'s sample indices from the keyed
stream ``default_rng((seed, _PARTITION_TAG, n))``, touching only the
per-class index pools built once from the labels.  Consequences:

  * O(cohort) work per round, O(dataset) setup, nothing per client;
  * shards are identical across processes and independent of the
    population size and of the order clients are queried in (the
    property the population determinism tests pin down);
  * clients sample *with overlap* from the class pools — at population
    scale clients outnumber samples, so the eager schemes' exactly-once
    coverage cannot hold anyway; volume lives in ``samples_per_client``
    (a fixed default, NOT dataset_size/num_clients, which would couple
    shards to the population size).

Kinds mirror the eager registry: ``dirichlet`` (Γ% from a main class,
rest spread over the others), ``class_skew`` (φ: each client lacks
``missing`` classes), ``iid``, and ``natural`` (contiguous wrap-around
windows — the synthetic-text fallback).
"""

from __future__ import annotations

import functools
from typing import Dict

import numpy as np

_PARTITION_TAG = 0x5A17ED

KINDS = ("dirichlet", "class_skew", "iid", "natural")


def _draw(rng: np.random.Generator, pool: np.ndarray, size: int) -> np.ndarray:
    """Draw ``size`` indices from ``pool`` — without replacement while
    the pool allows it, with replacement once a client wants more than
    the pool holds (population >> dataset regime)."""
    if size <= 0:
        return np.empty(0, np.int64)
    return np.asarray(
        rng.choice(pool, size=size, replace=len(pool) < size), np.int64)


class VirtualPartition:
    """Pure-function partition over ``labels`` for ``num_clients``.

    Exposes the lazy-partition protocol ``make_shards`` dispatches on:
    ``len(parts)`` (the population size) and ``parts.indices(n)`` (the
    client's sample indices, lru-cached at cohort scale).
    """

    def __init__(self, labels: np.ndarray, num_clients: int, seed: int = 0,
                 kind: str = "dirichlet", samples_per_client: int = 64,
                 gamma_pct: float = 40.0, missing: int = 2):
        if kind not in KINDS:
            raise ValueError(f"unknown virtual partition kind {kind!r}; "
                             f"have {KINDS}")
        if num_clients <= 0:
            raise ValueError(f"num_clients must be positive, got {num_clients}")
        if samples_per_client <= 0:
            raise ValueError("samples_per_client must be positive")
        labels = np.asarray(labels).reshape(-1)
        self.num_samples = int(labels.shape[0])
        self.num_clients = int(num_clients)
        self.seed = int(seed)
        self.kind = kind
        self.samples_per_client = int(samples_per_client)
        self.gamma_pct = float(gamma_pct)
        self.missing = int(missing)
        self.classes = np.unique(labels)
        # per-class index pools: the only O(dataset) state, built once
        self._pools: Dict[int, np.ndarray] = {
            int(c): np.flatnonzero(labels == c).astype(np.int64)
            for c in self.classes
        }
        self._others: Dict[int, np.ndarray] = {}  # complements, lazily
        self._all: np.ndarray = None  # full index range (iid), lazily
        if self.kind == "class_skew" and self.missing >= len(self.classes):
            raise ValueError(
                f"missing={self.missing} >= {len(self.classes)} classes")
        # cohort-scale cache: the engine re-reads a sampled client's
        # shard a handful of times per round (x, y, num_samples)
        self.indices = functools.lru_cache(maxsize=1024)(self._indices)

    def __len__(self) -> int:
        return self.num_clients

    def _rng(self, n: int) -> np.random.Generator:
        return np.random.default_rng((self.seed, _PARTITION_TAG, n))

    def _other_pool(self, main: int) -> np.ndarray:
        if main not in self._others:
            self._others[main] = np.concatenate(
                [p for c, p in self._pools.items() if c != main])
        return self._others[main]

    def _indices(self, n: int) -> np.ndarray:
        n = int(n)
        if not 0 <= n < self.num_clients:
            raise IndexError(n)
        m = self.samples_per_client
        if self.kind == "natural":
            # contiguous wrap-around window — pure in n by construction
            start = (n * m) % self.num_samples
            return (start + np.arange(m, dtype=np.int64)) % self.num_samples
        rng = self._rng(n)
        if self.kind == "iid":
            if self._all is None:
                self._all = np.arange(self.num_samples, dtype=np.int64)
            return _draw(rng, self._all, m)
        if self.kind == "dirichlet":
            # Γ scheme: main class by client id, Γ% of volume from it
            main = int(self.classes[n % len(self.classes)])
            n_main = int(round(m * self.gamma_pct / 100.0))
            n_main = min(max(n_main, 0), m)
            return np.concatenate([
                _draw(rng, self._pools[main], n_main),
                _draw(rng, self._other_pool(main), m - n_main),
            ])
        # class_skew (φ): drop `missing` classes, equal volume from the rest
        lacking = set(
            int(c) for c in rng.choice(self.classes, self.missing,
                                       replace=False))
        present = [int(c) for c in self.classes if int(c) not in lacking]
        per, extra = divmod(m, len(present))
        return np.concatenate([
            _draw(rng, self._pools[c], per + (1 if i < extra else 0))
            for i, c in enumerate(present)
        ])
