"""Non-IID partitioners behind a registry any dataset composes with.

The paper's Γ (dirichlet-style main-class skew) and φ (missing-class)
schemes, plus iid and natural splits.  A *partitioner* maps a train split to per-client index lists::

    fn(labels, num_clients, seed, metadata=..., **kw) -> List[np.ndarray]

and is registered under a name so callers select it per run
(``build_image_setup(partitioner="class_skew", partition_kw=...)``).

Coverage contract:

  * every partitioner returns exactly ``num_clients`` disjoint index
    arrays (no sample is assigned twice);
  * ``iid`` and ``natural`` cover every train index exactly once;
  * ``dirichlet`` / ``class_skew`` keep the paper's equal-volume rule
    ``n_per_client = N // num_clients``, so up to ``N % num_clients``
    (plus skew-induced shortfalls) trailing samples stay unassigned —
    the property tests in tests/test_data.py pin both behaviours.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np


def dirichlet_partition(labels: np.ndarray, num_clients: int, gamma_pct: float,
                        seed: int = 0) -> List[np.ndarray]:
    """Paper's Γ scheme: Γ% of each client's samples from one class, the
    rest spread evenly.  Γ=1/num_classes*100 ~ IID."""
    rng = np.random.default_rng(seed)
    classes = np.unique(labels)
    idx_by_class = {c: list(rng.permutation(np.where(labels == c)[0])) for c in classes}
    n_per_client = len(labels) // num_clients
    frac = gamma_pct / 100.0
    out = []
    for n in range(num_clients):
        main_c = classes[n % len(classes)]
        want_main = int(round(frac * n_per_client))
        take = []
        pool = idx_by_class[main_c]
        take += [pool.pop() for _ in range(min(want_main, len(pool)))]
        rest = n_per_client - len(take)
        others = [c for c in classes]
        for i in range(rest):
            c = others[i % len(others)]
            pool = idx_by_class[c]
            if pool:
                take.append(pool.pop())
        out.append(np.asarray(take, np.int64))
    return out


def class_skew_partition(labels: np.ndarray, num_clients: int, missing: int,
                         seed: int = 0) -> List[np.ndarray]:
    """Paper's φ scheme (ImageNet-100): each client LACKS ``missing``
    classes; equal volume from each present class."""
    rng = np.random.default_rng(seed)
    classes = np.unique(labels)
    idx_by_class = {c: list(rng.permutation(np.where(labels == c)[0])) for c in classes}
    n_per_client = len(labels) // num_clients
    out = []
    for n in range(num_clients):
        lacking = set(rng.choice(classes, size=missing, replace=False)) if missing else set()
        present = [c for c in classes if c not in lacking]
        take = []
        per_c = max(1, n_per_client // len(present))
        for c in present:
            pool = idx_by_class[c]
            take += [pool.pop() for _ in range(min(per_c, len(pool)))]
        out.append(np.asarray(take[:n_per_client], np.int64))
    return out


def iid_partition(labels: np.ndarray, num_clients: int,
                  seed: int = 0) -> List[np.ndarray]:
    """Uniform shuffle-and-split; covers every index exactly once."""
    rng = np.random.default_rng(seed)
    return [np.asarray(s, np.int64)
            for s in np.array_split(rng.permutation(len(labels)), num_clients)]


def natural_partition(num_samples: int, num_clients: int,
                      natural_ids: Optional[np.ndarray] = None) -> List[np.ndarray]:
    """Group-by-owner partition (Shakespeare speakers; LEAF-style).

    With per-sample ``natural_ids``, whole groups are greedily packed
    onto the least-loaded client (deterministic: groups visited largest
    first, ties by id).  Without ids — the synthetic corpus — it falls
    back to contiguous ``np.array_split`` shards, byte-identical to the
    pre-registry text path.  Either way every index is covered exactly
    once.
    """
    if natural_ids is None:
        return [np.asarray(s, np.int64)
                for s in np.array_split(np.arange(num_samples), num_clients)]
    ids = np.asarray(natural_ids)
    if len(ids) != num_samples:
        raise ValueError(
            f"natural_ids has {len(ids)} entries for {num_samples} samples")
    uniq, counts = np.unique(ids, return_counts=True)
    if len(uniq) < num_clients:
        # fewer owners than clients: group identity can't be preserved
        return [np.asarray(s, np.int64)
                for s in np.array_split(np.arange(num_samples), num_clients)]
    order = np.lexsort((uniq, -counts))  # largest group first, ties by id
    loads = np.zeros(num_clients, np.int64)
    assigned: List[List[np.ndarray]] = [[] for _ in range(num_clients)]
    for g in order:
        client = int(np.argmin(loads))
        members = np.where(ids == uniq[g])[0]
        assigned[client].append(members)
        loads[client] += len(members)
    return [np.sort(np.concatenate(a)).astype(np.int64) if a
            else np.empty(0, np.int64) for a in assigned]


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

Partitioner = Callable[..., List[np.ndarray]]

PARTITIONERS: Dict[str, Partitioner] = {}


def register_partitioner(name: str):
    def deco(fn: Partitioner):
        PARTITIONERS[name] = fn
        return fn

    return deco


@register_partitioner("dirichlet")
def _dirichlet(labels, num_clients, seed=0, *, metadata=None, gamma_pct=40.0):
    return dirichlet_partition(labels, num_clients, gamma_pct, seed)


@register_partitioner("class_skew")
def _class_skew(labels, num_clients, seed=0, *, metadata=None, missing=2):
    return class_skew_partition(labels, num_clients, missing, seed)


@register_partitioner("iid")
def _iid(labels, num_clients, seed=0, *, metadata=None):
    return iid_partition(labels, num_clients, seed)


@register_partitioner("natural")
def _natural(labels, num_clients, seed=0, *, metadata=None):
    ids = (metadata or {}).get("natural_ids")
    return natural_partition(len(labels), num_clients, ids)


def partition_dataset(dataset, partitioner: str, num_clients: int,
                      seed: int = 0, **kw) -> List[np.ndarray]:
    """Split a :class:`~repro_torch.data.base.FederatedDataset`'s train split.

    Label-based partitioners read ``dataset.partition_labels`` (the
    train labels for image tasks), so every registered dataset composes
    with every partitioner.
    """
    if partitioner not in PARTITIONERS:
        raise KeyError(
            f"unknown partitioner {partitioner!r}; have {sorted(PARTITIONERS)}")
    return PARTITIONERS[partitioner](
        dataset.partition_labels, num_clients, seed,
        metadata=dataset.metadata, **kw)
