"""Stateless client virtualization: per-client state derived on demand.

A :class:`PopulationRegistry` makes the client population a *keyspace*,
not a data structure.  Everything a round needs about client ``n`` is a
pure function of ``(seed, client_id[, round])``:

  * RNG stream    — ``default_rng((seed, round, n))``, the engine's
                    existing sequential-RNG contract (minibatch draws);
  * data shard    — ``partition.indices(n)`` through the lazy
                    :class:`~repro_torch.fl.population.VirtualPartition`;
  * resource      — :func:`repro_torch.fl.heterogeneity.client_profile`
    profile          (tier, compute scale, time-stream seed,
                     availability), the same function the virtual
                    :class:`~repro_torch.fl.heterogeneity.HeterogeneityModel`
                    resolves ``het.clients[n]`` through;
  * last round    — the ONE piece of accumulated state, a compact dict
    participated     keyed only by clients that actually participated
                    (bounded by rounds x cohort, never the population).
                    When bound to an engine (``bind_participation``) the
                    dict IS the engine's ``ServerState.participation``,
                    so it checkpoints and resumes with the run.

Nothing else is resident between rounds, which is what lets 10^4–10^6
client simulations run in the memory footprint of their cohort.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Tuple

import numpy as np

from repro_torch.fl.heterogeneity import (ClientResources,
                                          HeterogeneityModel, client_profile)

DEFAULT_TIER_WEIGHTS = (0.05, 0.15, 0.30, 0.50)


@dataclasses.dataclass(frozen=True)
class VirtualClientState:
    """Snapshot of one client's derived state for one round."""

    client_id: int
    round: int
    profile: ClientResources
    data_indices: Optional[np.ndarray]  # None when no partition is bound
    last_round: Optional[int]  # previous participation, None if never
    rng_key: Tuple[int, int, int]  # (seed, round, client_id)

    def rng(self) -> np.random.Generator:
        """The engine's sequential-RNG stream for this client-round."""
        return np.random.default_rng(self.rng_key)


class PopulationRegistry:
    """Derives per-client state on demand; holds nothing per client.

    ``partition`` is an optional lazy partition
    (:class:`~repro_torch.fl.population.VirtualPartition`); without it,
    ``data_indices`` is None and the registry still serves profiles and
    RNG streams (e.g. for pure scheduling experiments).
    """

    def __init__(self, size: int, seed: int = 0,
                 tier_weights: Tuple[float, ...] = DEFAULT_TIER_WEIGHTS,
                 partition=None):
        if size <= 0:
            raise ValueError(f"population size must be positive, got {size}")
        if partition is not None and len(partition) != size:
            raise ValueError(f"partition covers {len(partition)} clients, "
                             f"registry covers {size}")
        self.size = int(size)
        self.seed = int(seed)
        self.tier_weights = tuple(float(w) for w in tier_weights)
        self.partition = partition
        # participation bookkeeping: participants only, never O(population)
        self._last_round: dict = {}

    def __len__(self) -> int:
        return self.size

    def _check(self, n: int) -> int:
        n = int(n)
        if not 0 <= n < self.size:
            raise IndexError(f"client {n} outside population of {self.size}")
        return n

    # -- derived state ------------------------------------------------------

    def profile(self, n: int) -> ClientResources:
        return client_profile(self.seed, self._check(n), self.tier_weights)

    def data_indices(self, n: int) -> Optional[np.ndarray]:
        if self.partition is None:
            return None
        return self.partition.indices(self._check(n))

    def rng_stream(self, n: int, rnd: int) -> np.random.Generator:
        return np.random.default_rng((self.seed, int(rnd), self._check(n)))

    def state(self, n: int, rnd: int) -> VirtualClientState:
        n = self._check(n)
        return VirtualClientState(
            client_id=n,
            round=int(rnd),
            profile=self.profile(n),
            data_indices=self.data_indices(n),
            last_round=self.last_participation(n),
            rng_key=(self.seed, int(rnd), n),
        )

    # -- participation bookkeeping -----------------------------------------

    def note_participation(self, clients: Iterable[int], rnd: int) -> None:
        for n in clients:
            self._last_round[int(n)] = int(rnd)

    def bind_participation(self, store: dict) -> dict:
        """Adopt ``store`` (the engine ``ServerState.participation``
        dict) as THE bookkeeping store, shared by identity.

        The engine records cohorts into its state — which is what gets
        checkpointed and restored — and the registry reads the same
        object, so ``last_participation`` survives a resume without a
        second copy.  Notes accumulated before binding are folded in
        (entries already in ``store``, e.g. from a restored checkpoint,
        win)."""
        for n, rnd in self._last_round.items():
            store.setdefault(n, rnd)
        self._last_round = store
        return store

    def last_participation(self, n: int) -> Optional[int]:
        return self._last_round.get(int(n))

    def participants(self) -> int:
        """Distinct clients that have participated so far."""
        return len(self._last_round)

    # -- engine binding -----------------------------------------------------

    def heterogeneity(self, seed: Optional[int] = None,
                      tier_weights: Optional[Tuple[float, ...]] = None
                      ) -> HeterogeneityModel:
        """A virtual heterogeneity model over this population.

        ``seed``/``tier_weights`` (when given) re-bind the registry's
        profile stream so ``registry.profile(n)`` and the returned
        model's ``clients[n]`` resolve through the identical pure
        function — one source of truth for the capability profile.
        """
        if seed is not None:
            self.seed = int(seed)
        if tier_weights is not None:
            self.tier_weights = tuple(float(w) for w in tier_weights)
        return HeterogeneityModel(self.size, seed=self.seed,
                                  tier_weights=self.tier_weights,
                                  virtual=True)
