"""Participation schedulers: who is *offered* each round.

At population scale participation is a policy — devices are
intermittently reachable, resource-constrained, or simply too numerous
to enumerate — so sampling sits behind the
:class:`~repro_torch.fl.engine.base.ParticipationScheduler` contract with
a registry (mirroring the scheme/trainer/loop registries).  The policies
are the JAX package's ``fl/population/schedulers.py``, draw for draw, so
the two engines offer the same cohorts:

  uniform         ``clients_per_round`` drawn uniformly without
                  replacement (the LEAF / FLGo exemplar policy) —
                  the synchronous and semi-async loops' draws at
                  resident scale, rejection sampling beyond
                  ``_EXACT_POOL_MAX`` so no O(population) pool is built.
  availability    each client is reachable this round with probability
                  ``profile.availability`` (an optional diurnal period
                  modulates it); gates are per-``(seed, round, client)``
                  keyed Bernoulli draws, evaluated only for candidates.
  resource_gated  per-tier duty-cycle gates: slow tiers rarely have
                  spare cycles, so cohorts skew toward capable devices.
  trace           replay an explicit availability trace (a mapping
                  ``round -> available client ids`` or a callable
                  ``(round, client_id) -> bool``), for experiments
                  driven by recorded device-uptime logs.

All schedulers draw their *selection* randomness from ``state.rng``
(the sequential seeded stream carried by the engine's ServerState —
checkpointed and restored with the run) and their *gate* randomness from
keyed streams, so cohorts are reproducible, resumable, and gates are
independent of population size and query order.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set

import numpy as np

from repro_torch.fl.engine.base import ParticipationScheduler
from repro_torch.fl.heterogeneity import client_profile

# Up to this population the uniform policy draws from the whole pool
# (the loops' exact draws, the semi-async exclude path included); above
# it, rejection sampling keeps rounds O(cohort).
_EXACT_POOL_MAX = 1 << 17

_AVAIL_TAG = 0xA11AB1E  # availability gate stream
_GATE_TAG = 0x6A7ED  # resource gate stream


def _rejection_sample(rng: np.random.Generator, pop: int, k: int,
                      exclude, gate=None,
                      max_draws: Optional[int] = None) -> List[int]:
    """Distinct uniform draws from ``range(pop)`` minus ``exclude``,
    keeping only those passing ``gate`` — expected O(k / pass-rate)
    draws when ``k << pop``, never an O(pop) pool."""
    avail = pop - len(exclude)
    k = min(k, avail)
    if k <= 0:
        return []
    budget = max_draws if max_draws is not None else max(256 * k, 8192)
    chosen: List[int] = []
    seen: Set[int] = set(int(e) for e in exclude)
    while len(chosen) < k and budget > 0:
        want = min(max(2 * (k - len(chosen)), 32), budget)
        draws = rng.integers(0, pop, size=want)
        budget -= want
        for d in draws:
            d = int(d)
            if d in seen:
                continue
            seen.add(d)
            if gate is None or gate(d):
                chosen.append(d)
                if len(chosen) == k:
                    break
    return chosen


class UniformParticipation(ParticipationScheduler):
    """Uniform without-replacement sampling."""

    def sample(self, state, k: int, exclude=frozenset()) -> List[int]:
        pop = self.eng.cfg.num_clients
        if pop <= _EXACT_POOL_MAX:
            if not exclude:
                # the synchronous loop's draw, verbatim
                return [int(c) for c in
                        state.rng.choice(pop, k, replace=False)]
            # the semi-async loop's pool + draw, verbatim
            pool = np.array([c for c in range(pop) if c not in exclude])
            if not len(pool):
                return []
            return [int(c) for c in
                    state.rng.choice(pool, min(k, len(pool)), replace=False)]
        return _rejection_sample(state.rng, pop, k, exclude)


class _GatedParticipation(ParticipationScheduler):
    """Shared skeleton: uniform candidates filtered by a per-client,
    per-round Bernoulli gate.  Subclasses define the gate probability."""

    # gated pool enumeration is O(pop * gate); keep the exact path small
    _exact_max = 1 << 13

    def _gate_prob(self, n: int, rnd: int) -> float:
        raise NotImplementedError

    def _gate(self, n: int, rnd: int) -> bool:
        p = self._gate_prob(n, rnd)
        if p >= 1.0:
            return True
        u = np.random.default_rng(
            (self.eng.cfg.seed, self._tag, int(rnd), int(n))).random()
        return bool(u < p)

    def sample(self, state, k: int, exclude=frozenset()) -> List[int]:
        pop, rnd = self.eng.cfg.num_clients, state.round
        if pop <= self._exact_max:
            pool = np.array([c for c in range(pop)
                             if c not in exclude and self._gate(c, rnd)])
            if not len(pool):
                return []
            return [int(c) for c in
                    state.rng.choice(pool, min(k, len(pool)), replace=False)]
        return _rejection_sample(state.rng, pop, k, exclude,
                                 gate=lambda n: self._gate(n, rnd))


class AvailabilityParticipation(_GatedParticipation):
    """Clients are reachable with their profile's availability rate.

    ``period > 0`` adds a diurnal trace: the rate is modulated by a
    cosine of that period (in rounds) with a per-client phase, so
    different slices of the population come online in different rounds.
    """

    _tag = _AVAIL_TAG

    def __init__(self, period: int = 0):
        self.period = int(period)

    def _gate_prob(self, n: int, rnd: int) -> float:
        het = self.eng.het
        prof = client_profile(het.seed, int(n), het.tier_weights)
        p = prof.availability
        if self.period > 0:
            phase = (prof.seed % 997) / 997.0
            p = p * (0.5 + 0.5 * np.cos(
                2.0 * np.pi * (rnd / self.period + phase)))
        return float(p)


class ResourceGatedParticipation(_GatedParticipation):
    """Per-tier duty-cycle gates: capable devices participate more."""

    _tag = _GATE_TAG

    DEFAULT_TIER_PROB = {"laptop": 0.95, "agx_xavier": 0.80,
                         "xavier_nx": 0.55, "tx2": 0.30}

    def __init__(self, tier_prob: Optional[Dict[str, float]] = None):
        self.tier_prob = dict(tier_prob or self.DEFAULT_TIER_PROB)

    def _gate_prob(self, n: int, rnd: int) -> float:
        tier = self.eng.het.clients[int(n)].tier
        return float(self.tier_prob.get(tier, 1.0))


class TraceParticipation(ParticipationScheduler):
    """Replay an explicit availability trace.

    ``trace`` is either a mapping ``round -> iterable of available
    client ids`` (rounds absent from the mapping mean *everyone* is
    available — the uniform fallback) or a callable ``(round,
    client_id) -> bool``.  Pass an instance via the engine's
    ``sampler=`` hook, or set ``eng.availability_trace`` before the
    first round when selecting ``participation="trace"`` by name (the
    registry instantiates schedulers without arguments).
    """

    def __init__(self, trace=None):
        self.trace = trace

    def setup(self, eng) -> None:
        super().setup(eng)
        if self.trace is None:
            self.trace = getattr(eng, "availability_trace", None)

    def _require_trace(self):
        if self.trace is None:
            raise ValueError(
                "TraceParticipation has no trace: pass "
                "TraceParticipation(trace) via the engine's sampler= "
                "hook or set eng.availability_trace")
        return self.trace

    def sample(self, state, k: int, exclude=frozenset()) -> List[int]:
        trace = self._require_trace()
        pop, rnd = self.eng.cfg.num_clients, state.round
        if not callable(trace):
            avail = trace.get(int(rnd))
            if avail is None:  # round not in the trace: all reachable
                return UniformParticipation.sample(self, state, k, exclude)
            pool = np.array(sorted(int(c) for c in avail
                                   if 0 <= int(c) < pop
                                   and int(c) not in exclude))
            if not len(pool):
                return []
            return [int(c) for c in
                    state.rng.choice(pool, min(k, len(pool)), replace=False)]
        if pop <= _GatedParticipation._exact_max:
            pool = np.array([c for c in range(pop)
                             if c not in exclude and trace(rnd, c)])
            if not len(pool):
                return []
            return [int(c) for c in
                    state.rng.choice(pool, min(k, len(pool)), replace=False)]
        return _rejection_sample(state.rng, pop, k, exclude,
                                 gate=lambda n: trace(rnd, n))


SCHEDULERS: Dict[str, type] = {
    "uniform": UniformParticipation,
    "availability": AvailabilityParticipation,
    "resource_gated": ResourceGatedParticipation,
    "trace": TraceParticipation,
}


def register_scheduler(name: str):
    """Decorator registering a ParticipationScheduler class."""

    def deco(cls):
        SCHEDULERS[name] = cls
        return cls

    return deco


def build_scheduler(cfg) -> ParticipationScheduler:
    """Scheduler per ``FLConfig.participation`` (default: uniform)."""
    name = getattr(cfg, "participation", "uniform") or "uniform"
    if name not in SCHEDULERS:
        raise ValueError(f"unknown participation scheduler {name!r}; "
                         f"have {sorted(SCHEDULERS)}")
    return SCHEDULERS[name]()
