"""Participation schedulers: who is *offered* each round.

Only the ``uniform`` policy is ported: ``clients_per_round`` drawn
uniformly without replacement from ``state.rng`` (minus the clients
still in flight, under the semi-async loop), the JAX package's draws
verbatim at resident scale, so both engines sample the same cohorts.
The availability, resource-gated and trace policies come with the
population slice (ROADMAP queue A step 9).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.fl.engine.base import ParticipationScheduler

# the uniform draw materializes the pool up to this population
_EXACT_POOL_MAX = 1 << 17


class UniformParticipation(ParticipationScheduler):
    """Uniform without-replacement sampling."""

    def sample(self, state, k: int, exclude=frozenset()) -> List[int]:
        pop = self.eng.cfg.num_clients
        if pop > _EXACT_POOL_MAX:
            raise NotImplementedError(
                "population-scale sampling is not ported yet "
                "(ROADMAP queue A step 9)")
        if not exclude:
            # the synchronous loop's draw, verbatim
            return [int(c) for c in state.rng.choice(pop, k, replace=False)]
        # the semi-async loop's pool + draw, verbatim
        pool = np.array([c for c in range(pop) if c not in exclude])
        if not len(pool):
            return []
        return [int(c) for c in
                state.rng.choice(pool, min(k, len(pool)), replace=False)]


SCHEDULERS: Dict[str, type] = {"uniform": UniformParticipation}

_LATER = ("availability", "resource_gated", "trace")


def build_scheduler(cfg) -> ParticipationScheduler:
    """Scheduler per ``FLConfig.participation`` (default: uniform)."""
    name = getattr(cfg, "participation", "uniform") or "uniform"
    if name in _LATER:
        raise NotImplementedError(
            f"participation={name!r} is not ported yet "
            "(ROADMAP queue A step 9)")
    if name not in SCHEDULERS:
        raise ValueError(f"unknown participation scheduler {name!r}; "
                         f"have {sorted(SCHEDULERS)}")
    return SCHEDULERS[name]()
