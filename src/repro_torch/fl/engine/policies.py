"""Assignment policies: who trains which width / tau / blocks.

These encode the per-scheme differences of paper Sec. VI-B:

  FullWidthAssignment   FedAvg / ADP — everyone at width P, identical tau
                        (optionally the adaptive tau* of Eq. 26)
  TierWidthAssignment   HeteroFL / Flanc — width by hardware tier,
                        fixed tau
  HeroesAssignment      Alg. 1 — greedy width growth, pacesetter tau*,
                        variance-minimising tau, least-trained blocks

Policies are pure with respect to round state: ``assign(state, clients)``
returns ``(state', assigns)``, and the Heroes block/anchored tallies live
in ``state.sched``.  The ``HeroesScheduler`` is a stateless planner whose
``counters`` scratch is synced from the state on every call.  Host-side
numpy, identical to the JAX package's control logic.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import convergence
from repro_torch.core.composition import select_blocks
from repro_torch.core.scheduler import HeroesScheduler, SchedulerConfig
from repro_torch.fl.engine.base import Assignment, AssignmentPolicy
from repro_torch.fl.heterogeneity import HeterogeneityModel
from repro_torch.fl.types import SchedState, ServerState

# auto-mu_max probes at most this many clients (exact below, an evenly
# spaced sample above)
_MU_PROBE = 1024


def _record_coverage(obs, assigns: Dict[int, Assignment]) -> None:
    """Per-tensor coverage telemetry for one assignment event.

    Tallies ``coverage.{hidden,anchored}_rounds`` (+1 for every block
    included in at least one client's assignment this event — divided by
    ``coverage.events`` this is the paper-Fig.-2 coverage fraction) and
    ``coverage.{hidden,anchored}_iters`` (tau-weighted per-block
    training iterations, the Heroes scheduler's own counter signal).
    Reads only the assignment dicts the policy already built.
    """
    if not obs.enabled:
        return
    obs.counter_add("coverage.events")
    unions = {"hidden": set(), "anchored": set()}
    for a in assigns.values():
        tau = int(a["tau"])
        for fam in unions:
            ids = a.get(f"{fam}_ids")
            if ids is None or len(ids) == 0:
                continue
            obs.tally_add(f"coverage.{fam}_iters", ids, tau)
            unions[fam].update(int(i) for i in np.atleast_1d(ids))
    for fam, union in unions.items():
        if union:
            obs.tally_add(f"coverage.{fam}_rounds", sorted(union))


def tier_width(het: HeterogeneityModel, n: int, max_width: int) -> int:
    """Static width by hardware tier (HeteroFL / Flanc assignment rule)."""
    order = {"laptop": max_width, "agx_xavier": max(max_width - 1, 1),
             "xavier_nx": max(max_width - 2, 1), "tx2": 1}
    return min(order[het.clients[n].tier], max_width)


class FullWidthAssignment(AssignmentPolicy):
    """Everyone trains the full-width model with one shared tau."""

    def __init__(self, adaptive_tau: bool = False):
        self.adaptive_tau = adaptive_tau

    def assign(self, state: ServerState, clients: Sequence[int],
               ) -> Tuple[ServerState, Dict[int, Assignment]]:
        eng = self.eng
        tau = eng.cfg.tau_fixed
        if self.adaptive_tau and state.round > 0:
            t = convergence.tau_star(state.bound_state,
                                     max(200 - state.round, 1))
            tau = int(np.clip(round(t), 1, eng.cfg.tau_max))
        return state, {n: {"width": eng.P, "tau": tau} for n in clients}


class TierWidthAssignment(AssignmentPolicy):
    """Width by hardware tier, fixed identical tau."""

    def assign(self, state: ServerState, clients: Sequence[int],
               ) -> Tuple[ServerState, Dict[int, Assignment]]:
        eng = self.eng
        return state, {n: {"width": tier_width(eng.het, n, eng.P),
                           "tau": eng.cfg.tau_fixed} for n in clients}


class HeroesAssignment(AssignmentPolicy):
    """Heroes Alg. 1: scheduler-driven width/tau + least-trained blocks.

    The hidden-layer P^2 counter and the anchored-layer P-block counter
    shared by the boundary layers live in ``state.sched``; ``assign``
    copies them, charges the copies, and returns a state with the fresh
    tallies.
    """

    def setup(self, eng) -> None:
        super().setup(eng)
        model, cfg = eng.model, eng.cfg
        self.P = next(iter(model.specs.values())).max_width
        square_spec = next(s for s in model.specs.values() if s.mode == "square")
        self._anch_spec = next(
            (s for s in model.specs.values() if s.mode != "square"), None)
        mu_max = cfg.mu_max
        if mu_max <= 0:
            # auto: ~10x the median width-1 iteration time, so width
            # assignments spread across tiers at any model scale
            ns = range(cfg.num_clients)
            if cfg.num_clients > _MU_PROBE:
                ns = np.linspace(0, cfg.num_clients - 1,
                                 _MU_PROBE).round().astype(np.int64)
            med = float(np.median([
                eng.het.iter_time(int(n), eng.flops_per_iter(1))
                for n in ns]))
            mu_max = 10.0 * med
        self.scheduler = HeroesScheduler(
            square_spec,
            SchedulerConfig(mu_max=mu_max, rho=cfg.rho,
                            eps=cfg.eps, tau_max=cfg.tau_max),
            iter_time_fn=lambda n, p: eng.het.iter_time(n, eng.flops_per_iter(p)),
            comm_time_fn=lambda n, p: eng.het.upload_time(
                n, eng.model.factorized_bytes(p)),
        )
        if eng.obs.enabled:
            # pre-size the coverage tallies to the model's block counts
            # so never-trained blocks still render as 0% rows
            nb = self.scheduler.spec.num_blocks
            for name in ("coverage.hidden_rounds", "coverage.hidden_iters"):
                eng.obs.tally_add(name, [nb - 1], 0)
            if self._anch_spec is not None:
                for name in ("coverage.anchored_rounds",
                             "coverage.anchored_iters"):
                    eng.obs.tally_add(name, [self.P - 1], 0)

    def init_state(self, state: ServerState) -> ServerState:
        return dataclasses.replace(state, sched=SchedState(
            counters=np.zeros(self.scheduler.spec.num_blocks, np.int64),
            anchored=np.zeros(self.P, np.int64)))

    def _charge(self, anchored: np.ndarray, width: int, tau: int,
                hidden_ids: np.ndarray, predefined: bool) -> Assignment:
        """Charge the anchored counter and build one client's assignment.

        ``predefined`` is the round-0 rule (Alg. 1 h=0): anchored layers
        take the first ``width`` blocks.  Planned rounds select the
        least-trained anchored blocks, mirroring the hidden-layer rule.
        """
        if predefined:
            anch_ids: Optional[np.ndarray] = np.arange(min(width, self.P))
        elif self._anch_spec is not None:
            anch_ids = select_blocks(anchored, width, self._anch_spec)
        else:
            anch_ids = None
        if anch_ids is not None:
            anchored[anch_ids] += tau
        return {"width": width, "tau": tau,
                "hidden_ids": hidden_ids, "anchored_ids": anch_ids}

    def assign(self, state: ServerState, clients: Sequence[int],
               ) -> Tuple[ServerState, Dict[int, Assignment]]:
        eng = self.eng
        counters = np.array(state.sched.counters, dtype=np.int64)
        anchored = np.array(state.sched.anchored, dtype=np.int64)
        if state.round == 0:
            # h=0: identical predefined frequency, no estimates yet (Alg. 1)
            tau = eng.cfg.tau_fixed
            out = {}
            for n in clients:
                width = self.scheduler.assign_width(n)
                ids = select_blocks(counters, width, self.scheduler.spec)
                counters[ids] += tau
                out[n] = self._charge(anchored, width, tau, ids,
                                      predefined=True)
        else:
            self.scheduler.counters = counters
            plan = self.scheduler.plan_round(clients, state.bound_state)
            counters = self.scheduler.counters
            out = {n: self._charge(anchored, a.width, a.tau, a.block_ids,
                                   predefined=False)
                   for n, a in plan.assignments.items()}
        # keep the planner's scratch mirroring the authoritative tallies
        self.scheduler.counters = counters
        _record_coverage(eng.obs, out)
        return (dataclasses.replace(state,
                                    sched=SchedState(counters, anchored)),
                out)
