"""Greedy tensor + local-update-frequency assignment (Heroes Alg. 1).

The PS-side control loop of a round:

1. Width assignment (lines 6-11): greedily grow each client's width ``p``
   while one-iteration time stays under ``mu_max``.
2. Pacesetter selection (lines 12-14): for every client, solve the
   univariate problem Eq. (26)/(27) — smallest H meeting the convergence
   threshold, then projected total time; pick the minimiser l.
3. Frequency assignment (lines 15-19): tau_l = tau*(H); every other client
   searches tau in the window [tau_a, tau_b] given by the waiting-time
   bound rho (Eq. 24) to minimise the block-counter variance V^h (Eq. 21).
4. Block selection (line 20): the (p_n)^2 least-trained blocks.

This module is pure control logic on host scalars/numpy — it consumes the
heterogeneity model's (mu, nu) estimates and the aggregated bound state,
and emits per-client assignments.  No jax tracing here.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

import numpy as np

from repro_torch.core import convergence
from repro_torch.core.composition import CompositionSpec, select_blocks


@dataclasses.dataclass
class ClientAssignment:
    client: int
    width: int
    tau: int
    block_ids: np.ndarray
    est_iter_time: float  # mu_n^h
    est_comm_time: float  # nu_n^h

    @property
    def est_completion(self) -> float:
        return self.tau * self.est_iter_time + self.est_comm_time


@dataclasses.dataclass
class RoundPlan:
    assignments: Dict[int, ClientAssignment]
    pacesetter: int
    rounds_to_go: int
    makespan: float  # T^h (Eq. 19) as estimated

    def avg_waiting(self) -> float:
        """Estimated W^h (Eq. 20)."""
        t = [a.est_completion for a in self.assignments.values()]
        return float(np.mean([self.makespan - x for x in t]))


@dataclasses.dataclass
class SchedulerConfig:
    mu_max: float  # max time budget for one local iteration (width growth stop)
    rho: float  # waiting-time bound (Eq. 24)
    eps: float = 0.05  # convergence threshold on the bound
    tau_min: int = 1
    tau_max: int = 200
    h_max: int = 100_000


class HeroesScheduler:
    """Stateful PS scheduler: owns the block counters ``c_i``."""

    def __init__(
        self,
        spec: CompositionSpec,
        config: SchedulerConfig,
        iter_time_fn: Callable[[int, int], float],
        comm_time_fn: Callable[[int, int], float],
    ):
        """
        Args:
          spec: composition spec (global counter size = spec.num_blocks).
          iter_time_fn(client, width) -> mu_n^h   (seconds / local iteration)
          comm_time_fn(client, width) -> nu_n^h   (upload seconds)
        """
        self.spec = spec
        self.config = config
        self.iter_time = iter_time_fn
        self.comm_time = comm_time_fn
        self.counters = np.zeros(spec.num_blocks, dtype=np.int64)

    # -- Alg.1 lines 6-11 ---------------------------------------------------
    def assign_width(self, client: int) -> int:
        p = 1
        while p < self.spec.max_width:
            if self.iter_time(client, p + 1) >= self.config.mu_max:
                break
            p += 1
        return p

    # -- Alg.1 lines 12-14 --------------------------------------------------
    def _pacesetter(
        self, clients: Sequence[int], widths: Dict[int, int], state: convergence.BoundState
    ) -> tuple[int, int, int]:
        """Returns (pacesetter, H, tau_l)."""
        rounds = convergence.solve_rounds(state, self.config.eps, self.config.h_max)
        best, best_T = None, float("inf")
        for n in clients:
            mu = self.iter_time(n, widths[n])
            nu = self.comm_time(n, widths[n])
            T = convergence.total_time(state, rounds, mu, nu)
            if T < best_T:
                best, best_T = n, T
        tau_l = int(np.clip(round(convergence.tau_star(state, rounds)),
                            self.config.tau_min, self.config.tau_max))
        return best, rounds, tau_l

    # -- Alg.1 lines 15-19 --------------------------------------------------
    def _tau_window(self, makespan: float, mu: float, nu: float) -> tuple[int, int]:
        """Eq. (24): 0 <= T_l - (tau mu + nu) <= rho."""
        hi = int(np.floor((makespan - nu) / max(mu, 1e-9)))
        lo = int(np.ceil((makespan - self.config.rho - nu) / max(mu, 1e-9)))
        lo = max(lo, self.config.tau_min)
        hi = max(min(hi, self.config.tau_max), lo)
        return lo, hi

    def _variance_minimising_tau(
        self, counters: np.ndarray, block_ids: np.ndarray, lo: int, hi: int
    ) -> int:
        """Search tau in [lo, hi] minimising Var(c + tau * 1_blocks) (Eq. 21)."""
        best_tau, best_var = lo, float("inf")
        base = counters.astype(np.float64)
        mask = np.zeros_like(base)
        mask[block_ids] = 1.0
        for tau in range(lo, hi + 1):
            c = base + tau * mask
            var = float(np.var(c))
            if var < best_var:
                best_var, best_tau = var, tau
        return best_tau

    # -- full round ----------------------------------------------------------
    def plan_round(
        self,
        clients: Sequence[int],
        state: convergence.BoundState,
        widths: Optional[Dict[int, int]] = None,
    ) -> RoundPlan:
        if widths is None:
            widths = {n: self.assign_width(n) for n in clients}
        pacesetter, rounds, tau_l = self._pacesetter(clients, widths, state)

        assignments: Dict[int, ClientAssignment] = {}
        # pacesetter first — its completion time anchors everyone else
        mu_l = self.iter_time(pacesetter, widths[pacesetter])
        nu_l = self.comm_time(pacesetter, widths[pacesetter])
        makespan = tau_l * mu_l + nu_l

        # temp counter copy: assignments in this round feed later clients'
        # variance search (Alg.1 line 22 updates c_i inside the loop)
        counters = self.counters.copy()

        ids_l = select_blocks(counters, widths[pacesetter], self.spec)
        counters[ids_l] += tau_l
        assignments[pacesetter] = ClientAssignment(
            pacesetter, widths[pacesetter], tau_l, ids_l, mu_l, nu_l
        )

        for n in clients:
            if n == pacesetter:
                continue
            mu, nu = self.iter_time(n, widths[n]), self.comm_time(n, widths[n])
            lo, hi = self._tau_window(makespan, mu, nu)
            ids = select_blocks(counters, widths[n], self.spec)
            tau = self._variance_minimising_tau(counters, ids, lo, hi)
            counters[ids] += tau
            assignments[n] = ClientAssignment(n, widths[n], tau, ids, mu, nu)

        self.counters = counters
        # Eq. (19): the round is paced by the slowest client.  The
        # pacesetter anchors the tau windows, but a wide/slow client can
        # exceed its anchor even at tau=1 — the true makespan is the max.
        makespan = max(a.est_completion for a in assignments.values())
        return RoundPlan(assignments, pacesetter, rounds, makespan)

    # -- bookkeeping -----------------------------------------------------------
    def counter_variance(self) -> float:
        """V^h (Eq. 21) over the live counters."""
        return float(np.var(self.counters.astype(np.float64)))
