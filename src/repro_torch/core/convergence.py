"""Convergence bound machinery (Heroes, Sec. IV–V.B).

Implements the approximated bound Eq. (23)::

    G(H, tau) = 4 F(x0) / (H eta tau) + L eta tau / 3 * (G^2 + 18 sigma^2)
                + 6 L^2 beta^2

its minimiser over tau (Sec. V-B)::

    tau* = sqrt( 12 F(x0) / (eta^2 H L (G^2 + 18 sigma^2)) )

and the per-client total-completion-time objective Eq. (27)::

    T_n(H) = H * ( tau*(H) * mu_n + nu_n )

The PS uses :func:`solve_rounds` to find the smallest H whose bound reaches
the convergence threshold eps, then :func:`total_time` ranks clients to find
the fastest one (Alg. 1 lines 12–14).
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass
class BoundState:
    """Aggregated estimates driving the bound (PS side, Alg. 1 line 25)."""

    loss0: float  # F(x^h) — current global loss, used as F(x0) in Eq. 27
    smoothness: float  # L
    grad_sq: float  # G^2
    noise_sq: float  # sigma^2
    beta_sq: float = 0.0  # upper bound on coefficient reducing error alpha
    lr: float = 0.01  # eta

    def noise_term(self) -> float:
        return self.grad_sq + 18.0 * self.noise_sq


def bound(state: BoundState, rounds: int, tau: float) -> float:
    """Eq. (23).  Guard against degenerate inputs (early rounds).

    Note: ``tau`` is the *real-valued* theory variable here — integer
    clamping happens only when the scheduler assigns frequencies, otherwise
    the tau >= 1 floor would make the bound non-decreasing in H and
    ``solve_rounds`` could never terminate below h_max.
    """
    h = max(int(rounds), 1)
    t = max(float(tau), 1e-9)
    term1 = 4.0 * state.loss0 / (h * state.lr * t)
    term2 = state.smoothness * state.lr * t / 3.0 * state.noise_term()
    term3 = 6.0 * state.smoothness**2 * state.beta_sq
    return term1 + term2 + term3


def tau_star(state: BoundState, rounds: int) -> float:
    """Convergence-optimal local update frequency (Sec. V-B)."""
    h = max(int(rounds), 1)
    denom = state.lr**2 * h * state.smoothness * state.noise_term()
    if denom <= 0:
        return 1.0
    return math.sqrt(12.0 * state.loss0 / denom)


def solve_rounds(state: BoundState, eps: float, h_max: int = 100_000) -> int:
    """Smallest H with bound(H, tau*(H)) <= eps (bisection; bound is
    monotone decreasing in H at tau*).  Returns h_max if eps is below the
    6 L^2 beta^2 floor."""
    lo, hi = 1, h_max
    if bound(state, hi, tau_star(state, hi)) > eps:
        return h_max
    while lo < hi:
        mid = (lo + hi) // 2
        if bound(state, mid, tau_star(state, mid)) <= eps:
            hi = mid
        else:
            lo = mid + 1
    return lo


def total_time(state: BoundState, rounds: int, mu: float, nu: float) -> float:
    """Eq. (27): projected completion time if this client is the pacesetter."""
    t = tau_star(state, rounds)
    return rounds * (t * mu + nu)
