"""Client heterogeneity model (paper Sec. VI-C).

The paper simulates 100 clients on a workstation and models:
  * one-local-iteration time ~ Gaussian per hardware tier (laptop, Jetson
    TX2, Xavier NX, AGX Xavier time records);
  * download bandwidth fluctuating 10–20 Mb/s, upload 1–5 Mb/s.

We reproduce that model: each client gets a tier (compute scale) and
per-round fluctuating bandwidth.  The *scheduler* consumes (mu, nu)
exactly as Alg. 1 does; the *simulator* charges the same costs to the
virtual wall clock.  (The hardware the simulation runs on is homogeneous,
so wall-time heterogeneity is modelled.)
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Tuple, Union

import numpy as np

# (mean seconds per 1 GFLOP of local-iteration work, std fraction) —
# scaled from the paper's tier ordering: laptop fastest, TX2 slowest.
TIERS = {
    "laptop": (0.010, 0.10),
    "agx_xavier": (0.018, 0.12),
    "xavier_nx": (0.035, 0.15),
    "tx2": (0.060, 0.20),
}
TIER_NAMES = list(TIERS)

# Keyed-stream tag for per-client capability profiles: profiles must be a
# pure function of (seed, client_id), so the stream is disjoint from the
# engine's (seed, round, client) batch streams and the (client_seed,
# round, tag) time/bandwidth streams.
_PROFILE_TAG = 0x9E3779B9


@dataclasses.dataclass
class ClientResources:
    tier: str
    compute_scale: float  # seconds per GFLOP (per-client mean)
    seed: int
    # fraction of rounds the device is reachable (virtual profiles only;
    # resident models predate the field and default to always-on) —
    # consumed by the availability participation scheduler
    availability: float = 1.0


@functools.lru_cache(maxsize=65536)
def client_profile(seed: int, n: int,
                   tier_weights: Tuple[float, ...]) -> ClientResources:
    """Capability profile of client ``n`` as a pure function of the seed.

    Unlike the resident constructor loop (one shared sequential RNG),
    every client draws from its own keyed stream, so the profile is
    independent of the population size and of the order clients are
    queried in — the property that lets 10^5+ client populations exist
    without a resident list.
    """
    rng = np.random.default_rng((seed, _PROFILE_TAG, n))
    w = np.asarray(tier_weights, np.float64)
    w = w / w.sum()
    t = int(min(np.searchsorted(np.cumsum(w), rng.random(), side="right"),
                len(TIER_NAMES) - 1))
    tier = TIER_NAMES[t]
    mean, _ = TIERS[tier]
    scale = float(mean * rng.uniform(0.8, 1.2))
    cseed = int(rng.integers(2**31))
    availability = float(rng.uniform(0.35, 0.95))
    return ClientResources(tier, scale, cseed, availability)


class _VirtualClientMap:
    """Lazily derived profiles quacking like the resident clients dict.

    Supports the accesses the runtime makes (``clients[n]``, ``len``,
    ``in``, iteration) while holding nothing per client — each lookup is
    :func:`client_profile`, cached across the process.
    """

    __slots__ = ("size", "seed", "tier_weights")

    def __init__(self, size: int, seed: int, tier_weights: Tuple[float, ...]):
        self.size = size
        self.seed = seed
        self.tier_weights = tier_weights

    def __len__(self) -> int:
        return self.size

    def __contains__(self, n) -> bool:
        return 0 <= int(n) < self.size

    def __iter__(self):
        return iter(range(self.size))

    def __getitem__(self, n) -> ClientResources:
        n = int(n)
        if not 0 <= n < self.size:
            raise KeyError(n)
        return client_profile(self.seed, n, self.tier_weights)


class HeterogeneityModel:
    """Per-client, per-round (mu, nu) sampler.

    ``virtual=True`` derives profiles on demand through
    :func:`client_profile` instead of materializing the resident dict —
    O(1) memory in the population, identical ``iter_time``/
    ``upload_time``/``download_time`` streams given the same profile.
    The resident constructor keeps its original sequential draws so
    existing seeded histories stay bitwise.
    """

    def __init__(self, num_clients: int, seed: int = 0,
                 tier_weights: Tuple[float, ...] = (0.25, 0.25, 0.25, 0.25),
                 virtual: bool = False):
        self.seed = seed
        self.tier_weights = tuple(float(w) for w in tier_weights)
        self.virtual = virtual
        rng = np.random.default_rng(seed)
        if virtual:
            self.clients: Union[Dict[int, ClientResources], _VirtualClientMap] \
                = _VirtualClientMap(num_clients, seed, self.tier_weights)
        else:
            self.clients = {}
            for n in range(num_clients):
                tier = rng.choice(TIER_NAMES, p=np.asarray(tier_weights) / sum(tier_weights))
                mean, frac = TIERS[tier]
                scale = float(mean * rng.uniform(0.8, 1.2))
                self.clients[n] = ClientResources(str(tier), scale, int(rng.integers(2**31)))
        self._rng = rng
        self.round = 0

    def advance_round(self) -> None:
        self.round += 1

    def iter_time(self, client: int, flops_per_iter: float) -> float:
        """mu_n^h (Eq. 17): seconds for one local iteration."""
        c = self.clients[client]
        rng = np.random.default_rng((c.seed, self.round))
        _, frac = TIERS[c.tier]
        noise = float(np.clip(rng.normal(1.0, frac), 0.5, 2.0))
        return c.compute_scale * (flops_per_iter / 1e9) * noise

    def upload_time(self, client: int, num_bytes: float) -> float:
        """nu_n^h (Eq. 18): upload seconds at 1–5 Mb/s."""
        c = self.clients[client]
        rng = np.random.default_rng((c.seed, self.round, 7))
        mbps = rng.uniform(1.0, 5.0)
        return float(num_bytes * 8 / (mbps * 1e6))

    def download_time(self, client: int, num_bytes: float) -> float:
        """10–20 Mb/s — the paper treats download as negligible vs upload."""
        c = self.clients[client]
        rng = np.random.default_rng((c.seed, self.round, 13))
        mbps = rng.uniform(10.0, 20.0)
        return float(num_bytes * 8 / (mbps * 1e6))
