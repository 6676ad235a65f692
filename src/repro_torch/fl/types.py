"""Shared FL runtime types.

``FLConfig`` and ``RoundLog`` are the engine's data model; ``ServerState``
is the explicit round state that ``RoundLoop.run_round(state) ->
(state', RoundLog)`` threads through the ``AssignmentPolicy`` /
``LocalTrainer`` / ``Aggregator`` contracts.  They live here (below
:mod:`repro_torch.fl.engine`) so policy modules can share the data model
without import cycles.  ``FLConfig`` keeps the JAX package's knobs and
defaults; the engine raises ``NotImplementedError`` for values this port
does not run yet (see ``repro_torch.fl.engine.registry``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class RoundLog:
    round: int
    wall_time: float  # cumulative virtual seconds
    traffic_bytes: float  # cumulative
    makespan: float  # this round's T^h
    avg_wait: float  # this round's W^h
    mean_tau: float
    accuracy: Optional[float] = None
    stale: int = 0  # results merged with staleness >= 1 (semi-async only)
    # Directional traffic split of this round's contribution to
    # ``traffic_bytes`` (uplink = client->server results, downlink =
    # server->client payloads).  Their sum equals the round's traffic
    # delta bitwise (2*b == b+b in IEEE); summaries report them apart.
    up_bytes: float = 0.0
    down_bytes: float = 0.0


@dataclasses.dataclass
class SchedState:
    """Heroes scheduler bookkeeping (per-block training-iteration tallies).

    Owned by :class:`ServerState` so it is checkpointed with the run; the
    ``HeroesScheduler`` instance itself is a stateless planner whose
    ``counters`` scratch is synced from here on every ``assign``.
    """

    counters: np.ndarray  # (num_blocks,) int64 — hidden-layer tallies
    anchored: np.ndarray  # (P,) int64 — anchored (first/last) layer tallies


@dataclasses.dataclass
class InFlight:
    """One dispatched-but-unmerged semi-async client update."""

    client: int
    assign: Dict[str, Any]  # the assignment the client trained under
    result: Any  # repro_torch.fl.client.ClientResult
    finish: float  # virtual completion time (train + upload)
    dispatched: int  # round index at dispatch (staleness anchor)


@dataclasses.dataclass
class ServerState:
    """Everything the server carries between rounds, in one place.

    ``RoundLoop.run_round(state)`` returns a NEW instance (via
    ``dataclasses.replace``) rather than mutating engine attributes, so a
    round boundary is a value that can be checkpointed, diffed, or handed
    to another aggregator.  Two fields advance in place by design:
    ``rng`` (a live numpy Generator — its ``bit_generator.state`` is what
    gets checkpointed) and ``participation`` (shared by identity with
    ``PopulationRegistry`` as the single bookkeeping store).
    """

    rng: np.random.Generator
    bound_state: Any  # repro_torch.core.convergence.BoundState
    params: Any = None  # scheme-shaped global model pytree
    round: int = 0  # completed rounds
    wall: float = 0.0  # cumulative virtual seconds
    traffic: float = 0.0  # cumulative bytes (up + down)
    traffic_up: float = 0.0  # cumulative uplink bytes
    traffic_down: float = 0.0  # cumulative downlink bytes
    sched: Optional[SchedState] = None  # Heroes only
    participation: Dict[int, int] = dataclasses.field(default_factory=dict)
    in_flight: Tuple[InFlight, ...] = ()  # semi-async dispatch records
    history: Tuple[RoundLog, ...] = ()


@dataclasses.dataclass
class FLConfig:
    num_clients: int = 100
    clients_per_round: int = 10
    lr: float = 0.05
    batch_size: int = 16
    tau_fixed: int = 10
    eval_every: int = 5
    seed: int = 0
    # Heroes scheduler knobs.  eps is the convergence threshold on the
    # mean-square-gradient bound (Eq. 22) — it lives on the scale of
    # G^2 + 18 sigma^2, so O(1) values are the useful regime.
    mu_max: float = 0.0  # <=0 => auto (10x median width-1 iter time)
    rho: float = 2.0
    eps: float = 1.0
    tau_max: int = 50
    estimate: bool = True
    # --- engine knobs (repro_torch.fl.engine) ----------------------------
    # Local-training backend: "sequential" (one local_train per client).
    # "cohort" (stacked clients in one batched step) is not ported yet.
    trainer: str = "sequential"
    # Round event loop: "sync" (paper Eq. 19 makespan round).
    # "semi_async" is not ported yet; its two knobs below are kept.
    round_mode: str = "sync"
    async_k: int = 0
    staleness_decay: float = 0.5
    # FedProx proximal coefficient (the fedprox scheme, not ported yet).
    prox_mu: float = 0.01
    # Evaluation streams the test set in slices of this many samples;
    # <= 0 evaluates the full test batch in one forward.
    eval_batch_size: int = 0
    # Aggregation backend: "host" (the per-client merge loops) runs here;
    # "collective" (the default, one stacked merge per round) is not
    # ported yet, so callers pass agg_backend="host".
    agg_backend: str = "collective"
    agg_devices: int = 0
    trainer_mesh_devices: int = 0
    # Weight every client's merge contribution by its shard size (not
    # ported yet: True raises).
    sample_weighted: bool = False
    # Factorized (Heroes-style) client compute path:
    #   "auto"        per (layer, width, batch): rank-space application
    #                 where the FLOPs model with the measured calibration
    #                 says it wins, composed weights (or the fused
    #                 compose+apply kernel) elsewhere.
    #   "materialize" compose every layer first.
    #   "rank_space"  the factorized contraction for every rank-capable
    #                 layer.
    # Dense schemes (FedAvg) are unaffected.
    forward_impl: str = "auto"
    # Rank-path cost-model calibration pins (forward_impl="auto" and
    # clock_model="rank_aware"): 0.0 = measure once per process and
    # device (repro_torch.core.calibration); > 0 pins the knob.
    #   conv_rank_overhead  cost multiplier of the fused conv rank path
    #                       relative to its FLOPs count
    #   fused_compose_gain  fused compose+apply time over separate
    #                       compose-then-matmul; < 1 routes weight-shaped
    #                       dense layers through the fused kernel
    conv_rank_overhead: float = 0.0
    fused_compose_gain: float = 0.0
    # Virtual-clock client time model: "dense" charges the materialised
    # width-p forward+backward; "rank_aware" charges the per-layer impl
    # the client forward takes under forward_impl.
    clock_model: str = "dense"
    # --- knobs of later slices, kept with the reference's defaults -------
    # participation schedulers other than "uniform", hierarchical edge
    # merges and sharded server state (population / collective), and
    # checkpointing and telemetry: the engine raises NotImplementedError
    # for any value but these defaults.
    participation: str = "uniform"
    edge_groups: int = 0
    shard_server_state: bool = False
    checkpoint_every: int = 0
    checkpoint_dir: Optional[str] = None
    checkpoint_keep: int = 3
    telemetry: str = "off"
    telemetry_dir: Optional[str] = None
