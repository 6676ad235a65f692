"""Shared FL runtime types.

``FLConfig`` and ``RoundLog`` are the engine's data model; ``ServerState``
is the explicit round state that ``RoundLoop.run_round(state) ->
(state', RoundLog)`` threads through the ``AssignmentPolicy`` /
``LocalTrainer`` / ``Aggregator`` contracts.  They live here (below
:mod:`repro_torch.fl.engine`) so policy modules can share the data model
without import cycles.  ``FLConfig`` keeps the JAX package's knobs and
defaults; the engine raises ``ValueError`` for values no engine runs
(``repro_torch.fl.engine.runner.check_ported``).
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
    # Local-training backend: "sequential" (one local_train per client)
    # or "cohort" (each group of clients of one width and batch size
    # stacked and trained in one batched step).
    trainer: str = "sequential"
    # Round event loop: "sync" (paper Eq. 19 makespan round) or
    # "semi_async" (aggregate the fastest async_k of the clients in
    # flight; 0 => clients_per_round // 2; stragglers merge later with
    # weight staleness_decay ** staleness).
    round_mode: str = "sync"
    async_k: int = 0
    staleness_decay: float = 0.5
    # FedProx proximal coefficient (the fedprox scheme's local solver:
    # every SGD step adds mu * (w - w_global); 0 gives FedAvg's step).
    prox_mu: float = 0.01
    # Evaluation streams the test set in slices of this many samples;
    # <= 0 evaluates the full test batch in one forward.
    eval_batch_size: int = 0
    # Aggregation backend: "collective" (the default) or "host".  On one
    # device both run the per-client host loops (the JAX package's
    # collective merge equals them bit for bit there); over two or more
    # shards the collective backend merges the stacked cohort shard by
    # shard and folds the partials (repro_torch.fl.engine.collective).
    # agg_devices caps the merge's shards (0 => all local devices,
    # repro_torch.sharding.fl.cohort_mesh).
    agg_backend: str = "collective"
    agg_devices: int = 0
    # The cohort trainer's shards (the client axis split over that many
    # devices; 0 => all local devices, 1 => one).
    trainer_mesh_devices: int = 0
    # Sample-count-weighted aggregation: weight every client's merge
    # contribution by its shard size (K * s_n / sum(s) through the
    # aggregators' blend weights), exact for the global-mean rules
    # (FedAvg/ADP/basis means); partitioned rules (Heroes blocks,
    # HeteroFL regions, Flanc widths) see an extrapolated weighting.
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
    # --- population and checkpoints --------------------------------------
    # Who is offered each round (repro_torch.fl.population.schedulers):
    # "uniform", "availability", "resource_gated" or "trace".
    participation: str = "uniform"
    # > 1 splits each merge cohort into that many contiguous edge groups
    # on the collective backend; the merged state is the flat merge's and
    # each group's partial fold is kept (runner.merger.last_partials).
    edge_groups: int = 0
    # Keep each factorized coefficient split over its block axis across
    # the merge's shards, where the block count divides the shard count
    # (repro_torch.sharding.fl.SplitBlocks); dense and per-width states
    # stay whole.
    shard_server_state: bool = False
    # Save the ServerState every checkpoint_every rounds under
    # checkpoint_dir, keeping the newest checkpoint_keep (0: never).
    checkpoint_every: int = 0
    checkpoint_dir: Optional[str] = None
    checkpoint_keep: int = 3
    # --- telemetry (repro_torch.obs) -------------------------------------
    # "off" (default): the shared no-op recorder — zero overhead, nothing
    # synchronizes, and the instrumented paths give the same histories
    # bit for bit.  "memory": in-process MemorySink (tests/notebooks).
    # "jsonl": append every span/event to ``<telemetry_dir>/events.jsonl``
    # with a final metrics snapshot at close; render with
    # ``python -m repro_torch.obs.report``.  With either, the wall spans
    # around device work end with a synchronize of the CUDA device.
    telemetry: str = "off"
    telemetry_dir: Optional[str] = None
