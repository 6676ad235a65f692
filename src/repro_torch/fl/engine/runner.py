"""The engine runner: component wiring around an explicit ServerState.

The runner owns the *static* collaborators — model, data partitions,
heterogeneity model, the collective merger, the scheme components, the
device — and exactly ONE mutable slot: ``self.state``, the current
:class:`~repro_torch.fl.types.ServerState`.  Each ``run_round`` installs
the state returned by the loop and (when ``FLConfig.checkpoint_every`` is
set) saves it at the round boundary through
:mod:`repro_torch.checkpoint.msgpack_ckpt`; ``restore_latest`` rebuilds the
state from the newest checkpoint, so the continued run is bit-identical
to an uninterrupted one.  The format is the JAX package's: a checkpoint
its runner wrote restores here, on any device, and the other way round.
The public surface is the reference's (``run``, ``run_round``,
``run_until_budget``, ``history``, ``eval_accuracy``, ``rng``; round
counters as read-only properties over the state).  ``state.params`` is
public: a caller may replace it (for example with another engine's
initial weights, through :func:`repro_torch.convert.from_jax_params`)
before the first round.

The runner runs on the CUDA device unless the caller passes
``device="cpu"``; with no CUDA device and no explicit request it raises.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
import repro_torch.checkpoint.msgpack_ckpt as msgpack_ckpt
from repro_torch.core import convergence
from repro_torch.data.streaming import ClientDataLoader
from repro_torch.fl.engine import collective
from repro_torch.fl.engine import state as state_lib
from repro_torch.fl.engine.base import (Aggregator, AssignmentPolicy,
                                        LocalTrainer, ParticipationScheduler,
                                        PayloadModel, RoundLoop)
from repro_torch.fl.heterogeneity import HeterogeneityModel
from repro_torch.fl.models import FLModelDef
from repro_torch.fl.population.schedulers import build_scheduler
from repro_torch.fl.types import FLConfig, RoundLog, ServerState
from repro_torch.obs import build_recorder


def check_ported(cfg: FLConfig) -> None:
    """Raise ``ValueError`` for knob values no engine runs."""
    if cfg.agg_backend not in ("collective", "host"):
        raise ValueError(f"unknown agg_backend {cfg.agg_backend!r}")
    if cfg.clock_model not in ("dense", "rank_aware"):
        raise ValueError(f"unknown clock_model {cfg.clock_model!r} "
                         f"(expected 'dense' or 'rank_aware')")


class EngineRunner:
    """A scheme = components threading one ServerState."""

    def __init__(self, scheme: str, model: FLModelDef, parts_x, parts_y,
                 test_batch, het: HeterogeneityModel, cfg: FLConfig,
                 eval_width: int, *, assignment: AssignmentPolicy,
                 payload: PayloadModel, aggregator: Aggregator,
                 trainer: LocalTrainer, loop: RoundLoop,
                 factorized: bool, estimate: bool, device=None,
                 sampler: Optional[ParticipationScheduler] = None):
        check_ported(cfg)
        self.device = resolve_device(device)
        self.scheme = scheme
        self.model = model
        self.parts_x, self.parts_y = parts_x, parts_y
        # telemetry recorder (repro_torch.obs); cfg.telemetry="off" gives
        # the shared no-op.  Built first so every component (the data
        # loader included) can bind to it
        self.obs = build_recorder(cfg, meta={
            "scheme": scheme, "config": dataclasses.asdict(cfg)},
            device=self.device)
        # shards may be lazy ShardViews or a population-scale
        # VirtualShardList (repro_torch.data.streaming)
        self.data = ClientDataLoader(parts_x, parts_y, self.device,
                                     model.input_key)
        self.data.obs = self.obs
        # population registry (virtual setups): adopts the state's
        # participation dict as its bookkeeping store (below)
        self.population = getattr(parts_x, "registry", None)
        self.test_batch = {k: v.to(self.device) for k, v in test_batch.items()}
        self.het = het
        self.cfg = cfg
        self.eval_width = eval_width
        self.P = next(iter(model.specs.values())).max_width
        self.factorized = factorized
        self.estimate = estimate
        # the collective backend's merger: the merge over the cohort's
        # shards when there are two or more (agg_devices), the edge
        # groups' partial folds beside the host rules on one device, else
        # None (the host rules alone).  It records no telemetry: the
        # aggregators count the merges (``aggregate.collective_calls``)
        # the reference's merger counts
        self.merger = None
        if cfg.agg_backend == "collective":
            self.merger = collective.build_merger(cfg, self.device)

        self.assignment = assignment
        self.payload = payload
        self.aggregator = aggregator
        self.trainer = trainer
        self.loop = loop
        self.sampler = sampler if sampler is not None else build_scheduler(cfg)
        for comp in (assignment, payload, aggregator, trainer, loop,
                     self.sampler):
            comp.setup(self)

        self.state = ServerState(
            rng=np.random.default_rng(cfg.seed),
            bound_state=convergence.BoundState(
                loss0=2.3, smoothness=1.0, grad_sq=1.0, noise_sq=0.5,
                lr=cfg.lr))
        self.state = aggregator.init_global(self.state)
        self.state = assignment.init_state(self.state)
        self._bind_population()

    def _bind_population(self) -> None:
        if self.population is not None:
            self.population.bind_participation(self.state.participation)

    # --- state views ------------------------------------------------------
    @property
    def round(self) -> int:
        return self.state.round

    @property
    def wall(self) -> float:
        return self.state.wall

    @property
    def traffic(self) -> float:
        return self.state.traffic

    @property
    def params(self):
        return self.state.params

    @property
    def bound_state(self):
        return self.state.bound_state

    @property
    def rng(self) -> np.random.Generator:
        return self.state.rng

    @property
    def history(self) -> List[RoundLog]:
        return list(self.state.history)

    # --- shared helpers ---------------------------------------------------
    def sample_clients(self, state: ServerState, k: int,
                       exclude=frozenset()) -> List[int]:
        """One round's cohort via the participation scheduler, none of it
        in ``exclude``; records participation in ``state.participation``."""
        clients = self.sampler.sample(state, k, exclude)
        for n in clients:
            state.participation[int(n)] = state.round
        if self.obs.enabled:
            # a virtual population's profiles come from its keyed
            # streams, one sampled client at a time
            for n in clients:
                self.obs.counter_add("participation.tier",
                                     tier=self.het.clients[int(n)].tier)
        return clients

    def sync_device(self) -> None:
        """Wait for the work queued on the run's CUDA device (nothing on
        the CPU): a telemetry wall span around device work calls it
        before it ends, so the span covers the work, not its launch."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def close(self) -> None:
        """Release the data loader's background prefetch workers and
        close the telemetry recorder (its final metrics snapshot); safe
        to call again."""
        self.data.close()
        self.obs.close()

    def __enter__(self) -> "EngineRunner":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def flops_per_iter(self, width: int) -> float:
        """Per-iteration FLOPs the virtual clock charges a client:
        the materialised forward+backward (``clock_model="dense"``), or
        the per-layer impl mix ``forward_impl`` selects for factorized
        schemes (``"rank_aware"``)."""
        if self.cfg.clock_model == "rank_aware" and self.factorized:
            from repro_torch.core.calibration import for_dispatch

            per_sample = self.model.apply_flops_per_sample(
                width, self.cfg.batch_size, self.cfg.forward_impl,
                calibration=for_dispatch(self.cfg, self.device),
                device=self.device)
            return per_sample * self.cfg.batch_size
        return self.model.flops_per_sample(width) * self.cfg.batch_size

    def acc_from_logits(self, logits) -> float:
        pred = torch.argmax(logits, -1)
        return float((pred == self.test_batch["labels"]).float().mean())

    def eval_batches(self):
        """The test split in ``cfg.eval_batch_size`` slices (one full
        batch when <= 0)."""
        tb = self.test_batch
        n = int(tb["labels"].shape[0])
        bs = self.cfg.eval_batch_size
        if bs <= 0 or bs >= n:
            yield tb
            return
        for i in range(0, n, bs):
            yield {k: v[i:i + bs] for k, v in tb.items()}

    def acc_streaming(self, logits_fn) -> float:
        """Accuracy of ``logits_fn(batch)`` over the test set, slice by
        slice when ``eval_batch_size > 0``."""
        with torch.no_grad():
            bs = self.cfg.eval_batch_size
            n = int(self.test_batch["labels"].shape[0])
            if bs <= 0 or bs >= n:
                return self.acc_from_logits(logits_fn(self.test_batch))
            correct, total = 0.0, 0
            for batch in self.eval_batches():
                pred = torch.argmax(logits_fn(batch), -1)
                correct += float((pred == batch["labels"]).float().sum())
                total += int(np.prod(batch["labels"].shape))
            return correct / total

    def eval_accuracy(self) -> float:
        """Test accuracy of the current global params at the evaluation
        width (the aggregator's rule)."""
        return self.aggregator.evaluate(self.state)

    # --- checkpoint / resume ----------------------------------------------
    def save_checkpoint(self) -> Path:
        """Write the current ServerState under ``cfg.checkpoint_dir``."""
        if not self.cfg.checkpoint_dir:
            raise ValueError("FLConfig.checkpoint_dir is not set")
        with self.obs.wall_span("checkpoint.save", round=self.state.round):
            payload = state_lib.state_to_payload(self.state)
            path = msgpack_ckpt.save_checkpoint(
                self.cfg.checkpoint_dir, self.state.round, payload,
                keep=self.cfg.checkpoint_keep)
        if self.obs.enabled:
            self.obs.counter_add("checkpoint.saves")
            # the step directory's files: state.msgpack and manifest.json
            self.obs.counter_add("checkpoint.bytes", float(sum(
                f.stat().st_size for f in Path(path).iterdir())))
        return path

    def restore_latest(self) -> bool:
        """Adopt the newest checkpoint under ``cfg.checkpoint_dir``.

        Returns False when there is none (fresh start).  The freshly
        initialised params serve as the key-type template for the
        restored tree, and everything goes back onto the run's device;
        afterwards the continued history — rng stream, scheduler tallies
        and in-flight dispatches included — is bit-identical to a
        never-interrupted run.
        """
        if not self.cfg.checkpoint_dir:
            raise ValueError("FLConfig.checkpoint_dir is not set")
        got = msgpack_ckpt.restore_latest(self.cfg.checkpoint_dir)
        if got is None:
            return False
        _, payload = got
        self.state = state_lib.payload_to_state(payload, self.state.params,
                                                self.device)
        self._bind_population()
        return True

    def _maybe_checkpoint(self) -> None:
        cfg = self.cfg
        if (cfg.checkpoint_every > 0 and cfg.checkpoint_dir
                and self.state.round % cfg.checkpoint_every == 0):
            self.save_checkpoint()

    # --- driving ----------------------------------------------------------
    def run_round(self) -> RoundLog:
        self.state, log = self.loop.run_round(self.state)
        self._maybe_checkpoint()
        return log

    def run(self, rounds: int) -> List[RoundLog]:
        for _ in range(rounds):
            self.run_round()
        return self.history

    def run_until_budget(self, time_budget: Optional[float] = None,
                         traffic_budget: Optional[float] = None,
                         max_rounds: int = 10_000) -> List[RoundLog]:
        """Paper Alg. 1 outer loop: train while T <= T^max (and/or a
        traffic budget)."""
        if not (time_budget or traffic_budget):
            raise ValueError("run_until_budget needs a time or traffic "
                             "budget")
        for _ in range(max_rounds):
            if time_budget is not None and self.wall >= time_budget:
                break
            if traffic_budget is not None and self.traffic >= traffic_budget:
                break
            self.run_round()
        return self.history
