"""The engine runner: component wiring around an explicit ServerState.

The runner owns the *static* collaborators — model, data partitions,
heterogeneity model, the scheme components, the device — and exactly ONE
mutable slot: ``self.state``, the current
:class:`~repro_torch.fl.types.ServerState`.  Each ``run_round`` installs
the state returned by the loop.  ``state.params`` is public: a caller may
replace it (for example with another engine's initial weights, through
:func:`repro_torch.convert.from_jax_params`) before the first round.

The runner runs on the CUDA device unless the caller passes
``device="cpu"``; with no CUDA device and no explicit request it raises.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import convergence
from repro_torch.data.streaming import ClientDataLoader
from repro_torch.fl.engine.base import (Aggregator, AssignmentPolicy,
                                        LocalTrainer, PayloadModel, RoundLoop)
from repro_torch.fl.heterogeneity import HeterogeneityModel
from repro_torch.fl.models import FLModelDef
from repro_torch.fl.population.schedulers import build_scheduler
from repro_torch.fl.types import FLConfig, RoundLog, ServerState


def check_ported(cfg: FLConfig) -> None:
    """Raise ``NotImplementedError`` for knob values this port does not
    run yet, naming the ROADMAP step (queue A) that brings each in."""
    later = []
    if cfg.agg_backend == "collective":
        later.append("agg_backend='collective' (step 9); pass "
                     "agg_backend='host'")
    elif cfg.agg_backend != "host":
        raise ValueError(f"unknown agg_backend {cfg.agg_backend!r}")
    if cfg.edge_groups > 1 or cfg.shard_server_state:
        later.append("edge_groups / shard_server_state (step 9)")
    if cfg.sample_weighted:
        later.append("sample_weighted (step 7)")
    if cfg.checkpoint_every > 0 or cfg.checkpoint_dir:
        later.append("checkpointing (step 8)")
    if cfg.telemetry != "off":
        later.append(f"telemetry={cfg.telemetry!r} (step 9)")
    if later:
        raise NotImplementedError("not ported yet: " + "; ".join(later))
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
                 factorized: bool, estimate: bool, device=None):
        check_ported(cfg)
        self.device = resolve_device(device)
        self.scheme = scheme
        self.model = model
        self.parts_x, self.parts_y = parts_x, parts_y
        self.data = ClientDataLoader(parts_x, parts_y, self.device,
                                     model.input_key)
        self.test_batch = {k: v.to(self.device) for k, v in test_batch.items()}
        self.het = het
        self.cfg = cfg
        self.eval_width = eval_width
        self.P = next(iter(model.specs.values())).max_width
        self.factorized = factorized
        self.estimate = estimate

        self.assignment = assignment
        self.payload = payload
        self.aggregator = aggregator
        self.trainer = trainer
        self.loop = loop
        self.sampler = build_scheduler(cfg)
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

    # --- state views ------------------------------------------------------
    @property
    def params(self):
        return self.state.params

    @property
    def bound_state(self):
        return self.state.bound_state

    @property
    def history(self) -> List[RoundLog]:
        return list(self.state.history)

    # --- shared helpers ---------------------------------------------------
    def sample_clients(self, state: ServerState, k: int) -> List[int]:
        """One round's cohort via the participation scheduler; records
        participation in ``state.participation``."""
        clients = self.sampler.sample(state, k)
        for n in clients:
            state.participation[int(n)] = state.round
        return clients

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

    # --- driving ----------------------------------------------------------
    def run_round(self) -> RoundLog:
        self.state, log = self.loop.run_round(self.state)
        return log

    def run(self, rounds: int) -> List[RoundLog]:
        for _ in range(rounds):
            self.run_round()
        return self.history
