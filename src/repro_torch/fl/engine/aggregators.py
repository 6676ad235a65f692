"""Aggregators: global-state owners + merge rules per scheme.

The global model is ``state.params`` (tensors on the run's device);
``init_global``/``aggregate`` return updated
:class:`~repro_torch.fl.types.ServerState` values.  The merges are the JAX
package's host rules (``agg_backend="host"``): per-client loops over the
cohort in dispatch order.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import aggregation, convergence
from repro_torch.core.estimator import tree_map
from repro_torch.fl.engine.base import Aggregator, Assignment
from repro_torch.fl.types import ServerState


def _mean_bound(state: ServerState, results, lr: float,
                clip: bool) -> Any:
    """BoundState from the cohort's (L, G^2, sigma^2) estimates; the
    incoming bound when nobody shipped estimates."""
    ests = [r.estimates for r in results.values() if r.estimates]
    if not ests:
        return state.bound_state
    mean = {k: float(np.mean([e[k] for e in ests])) for k in ests[0]}
    loss0 = float(np.mean([r.loss_after for r in results.values()]))
    if clip:
        return convergence.BoundState(
            loss0=max(loss0, 1e-3),
            smoothness=float(np.clip(mean.get("L", 1.0), 1e-3, 1e3)),
            grad_sq=mean.get("grad_sq", 1.0),
            noise_sq=mean.get("sigma_sq", 0.5), lr=lr)
    return convergence.BoundState(
        loss0=loss0, smoothness=max(mean.get("L", 1.0), 1e-3),
        grad_sq=mean.get("grad_sq", 1.0),
        noise_sq=mean.get("sigma_sq", 0.5), lr=lr)


class DenseMeanAggregator(Aggregator):
    """FedAvg: plain parameter mean over the cohort."""

    def init_global(self, state: ServerState) -> ServerState:
        eng = self.eng
        return dataclasses.replace(
            state, params=eng.model.init_dense(eng.cfg.seed, eng.device))

    def client_params(self, state: ServerState, n: int,
                      assignment: Assignment) -> Any:
        return state.params

    def aggregate(self, state, results, assigns) -> ServerState:
        params = tree_map(lambda *xs: torch.stack(xs).mean(0),
                          *[r.params for r in results.values()])
        return dataclasses.replace(
            state, params=params,
            bound_state=_mean_bound(state, results, self.eng.cfg.lr,
                                    clip=False))

    def evaluate(self, state: ServerState) -> float:
        eng = self.eng
        ew = eng.eval_width
        params = state.params if ew == eng.P else eng.model.slice_dense(
            state.params, ew)
        return eng.acc_streaming(
            lambda batch: eng.model.forward(params, ew, batch))


class HeroesAggregator(Aggregator):
    """Enhanced NC: basis average + block-wise coefficient merge (Eq. 5)."""

    def init_global(self, state: ServerState) -> ServerState:
        eng = self.eng
        return dataclasses.replace(
            state, params=eng.model.init_factorized(eng.cfg.seed, eng.device))

    def client_params(self, state: ServerState, n: int,
                      assignment: Assignment) -> Any:
        return self.eng.model.reduce(
            state.params, assignment["width"],
            assignment["hidden_ids"], assignment["anchored_ids"])

    def aggregate(self, state, results, assigns) -> ServerState:
        eng = self.eng
        params = {}
        for name, spec in eng.model.specs.items():
            ids_key = "hidden_ids" if spec.mode == "square" else "anchored_ids"
            params[name] = {
                "basis": aggregation.aggregate_basis(
                    [r.params[name]["basis"] for r in results.values()]),
                "coeff": aggregation.aggregate_coefficient(
                    state.params[name]["coeff"],
                    [r.params[name]["coeff"] for r in results.values()],
                    [np.asarray(assigns[n][ids_key]) for n in results]),
            }
        return dataclasses.replace(
            state, params=params,
            bound_state=_mean_bound(state, results, eng.cfg.lr, clip=True))

    def evaluate(self, state: ServerState) -> float:
        # the width-``eval_width`` sub-model built from the first blocks
        # (all of them when eval_width == P), always materialised: the
        # weights are composed once per eval, and reported accuracy is
        # independent of cfg.forward_impl
        eng = self.eng
        ew = eng.eval_width
        square_spec = next(
            s for s in eng.model.specs.values() if s.mode == "square")
        hidden_ids = np.arange(square_spec.blocks_for_width(ew))
        anch_ids = np.arange(min(ew, eng.P))
        reduced = eng.model.reduce(state.params, ew, hidden_ids, anch_ids)
        with torch.no_grad():
            w = eng.model.compose_all(reduced, ew)
        return eng.acc_streaming(
            lambda batch: eng.model.forward(w, ew, batch))
