"""Aggregators: global-state owners + merge rules per scheme.

The global model is ``state.params`` (tensors on the run's device);
``init_global``/``aggregate`` return updated
:class:`~repro_torch.fl.types.ServerState` values.  With per-client
``weights`` (semi-async staleness discounts, sample-count weights) every
client contribution is first blended toward the *current* global state::

    contrib_n = w_n * update_n + (1 - w_n) * global

so a fully fresh client (w=1) merges exactly as in the synchronous rule
and an infinitely stale one (w=0) is a no-op.

Two merge paths share each rule.  On one device both ``agg_backend``
values run the JAX package's host rules, per-client loops over the
cohort in dispatch order (the reference's ``"collective"`` backend gives
the same state bit for bit there); with ``edge_groups > 1`` on the
collective backend the runner's
:class:`~repro_torch.fl.population.hierarchy.HierarchicalMerger` also
folds each edge group's partials beside the merge.  On the collective
backend over two or more shards (``agg_devices``) each rule routes
through the runner's merger (``eng.merger.merge_*``,
:mod:`repro_torch.fl.engine.collective`): stacked contributions, each
shard's ordered fold, then the fold of the shard partials.

On the collective backend each merge adds one to the telemetry counter
``aggregate.collective_calls[rule=...]`` under the rule the reference's
merger names it by (``dense_mean``, ``masked_dense``, ``flanc``,
``factorized``), so a port run counts what a reference run counts.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core import aggregation, convergence
from repro_torch.core.aggregation import blend, zero_pad
from repro_torch.core.estimator import tree_map
from repro_torch.fl.engine.base import Aggregator, Assignment
from repro_torch.fl.types import ServerState


def weight_of(weights: Optional[Dict[int, float]], n: int) -> Optional[float]:
    """Client ``n``'s blend weight: None for an unweighted merge, 1.0 for
    a client the weights leave out."""
    if weights is None:
        return None
    return float(weights.get(n, 1.0))


def count_merge(eng, rule: str) -> None:
    """One merge of ``rule`` (each aggregator's ``rule``) on the
    collective backend, for telemetry."""
    if eng.obs.enabled and eng.cfg.agg_backend == "collective":
        eng.obs.counter_add("aggregate.collective_calls", rule=rule)


def mesh_merger(eng):
    """The runner's merger when it merges over shards, else ``None``."""
    merger = eng.merger
    return merger if merger is not None and merger.mesh is not None \
        else None


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
    """FedAvg/ADP: plain parameter mean over the cohort."""

    rule = "dense_mean"

    def init_global(self, state: ServerState) -> ServerState:
        eng = self.eng
        return dataclasses.replace(
            state, params=eng.model.init_dense(eng.cfg.seed, eng.device))

    def client_params(self, state: ServerState, n: int,
                      assignment: Assignment) -> Any:
        return state.params

    def aggregate(self, state, results, assigns, weights=None) -> ServerState:
        count_merge(self.eng, self.rule)
        merger = mesh_merger(self.eng)
        if merger is not None:
            params = self._merge_mesh(merger, state, results, weights)
        else:
            if self.eng.merger is not None:
                self._edge_fold(state, results, weights)
            params = self._merge(state, results, weights)
        return dataclasses.replace(
            state, params=params,
            bound_state=_mean_bound(state, results, self.eng.cfg.lr,
                                    clip=False))

    def _merge_mesh(self, merger, state, results, weights):
        return merger.merge_dense_mean(state.params, results, weights)

    def _edge_fold(self, state, results, weights) -> None:
        self.eng.merger.fold_dense_mean(state.params, results, weights)

    def _merge(self, state, results, weights):
        trees = [tree_map(lambda u, g, w=weight_of(weights, n):
                          blend(u, w, g), r.params, state.params)
                 for n, r in results.items()]
        return tree_map(lambda *xs: torch.stack(xs).mean(0), *trees)

    def evaluate(self, state: ServerState) -> float:
        eng = self.eng
        ew = eng.eval_width
        params = state.params if ew == eng.P else eng.model.slice_dense(
            state.params, ew)
        return eng.acc_streaming(
            lambda batch: eng.model.forward(params, ew, batch))


class MaskedDenseAggregator(DenseMeanAggregator):
    """HeteroFL: element-wise mean over the clients covering each region."""

    rule = "masked_dense"

    def client_params(self, state: ServerState, n: int,
                      assignment: Assignment) -> Any:
        return self.eng.model.slice_dense(state.params, assignment["width"])

    def _merge_mesh(self, merger, state, results, weights):
        return merger.merge_masked_dense(state.params, results, weights)

    def _edge_fold(self, state, results, weights) -> None:
        self.eng.merger.fold_masked_dense(state.params, results, weights)

    def _merge(self, state, results, weights):
        new = {}
        for name, full in state.params.items():
            acc = torch.zeros_like(full)
            cnt = torch.zeros_like(full)
            for n, r in results.items():
                w = r.params[name]
                if weights is not None:
                    region = full[tuple(slice(0, s) for s in w.shape)]
                    w = blend(w, weight_of(weights, n), region)
                acc = acc + zero_pad(w, full.shape)
                cnt = cnt + zero_pad(torch.ones_like(w), full.shape)
            new[name] = torch.where(cnt > 0, acc / torch.clamp(cnt, min=1),
                                    full)
        return new


class FlancAggregator(Aggregator):
    """Original NC: shared basis average + per-width coefficient average.

    ``state.params`` is ``{"basis": {layer: basis}, "coeffs": {width p:
    {layer: coeff}}}`` — width p owns its own copy of the first
    ``blocks_for_width(p)`` blocks (original Flanc: no sharing).
    """

    rule = "flanc"

    def init_global(self, state: ServerState) -> ServerState:
        eng = self.eng
        full = eng.model.init_factorized(eng.cfg.seed, eng.device)
        basis = {name: full[name]["basis"] for name in full}
        coeffs = {
            p: {name: full[name]["coeff"][
                :eng.model.specs[name].blocks_for_width(p)].clone()
                for name in full}
            for p in range(1, eng.P + 1)
        }
        return dataclasses.replace(state,
                                   params={"basis": basis, "coeffs": coeffs})

    def client_params(self, state: ServerState, n: int,
                      assignment: Assignment) -> Any:
        return self._width_params(state.params, assignment["width"])

    def _width_params(self, params, p: int):
        return {name: {"basis": params["basis"][name],
                       "coeff": params["coeffs"][p][name]}
                for name in params["basis"]}

    def aggregate(self, state, results, assigns, weights=None) -> ServerState:
        count_merge(self.eng, self.rule)
        basis, coeffs = state.params["basis"], state.params["coeffs"]
        merger = mesh_merger(self.eng)
        if merger is not None:
            widths = {n: assigns[n]["width"] for n in results}
            basis, coeffs = merger.merge_flanc(basis, coeffs, results,
                                               widths, weights)
            return dataclasses.replace(
                state, params={"basis": basis, "coeffs": coeffs})

        def contrib(n, name, key, prev):
            return blend(results[n].params[name][key],
                         weight_of(weights, n), prev)

        new_basis = {
            name: torch.stack([contrib(n, name, "basis", basis[name])
                               for n in results]).mean(0)
            for name in basis
        }
        by_width: Dict[int, list] = {}
        for n in results:
            by_width.setdefault(assigns[n]["width"], []).append(n)
        new_coeffs = dict(coeffs)
        for p, ns in by_width.items():
            new_coeffs[p] = {
                name: torch.stack([contrib(n, name, "coeff", coeffs[p][name])
                                   for n in ns]).mean(0)
                for name in basis
            }
        return dataclasses.replace(
            state, params={"basis": new_basis, "coeffs": new_coeffs})

    def evaluate(self, state: ServerState) -> float:
        eng = self.eng
        ew = eng.eval_width
        params = self._width_params(state.params, ew)
        with torch.no_grad():
            w = eng.model.compose_all(params, ew)
        return eng.acc_streaming(
            lambda batch: eng.model.forward(w, ew, batch))


class HeroesAggregator(Aggregator):
    """Enhanced NC: basis average + block-wise coefficient merge (Eq. 5)."""

    rule = "factorized"

    def init_global(self, state: ServerState) -> ServerState:
        eng = self.eng
        return dataclasses.replace(
            state, params=eng.model.init_factorized(eng.cfg.seed, eng.device))

    def client_params(self, state: ServerState, n: int,
                      assignment: Assignment) -> Any:
        return self.eng.model.reduce(
            state.params, assignment["width"],
            assignment["hidden_ids"], assignment["anchored_ids"])

    def aggregate(self, state, results, assigns, weights=None) -> ServerState:
        count_merge(self.eng, self.rule)
        merger = mesh_merger(self.eng)
        if merger is not None:
            new = merger.merge_factorized(state.params, self.eng.model.specs,
                                          results, assigns, weights)
        else:
            new = self._merge_host(state, results, assigns, weights)
        return dataclasses.replace(
            state, params=new,
            bound_state=_mean_bound(state, results, self.eng.cfg.lr,
                                    clip=True))

    def _merge_host(self, state, results, assigns, weights):
        if self.eng.merger is not None:
            self.eng.merger.fold_factorized(state.params, self.eng.model.specs,
                                            results, assigns, weights)
        ws = None if weights is None else [weight_of(weights, n)
                                           for n in results]
        new = {}
        for name, spec in self.eng.model.specs.items():
            ids_key = "hidden_ids" if spec.mode == "square" else "anchored_ids"
            new[name] = {
                "basis": aggregation.aggregate_basis(
                    [r.params[name]["basis"] for r in results.values()],
                    weights=ws, prev=state.params[name]["basis"]),
                "coeff": aggregation.aggregate_coefficient(
                    state.params[name]["coeff"],
                    [r.params[name]["coeff"] for r in results.values()],
                    [np.asarray(assigns[n][ids_key]) for n in results],
                    weights=ws),
            }
        return new

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
