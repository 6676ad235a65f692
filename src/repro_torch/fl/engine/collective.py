"""Collective aggregation backend: the merge over a cohort's shards.

With two or more shards (:func:`repro_torch.sharding.fl.cohort_mesh`,
``FLConfig.agg_devices``) the aggregators merge through a
:class:`CollectiveMerger`, the JAX package's ``shard_map`` merge in plain
tensor code:

  1. *prep*: every client result becomes a dense zero-padded contribution
     and mask, built on the run's device with one ``index_add`` a layer
     (:func:`~repro_torch.core.aggregation.scatter_contributions_host`).
     Staleness weights (semi-async) are blended client-side first, as the
     host rules blend them: ``w * update + (1 - w) * global``.  The rows
     are stacked in results order, zero-padded to a multiple of the shard
     count, and each shard takes its contiguous slice.  The sharded
     cohort trainer hands over rows of its per-shard stacks
     (:class:`CohortStack` / :class:`CohortSlice`); where a plain mean
     (no weights) merges exactly a stack's real rows, in order, the stack
     passes through untouched, each shard's rows where they lie.  Every
     other merge takes the rows as plain tensors (:meth:`CohortSlice.
     materialize`): the prep builds its stacks on the run's device
     either way, so a gather from the trainer's stacks would move the
     same rows.
  2. *merge*: each shard folds its rows left to right
     (:func:`~repro_torch.core.aggregation.ordered_sum`) and the partials
     are folded in shard order on the first shard's device
     (:func:`~repro_torch.core.aggregation.fold_shards`, the ``psum``).
     The merged state lives on the first shard's device, the run's; a
     shard that consumes it copies it to its own device where it uses it
     (no copy when that is the same device).  With ``shard_blocks`` each
     factorized coefficient whose block count divides the shard count is
     kept split over its block axis
     (:class:`~repro_torch.sharding.fl.SplitBlocks`).

On one device the engine keeps the host rules (the reference's collective
merge equals them bit for bit there).  Across shards the fold
re-associates the host loop's sum, so parity is to float tolerance.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, FrozenSet, List, Optional

import numpy as np
import torch

from repro_torch.core import aggregation
from repro_torch.core.aggregation import (blend, fold_shards, ordered_sum,
                                          zero_pad)
from repro_torch.core.estimator import tree_leaves, tree_map
from repro_torch.fl.engine.aggregators import weight_of
from repro_torch.sharding import fl as flsh

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# device-resident trainer -> merger hand-off
# ---------------------------------------------------------------------------


class CohortStack:
    """A cohort group's trained params, one stack per shard.

    ``shards[s]`` is a params tree whose leaves carry shard ``s``'s
    contiguous rows of the padded client axis, on that shard's device.
    ``n_real`` counts the leading rows holding real clients; every row
    after is a zeroed masked-clone row.
    """

    __slots__ = ("shards", "n_real", "mesh", "_host")

    def __init__(self, shards: List[Any], n_real: int,
                 mesh: flsh.CohortMesh):
        self.shards = list(shards)
        self.n_real = n_real
        self.mesh = mesh
        self._host = None

    @property
    def tree(self) -> Any:
        """The whole padded stack as one tree on the first shard's device
        (the shards' rows in order; one shard's stack as it is)."""
        if len(self.shards) == 1:
            return self.shards[0]
        dev0 = self.mesh.devices[0]
        return tree_map(lambda *vs: torch.cat([v.to(dev0) for v in vs]),
                        *self.shards)

    def host(self) -> Any:
        """:attr:`tree` as host numpy arrays, copied once."""
        if self._host is None:
            self._host = tree_map(lambda v: v.detach().cpu().numpy(),
                                  self.tree)
        return self._host

    @property
    def per(self) -> int:
        return tree_leaves(self.shards[0])[0].shape[0]

    @property
    def rows(self) -> int:
        return self.per * len(self.shards)

    def as_sharded(self) -> Any:
        """The stack as one tree whose leaves are per-shard lists (the
        merger's sharded layout); no data moves."""
        return tree_map(lambda *vs: list(vs), *self.shards)


class CohortSlice:
    """One client's params, a row of a :class:`CohortStack`.

    What ``ClientResult.params`` holds when the sharded cohort trainer
    hands results to the collective merger: the merger consumes the
    stacks on their shards, and anything that needs the plain tree calls
    :meth:`materialize` (or ``ClientResult.host_params()``).
    """

    __slots__ = ("stack", "index")

    def __init__(self, stack: CohortStack, index: int):
        self.stack = stack
        self.index = index

    def materialize(self) -> Any:
        """The row as its own tensors on the first shard's device: a copy,
        so it does not keep the stack alive."""
        s, j = divmod(self.index, self.stack.per)
        dev0 = self.stack.mesh.devices[0]
        return tree_map(lambda v: v[j].to(dev0, copy=True),
                        self.stack.shards[s])


def plain_params(params: Any) -> Any:
    """``params`` as a plain tree of tensors (a :class:`CohortSlice`
    materialized)."""
    return params.materialize() if isinstance(params, CohortSlice) \
        else params


def _plain_results(results: Dict[int, Any]) -> Dict[int, Any]:
    out = {}
    for n, r in results.items():
        if isinstance(r.params, CohortSlice):
            r = dataclasses.replace(r, params=plain_params(r.params))
        out[n] = r
    return out


def _pad_rows(t: Tensor, k_pad: int) -> Tensor:
    """Zero-pad the leading client axis to ``k_pad`` rows."""
    if t.shape[0] == k_pad:
        return t
    return torch.cat([t, t.new_zeros((k_pad - t.shape[0],) + t.shape[1:])])


def _whole(coeff) -> Tensor:
    return coeff.whole() if isinstance(coeff, flsh.SplitBlocks) else coeff


def _shard_total(parts: List[Tensor]) -> Tensor:
    """Each shard's ordered fold of its rows, then the shard fold."""
    return fold_shards([ordered_sum(p) for p in parts])


class CollectiveMerger:
    """The merges of one engine over a cohort's shards (``mesh``).

    ``shard_blocks=True`` keeps merged coefficient tensors split over
    their block axis, per tensor, wherever the block count divides the
    shard count.  :class:`~repro_torch.fl.population.hierarchy.
    HierarchicalMerger` subclasses it for the one-device edge tier.
    """

    def __init__(self, mesh: Optional[flsh.CohortMesh] = None,
                 shard_blocks: bool = False):
        self.mesh = mesh
        self.shard_blocks = shard_blocks and mesh is not None

    def _shard(self, tree: Any) -> Any:
        """Every leaf's rows split over the shards: per-shard lists."""
        return tree_map(lambda v: flsh.split_rows(v, self.mesh), tree)

    def _shard_names(self, prev_params) -> FrozenSet[str]:
        if not self.shard_blocks:
            return frozenset()
        return frozenset(
            n for n, t in prev_params.items()
            if flsh.can_shard_blocks(t["coeff"].shape[0], self.mesh))

    # -- the four mesh merges ----------------------------------------------

    def _mesh_fact(self, stacked, prev, k: int,
                   shard_names: FrozenSet[str]):
        """{name: {bases, dense, mask}} per shard -> {name: {basis,
        coeff}}: the basis mean and Eq. 5's block merge."""
        out = {}
        for name, t in stacked.items():
            basis = _shard_total(t["bases"]) / k
            coeff = aggregation.masked_block_merge(
                t["dense"], t["mask"], prev[name], mesh=self.mesh)
            if name in shard_names:
                coeff = flsh.SplitBlocks.split(coeff, self.mesh)
            out[name] = {"basis": basis, "coeff": coeff}
        return out

    def _mesh_mean(self, stacked, k: int):
        """The plain mean over the client axis, leaf-wise (FedAvg/ADP)."""
        return tree_map(lambda parts: _shard_total(parts) / k, stacked)

    def _mesh_masked(self, stacked, prev):
        """{name: {padded, cnt}} per shard -> {name: merged} (HeteroFL)."""
        out = {}
        for name, t in stacked.items():
            acc = _shard_total(t["padded"])
            cnt = _shard_total(t["cnt"])
            out[name] = torch.where(cnt > 0, acc / torch.clamp(cnt, min=1),
                                    prev[name])
        return out

    def _mesh_flanc(self, stacked, prevs, k: int):
        """Basis mean over all clients and per-width coefficient means:
        each client row carries its coefficient zero-padded to the widest
        block count and a one-hot width row that selects it."""
        basis = {name: _shard_total(parts) / k
                 for name, parts in stacked["bases"].items()}
        onehot = stacked["onehot"]
        coeffs = {}
        for p, group in prevs.items():
            sel = fold_shards([oh[:, p - 1].sum() for oh in onehot])
            coeffs[p] = {}
            for name, prev in group.items():
                total = _shard_total([
                    oh[:, p - 1].reshape((-1,) + (1,) * (d.dim() - 1)) * d
                    for oh, d in zip(onehot, stacked["dense"][name])])
                mean = total[:prev.shape[0]] / torch.clamp(sel, min=1)
                coeffs[p][name] = torch.where(sel > 0, mean, prev)
        return basis, coeffs

    # -- the sharded trainer's hand-off --------------------------------------

    def _device_stacked(self, results, k_pad: int):
        """The trainer's per-shard stack, untouched, when ``results`` are
        exactly its real rows in order on this merge's shards, padded to
        the same height (so the rows beyond ``n_real`` are zeroed
        clones); else ``None``."""
        params = [r.params for r in results.values()]
        if not all(isinstance(p, CohortSlice) for p in params):
            return None
        stack = params[0].stack
        rows = [p.index for p in params]
        if (all(p.stack is stack for p in params)
                and rows == list(range(stack.n_real))
                and stack.rows == k_pad and stack.mesh == self.mesh):
            return stack.as_sharded()
        return None

    # -- prep + dispatch ----------------------------------------------------

    def merge_factorized(self, prev_params, specs, results, assigns,
                         weights=None):
        """Heroes: basis mean + Eq. 5 block-wise coefficient merge."""
        results = _plain_results(results)
        k = len(results)
        k_pad = flsh.pad_cohort(k, self.mesh)
        stacked, prev = {}, {}
        for name, spec in specs.items():
            ids_key = "hidden_ids" if spec.mode == "square" else "anchored_ids"
            prev_c = _whole(prev_params[name]["coeff"])
            prev_b = prev_params[name]["basis"]
            bases, blocks, ids = [], [], []
            for n, r in results.items():
                w = weight_of(weights, n)
                i = np.asarray(assigns[n][ids_key])
                c = r.params[name]["coeff"].to(prev_c.dtype)
                if w is not None:
                    c = blend(c, w, prev_c[aggregation.as_index(
                        i, prev_c.device)])
                bases.append(blend(r.params[name]["basis"], w, prev_b))
                blocks.append(c)
                ids.append(i)
            dense, mask = aggregation.scatter_contributions_host(
                blocks, ids, prev_c.shape[0])
            stacked[name] = {"bases": _pad_rows(torch.stack(bases), k_pad),
                             "dense": _pad_rows(dense, k_pad),
                             "mask": _pad_rows(mask, k_pad)}
            prev[name] = prev_c
        return self._mesh_fact(self._shard(stacked), prev, k,
                               self._shard_names(prev_params))

    def merge_dense_mean(self, prev_params, results, weights=None):
        """FedAvg/ADP: plain parameter mean over the cohort."""
        k = len(results)
        k_pad = flsh.pad_cohort(k, self.mesh)
        if weights is None:
            stacked = self._device_stacked(results, k_pad)
            if stacked is not None:
                return self._mesh_mean(stacked, k)
        results = _plain_results(results)
        trees = [tree_map(lambda u, g, w=weight_of(weights, n):
                          blend(u, w, g), r.params, prev_params)
                 for n, r in results.items()]
        stacked = tree_map(lambda *xs: _pad_rows(torch.stack(xs), k_pad),
                           *trees)
        return self._mesh_mean(self._shard(stacked), k)

    def merge_masked_dense(self, prev_params, results, weights=None):
        """HeteroFL: element-wise mean over the covering clients."""
        results = _plain_results(results)
        k_pad = flsh.pad_cohort(len(results), self.mesh)
        stacked = {}
        for name, full in prev_params.items():
            pads, cnts = [], []
            for n, r in results.items():
                wv = r.params[name]
                w = weight_of(weights, n)
                if w is not None:
                    wv = blend(wv, w, full[tuple(slice(0, s)
                                                 for s in wv.shape)])
                pads.append(zero_pad(wv, full.shape))
                cnts.append(zero_pad(torch.ones_like(wv), full.shape))
            stacked[name] = {"padded": _pad_rows(torch.stack(pads), k_pad),
                             "cnt": _pad_rows(torch.stack(cnts), k_pad)}
        return self._mesh_masked(self._shard(stacked), prev_params)

    def merge_flanc(self, basis, coeffs, results, widths, weights=None):
        """Flanc: shared basis mean + per-width coefficient means.

        ``widths`` maps client -> assigned width (the coefficient set it
        trained).  Returns ``(new_basis, new_coeffs)``; widths nobody
        trained keep their previous coefficients.
        """
        results = _plain_results(results)
        k = len(results)
        k_pad = flsh.pad_cohort(k, self.mesh)
        names = list(basis)
        max_width = max(coeffs)
        dev = next(iter(basis.values())).device
        onehot = torch.zeros((k_pad, max_width), dtype=torch.float32,
                             device=dev)
        bases = {name: [] for name in names}
        dense = {name: [] for name in names}
        for j, (n, r) in enumerate(results.items()):
            w = weight_of(weights, n)
            p = widths[n]
            onehot[j, p - 1] = 1.0
            for name in names:
                bases[name].append(blend(r.params[name]["basis"], w,
                                         basis[name]))
                c = blend(r.params[name]["coeff"], w, coeffs[p][name])
                dense[name].append(zero_pad(
                    c, coeffs[max_width][name].shape))
        stacked = {
            "bases": {n: _pad_rows(torch.stack(b), k_pad)
                      for n, b in bases.items()},
            "onehot": onehot,
            "dense": {n: _pad_rows(torch.stack(rows), k_pad)
                      for n, rows in dense.items()},
        }
        new_basis, merged = self._mesh_flanc(self._shard(stacked), coeffs, k)
        return new_basis, merged


def build_merger(cfg, device=None) -> Optional[CollectiveMerger]:
    """The merger of a ``agg_backend="collective"`` engine: a mesh merge
    when the cohort has two or more shards (``cfg.agg_devices``), the
    hierarchical edge-group merger when ``cfg.edge_groups > 1``, else
    ``None`` (the aggregators' host rules)."""
    mesh = flsh.cohort_mesh(cfg.agg_devices, device)
    shard = cfg.shard_server_state
    if cfg.edge_groups > 1:
        # population layers on the engine; import here to avoid a cycle
        from repro_torch.fl.population.hierarchy import HierarchicalMerger
        return HierarchicalMerger(cfg.edge_groups, mesh=mesh,
                                  shard_blocks=shard)
    if mesh is None:
        return None
    return CollectiveMerger(mesh, shard_blocks=shard)
