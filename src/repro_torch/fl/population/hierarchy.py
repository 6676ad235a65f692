"""Two-level edge/server aggregation on one device (``FLConfig.edge_groups``).

The round's cohort is split into contiguous *edge groups* in merge order
(:func:`assign_edge_groups`).  Each edge aggregator folds its members'
dense zero-padded contributions and masks into ONE partial (sum, count)
pair — the only payload it ships upstream — and the server combines the
G partials and divides once (Eq. 5).

On one device the JAX package's server combine continues the client-order
fold *through* the groups (the carry leaving group ``g`` seeds group
``g+1``), so its merged state is the flat merge's bit for bit.  The
port's host rules already fold in client order, so the merged state here
IS the flat host merge (bit-equal to ``edge_groups=0`` by construction),
and :class:`HierarchicalMerger` adds what the hierarchy exists to
produce: each group's zero-seeded fold, the edge upload, kept as
``last_partials`` after every merge.  The partials recombine to the flat
totals to float tolerance only (the re-association the carry chain
avoids for the merged state).  Flanc's per-width rule keeps the flat
merge and produces no partials, as in the reference.

Over a cohort's shards (``agg_devices``) the hierarchy IS the shards:
each shard is an edge aggregator for its contiguous client slice (its
ordered fold) and the fold of the shard partials is the server combine.
The merger then defers to the flat mesh merge of
:class:`~repro_torch.fl.engine.collective.CollectiveMerger`, as the JAX
package's does.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from repro_torch.core.aggregation import as_index, blend, zero_pad
from repro_torch.fl.engine.aggregators import weight_of
from repro_torch.fl.engine.collective import CollectiveMerger

Tensor = torch.Tensor


def assign_edge_groups(clients: List[int], num_groups: int) -> List[List[int]]:
    """Contiguous balanced split of the cohort (merge order) into
    ``num_groups`` edge groups; trailing groups may run one short."""
    k = len(clients)
    g = max(min(int(num_groups), k), 1)
    size = -(-k // g)
    return [list(clients[i:i + size]) for i in range(0, k, size)]


def grouped_ordered_fold(stacked: Tensor, group_size: int):
    """Carry-chained per-group fold over the leading (client) axis.

    Returns ``(total, partials)``: ``total`` adds the rows in left-to-right
    order (each group's fold starts from the previous group's carry, so it
    equals the flat fold bit for bit) and ``partials[g]`` is group ``g``'s
    own zero-seeded fold (the edge upload).  The row count must divide
    into groups of ``group_size`` (zero-pad first; zero rows are IEEE
    no-ops for the total).
    """
    rows = stacked.shape[0]
    if rows % group_size:
        raise ValueError(f"{rows} rows not divisible into groups of "
                         f"{group_size}")
    total = torch.zeros_like(stacked[0])
    partials = []
    for g in range(rows // group_size):
        part = torch.zeros_like(total)
        for x in stacked[g * group_size:(g + 1) * group_size]:
            total = total + x
            part = part + x
        partials.append(part)
    return total, torch.stack(partials)


class HierarchicalMerger(CollectiveMerger):
    """On one device (``mesh=None``): per-group partials of the cohort's
    contributions (the edge tier's uploads, ``fold_*``) beside the flat
    host merge, which stays the merged state.  Over shards: the flat mesh
    merge (``merge_*``), the shards being the edge tier."""

    def __init__(self, edge_groups: int = 2, mesh=None,
                 shard_blocks: bool = False):
        super().__init__(mesh, shard_blocks=shard_blocks)
        self.edge_groups = max(int(edge_groups), 1)
        self.last_partials = None

    def _grouping(self, rows: int):
        """(group_size, padded_rows) for this cohort height."""
        groups = max(min(self.edge_groups, rows), 1)
        size = -(-rows // groups)
        padded = -(-rows // size) * size
        return size, padded

    def _partials(self, rows: Sequence[Tensor]) -> Tensor:
        size, padded = self._grouping(len(rows))
        stacked = torch.stack(list(rows))
        if padded > len(rows):
            stacked = torch.cat([stacked, stacked.new_zeros(
                (padded - len(rows),) + stacked.shape[1:])])
        return grouped_ordered_fold(stacked, size)[1]

    def fold_factorized(self, prev_params, specs, results, assigns,
                        weights=None) -> None:
        """Heroes: per group, the bases' sum, the zero-padded coefficient
        blocks' sum and the block counts."""
        out = {}
        for name, spec in specs.items():
            ids_key = "hidden_ids" if spec.mode == "square" else "anchored_ids"
            prev_b = prev_params[name]["basis"]
            prev_c = prev_params[name]["coeff"]
            bases, dense, mask = [], [], []
            for n, r in results.items():
                w = weight_of(weights, n)
                idx = as_index(assigns[n][ids_key], prev_c.device)
                blocks = blend(r.params[name]["coeff"].to(prev_c.dtype), w,
                               prev_c[idx])
                bases.append(blend(r.params[name]["basis"], w, prev_b))
                dense.append(torch.zeros_like(prev_c).index_copy(
                    0, idx, blocks))
                mask.append(torch.zeros(prev_c.shape[0], dtype=torch.float32,
                                        device=prev_c.device).index_fill(
                                            0, idx, 1.0))
            out[name] = {"bases": self._partials(bases),
                         "dense": self._partials(dense),
                         "mask": self._partials(mask)}
        self.last_partials = out

    def fold_dense_mean(self, prev_params, results, weights=None) -> None:
        """FedAvg/ADP: per group, the sum of every parameter."""
        self.last_partials = {
            name: self._partials([blend(r.params[name], weight_of(weights, n),
                                        full)
                                  for n, r in results.items()])
            for name, full in prev_params.items()}

    def fold_masked_dense(self, prev_params, results, weights=None) -> None:
        """HeteroFL: per group, the zero-padded sub-model sum and the
        covering count of every element."""
        out = {}
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
            out[name] = {"padded": self._partials(pads),
                         "cnt": self._partials(cnts)}
        self.last_partials = out

