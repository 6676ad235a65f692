"""Global aggregation (Heroes, Sec. III phase 3): the merge rules.

* Neural basis: plain average over the K participating clients.
* Coefficient: *block-wise* aggregation (Eq. 5) — block ``i`` is averaged
  over exactly the clients that trained it this round; blocks nobody
  trained keep their previous value.

Two forms:

``aggregate_*``           — the per-client loops of the reference's
                            ``agg_backend="host"`` path; on one device the
                            engine runs them for both backends (the
                            reference's ``"collective"`` backend gives the
                            same state bit for bit there).
``masked_block_merge``    — the stacked form: contributions laid out on a
                            leading client axis, folded left to right by
                            :func:`ordered_sum` (bit for bit the host loop
                            without shards); over a cohort's shards each
                            shard folds its rows and :func:`fold_shards`
                            folds the partials in shard order (the
                            reference's ``psum``, equal to the host loop
                            to float tolerance).  ``masked_block_mean`` is
                            the one-row-per-shard case.

Zero rows are exact no-ops under IEEE addition, which makes the dense
zero-padded contribution form (:func:`scatter_contributions_host`) equal
to the sparse scatter form.  Staleness and sample weights go through one
function, :func:`blend`.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

Tensor = torch.Tensor


def blend(update: Tensor, w: Optional[float], prev: Tensor) -> Tensor:
    """A weighted client contribution ``w * update + (1 - w) * prev``.

    ``prev`` is the current global value the update is pulled toward
    (semi-async staleness discount, sample-count weights); ``w=None``
    returns ``update`` unchanged.  ``1 - w`` is rounded from the Python
    double, then both scalars are applied in the tensor's type, as the
    JAX package's weak-typed scalars are.
    """
    if w is None:
        return update
    return w * update + (1.0 - w) * prev


def zero_pad(x: Tensor, shape) -> Tensor:
    """``x`` zero-padded at the end of every axis up to ``shape`` (a
    HeteroFL sub-model's region inside the full weight)."""
    pad = []
    for i in reversed(range(x.ndim)):
        pad += [0, shape[i] - x.shape[i]]
    return torch.nn.functional.pad(x, pad)


def aggregate_basis(client_bases: Sequence[Tensor],
                    weights: Optional[Sequence[float]] = None,
                    prev: Optional[Tensor] = None) -> Tensor:
    """v^{h+1} = (1/K) sum_n v̄_n^h.

    With ``weights``, each client's basis is first blended toward
    ``prev`` (the current global basis): ``w * v̄_n + (1 - w) * prev``.
    """
    if weights is None:
        return torch.stack(list(client_bases)).mean(0)
    if prev is None:
        raise ValueError("weighted aggregation needs the previous basis")
    return torch.stack([blend(b, w, prev)
                        for b, w in zip(client_bases, weights)]).mean(0)


def as_index(ids, device) -> Tensor:
    """Block ids (any integer sequence) as an int64 index on ``device``."""
    return torch.as_tensor(np.asarray(ids, np.int64), device=device)


def aggregate_coefficient(global_coeff: Tensor,
                          client_blocks: Sequence[Tensor],
                          client_block_ids: Sequence[np.ndarray],
                          weights: Optional[Sequence[float]] = None
                          ) -> Tensor:
    """Block-wise aggregation, Eq. (5).

    Args:
      global_coeff: previous complete coefficient ``(P^2, R, O)``.
      client_blocks: per client, its updated reduced coefficient
        ``(m_n, R, O)``; client_block_ids: the block indices of its rows.
      weights: optional per-client weights; a client's blocks are blended
        toward the current global blocks as ``w * blocks + (1 - w) *
        global[ids]`` before the block mean.

    Returns the new complete coefficient (the per-block counters are
    float32, cast to the coefficient type for the division); untrained
    blocks are unchanged.
    """
    num_blocks = global_coeff.shape[0]
    dev = global_coeff.device
    acc = torch.zeros_like(global_coeff)
    cnt = torch.zeros((num_blocks,), dtype=torch.float32, device=dev)
    if weights is None:
        weights = [None] * len(client_blocks)
    for blocks, ids, w in zip(client_blocks, client_block_ids, weights):
        idx = as_index(ids, dev)
        blocks = blocks.to(acc.dtype)
        if w is not None:
            blocks = blend(blocks, w, global_coeff[idx])
        acc = acc.index_add(0, idx, blocks)
        cnt = cnt.index_add(0, idx, torch.ones_like(idx, dtype=cnt.dtype))
    trained = cnt > 0
    denom = torch.where(trained, cnt, torch.ones_like(cnt))
    mean = acc / denom[:, None, None].to(acc.dtype)
    return torch.where(trained[:, None, None], mean, global_coeff)


def aggregate_factorized(global_params: dict, client_params: Sequence[dict],
                         client_block_ids: Sequence[np.ndarray]) -> dict:
    """Aggregate a whole CompositionPlan param tree (``{layer: {"basis",
    "coeff"}}``): each layer's basis averaged, its coefficient merged
    block-wise with the same block ids for every layer."""
    return {name: {
        "basis": aggregate_basis([cp[name]["basis"] for cp in client_params]),
        "coeff": aggregate_coefficient(
            gp["coeff"], [cp[name]["coeff"] for cp in client_params],
            client_block_ids),
    } for name, gp in global_params.items()}


# ---------------------------------------------------------------------------
# the stacked (collective) form
# ---------------------------------------------------------------------------


def ordered_sum(stacked: Tensor) -> Tensor:
    """Sum over the leading axis with fixed left-to-right association:
    bit for bit the loop ``acc = acc + stacked[k]`` from zeros (the host
    rules' order), which ``torch.sum`` does not promise."""
    acc = torch.zeros_like(stacked[0])
    for row in stacked:
        acc = acc + row
    return acc


def fold_shards(partials: Sequence[Tensor]) -> Tensor:
    """The shards' ``psum``: their partials folded in shard order on the
    first shard's device."""
    total = partials[0]
    for p in partials[1:]:
        total = total + p.to(total.device)
    return total


def scatter_contribution(updated_blocks: Tensor, block_ids,
                         num_blocks: int) -> Tuple[Tensor, Tensor]:
    """One client's dense zero-padded contribution ``(num_blocks, R, O)``
    and its mask ``(num_blocks,)``; duplicate ids add, as the host rule's
    ``index_add`` does."""
    dense, mask = scatter_contributions_host([updated_blocks], [block_ids],
                                             num_blocks)
    return dense[0], mask[0]


def scatter_contributions_host(client_blocks, client_block_ids,
                               num_blocks: int, dtype=None
                               ) -> Tuple[Tensor, Tensor]:
    """Stacked dense contributions ``(K, num_blocks, R, O)`` and masks
    ``(K, num_blocks)`` of a cohort, built on the blocks' device with one
    ``index_add`` for each (the JAX package builds them in numpy on the
    host).  ``client_blocks`` is a sequence of per-client ``(m_n, R, O)``
    tensors (``m_n`` may differ) or one stacked ``(K, m, R, O)`` tensor
    with ``client_block_ids`` ``(K, m)``.  Duplicate ids within a client
    accumulate; ``dtype`` casts the blocks first."""
    if isinstance(client_blocks, torch.Tensor):
        client_blocks = list(client_blocks.unbind(0))
    ids = [np.asarray(i, np.int64).reshape(-1) for i in client_block_ids]
    first = client_blocks[0]
    dev, dt = first.device, dtype or first.dtype
    k = len(client_blocks)
    r, o = first.shape[-2:]
    flat = torch.as_tensor(np.concatenate(
        [j * num_blocks + i for j, i in enumerate(ids)]), device=dev)
    rows = torch.cat([b.to(dt).reshape(-1, r, o) for b in client_blocks])
    dense = torch.zeros((k * num_blocks, r, o), dtype=dt,
                        device=dev).index_add_(0, flat, rows)
    mask = torch.zeros((k * num_blocks,), dtype=torch.float32,
                       device=dev).index_add_(
                           0, flat, torch.ones(flat.shape[0], device=dev))
    return dense.reshape(k, num_blocks, r, o), mask.reshape(k, num_blocks)


Stack = Union[Tensor, Sequence[Tensor]]


def _total(stack: Stack, sharded: bool) -> Tensor:
    if not sharded:
        return ordered_sum(stack)
    return fold_shards([ordered_sum(s) for s in stack])


def _masked_mean(total: Tensor, count: Tensor, prev_coeff: Tensor) -> Tensor:
    prev_coeff = prev_coeff.to(total.device)
    trained = count > 0
    denom = torch.where(trained, count, torch.ones_like(count))
    mean = total / denom[:, None, None].to(total.dtype)
    return torch.where(trained[:, None, None], mean, prev_coeff)


def masked_block_merge(dense_stack: Stack, mask_stack: Stack,
                       prev_coeff: Tensor, mesh=None) -> Tensor:
    """Eq. (5) over a stacked client axis: ordered fold, then the shard
    fold.

    Without ``mesh`` the stacks are single tensors and this reproduces
    :func:`aggregate_coefficient` with ``weights=None`` bit for bit (the
    same left-to-right additions; zero rows are no-ops).  With ``mesh``
    (a :class:`~repro_torch.sharding.fl.CohortMesh`, in place of the JAX
    package's ``axis_name``) they are sequences of per-shard stacks, each
    on its shard's device: each shard folds its rows, and the partials are
    folded in shard order (float tolerance against the host loop).
    Returns the merged coefficient on the first shard's device.
    """
    sharded = mesh is not None
    return _masked_mean(_total(dense_stack, sharded),
                        _total(mask_stack, sharded), prev_coeff)


def masked_block_mean(dense_contrib: Sequence[Tensor],
                      mask: Sequence[Tensor], prev_coeff: Tensor,
                      mesh) -> Tensor:
    """Collective Eq. (5) with one client on each shard: the shard fold of
    the dense contributions over the shard fold of the masks."""
    if len(dense_contrib) != mesh.size:
        raise ValueError(f"{len(dense_contrib)} contributions for "
                         f"{mesh.size} shards")
    return _masked_mean(fold_shards(dense_contrib), fold_shards(mask),
                        prev_coeff)
