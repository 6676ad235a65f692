"""Global aggregation (Heroes, Sec. III phase 3): the merge rules.

* Neural basis: plain average over the K participating clients.
* Coefficient: *block-wise* aggregation (Eq. 5) — block ``i`` is averaged
  over exactly the clients that trained it this round; blocks nobody
  trained keep their previous value.

These are the per-client loops of the reference's ``agg_backend="host"``
path.  On one device its ``"collective"`` backend computes the same merge
bit for bit in a stacked form; the port runs these loops for both values
and brings the stacked form, and the reference's ``masked_block_mean``
(a ``psum`` over a device mesh), with the multi-device merge (ROADMAP
queue A step 9).  Staleness and sample weights go through one function,
:func:`blend`.
"""

from __future__ import annotations

from typing import Optional, Sequence

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
