"""Global aggregation (Heroes, Sec. III phase 3): the host merge rules.

* Neural basis: plain average over the K participating clients.
* Coefficient: *block-wise* aggregation (Eq. 5) — block ``i`` is averaged
  over exactly the clients that trained it this round; blocks nobody
  trained keep their previous value.

These are the per-client loops of the reference's ``agg_backend="host"``
path, without its blend weights (used by the semi-async loop and
``sample_weighted``, not ported yet); the stacked collective merge comes
with the collective backend.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

Tensor = torch.Tensor


def aggregate_basis(client_bases: Sequence[Tensor]) -> Tensor:
    """v^{h+1} = (1/K) sum_n v̄_n^h."""
    return torch.stack(list(client_bases)).mean(0)


def aggregate_coefficient(global_coeff: Tensor,
                          client_blocks: Sequence[Tensor],
                          client_block_ids: Sequence[np.ndarray]) -> Tensor:
    """Block-wise aggregation, Eq. (5).

    Args:
      global_coeff: previous complete coefficient ``(P^2, R, O)``.
      client_blocks: per client, its updated reduced coefficient
        ``(m_n, R, O)``; client_block_ids: the block indices of its rows.

    Returns the new complete coefficient; untrained blocks are unchanged.
    """
    num_blocks = global_coeff.shape[0]
    acc = torch.zeros_like(global_coeff)
    cnt = torch.zeros((num_blocks,), dtype=torch.float32,
                      device=global_coeff.device)
    for blocks, ids in zip(client_blocks, client_block_ids):
        idx = torch.as_tensor(np.asarray(ids, np.int64),
                              device=global_coeff.device)
        acc = acc.index_add(0, idx, blocks.to(acc.dtype))
        cnt = cnt.index_add(0, idx, torch.ones_like(idx, dtype=cnt.dtype))
    trained = cnt > 0
    denom = torch.where(trained, cnt, torch.ones_like(cnt))
    mean = acc / denom[:, None, None].to(acc.dtype)
    return torch.where(trained[:, None, None], mean, global_coeff)

