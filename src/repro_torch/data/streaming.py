"""Client data pipelines: shard views, the host RNG contract, and a
per-client batch loader that hands out tensors on the run's device.

:class:`ShardView` keeps ONE global numpy array per split plus per-client
index vectors and gathers only the minibatches a round touches.
:class:`ClientDataLoader` owns the *host RNG contract* shared with the JAX
package: client ``n`` in round ``r`` draws from
``np.random.default_rng((seed, r, n))`` — ``tau`` training-batch index
draws of size ``batch``, then 3 estimate-batch draws — so the port sees
the reference's exact minibatches.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch


class ShardView:
    """Lazy per-client view: ``view[idx] == base[indices[idx]]``."""

    __slots__ = ("base", "indices")

    def __init__(self, base: np.ndarray, indices: np.ndarray):
        self.base = base
        self.indices = np.asarray(indices, np.int64)

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, idx):
        return self.base[self.indices[idx]]

    @property
    def shape(self):
        return (len(self.indices),) + self.base.shape[1:]

    @property
    def dtype(self):
        return self.base.dtype

    @property
    def ndim(self) -> int:
        return self.base.ndim

    def materialize(self) -> np.ndarray:
        return self.base[self.indices]

    def __array__(self, dtype=None):
        out = self.materialize()
        return out.astype(dtype) if dtype is not None else out


def make_shards(x: np.ndarray, y: np.ndarray, parts):
    """Per-client (parts_x, parts_y): :class:`ShardView`s over the single
    global arrays, one per index list."""
    return ([ShardView(x, p) for p in parts],
            [ShardView(y, p) for p in parts])


def round_batch_indices(seed: int, rnd: int, n: int, num_samples: int,
                        tau: int, batch_size: int, estimate: bool
                        ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """The engine's host RNG contract, in one place.

    Returns ``(idx, est_idx)``: ``idx`` of shape ``(tau, batch_size)`` and
    ``est_idx`` of shape ``(3, batch_size)`` or None.  Draw order matches
    ``local_train``: tau training draws, then 3 estimate draws.
    """
    rng = np.random.default_rng((seed, rnd, n))
    idx = np.stack([rng.integers(0, num_samples, batch_size)
                    for _ in range(tau)])
    est_idx = None
    if estimate:
        est_idx = np.stack([rng.integers(0, num_samples, batch_size)
                            for _ in range(3)])
    return idx, est_idx


def to_batch(input_key: str, x: np.ndarray, y: np.ndarray,
             device) -> dict:
    """A host minibatch as the model's batch dict on ``device``."""
    return {input_key: torch.as_tensor(x, device=device),
            "labels": torch.as_tensor(y, dtype=torch.long, device=device)}


class ClientDataLoader:
    """Per-client minibatch streams over (possibly lazy) shards, handing
    out tensors on ``device``."""

    def __init__(self, parts_x: Sequence, parts_y: Sequence, device,
                 input_key: str = "x"):
        if len(parts_x) != len(parts_y):
            raise ValueError(f"{len(parts_x)} x-shards vs {len(parts_y)} y")
        self.parts_x, self.parts_y = parts_x, parts_y
        self.device = torch.device(device)
        self.input_key = input_key

    @property
    def num_clients(self) -> int:
        return len(self.parts_x)

    def num_samples(self, n: int) -> int:
        return len(self.parts_y[n])

    def gather(self, n: int, idx: np.ndarray) -> dict:
        """Client ``n``'s samples at ``idx`` as a batch dict on the device."""
        return to_batch(self.input_key, self.parts_x[n][idx],
                        self.parts_y[n][idx], self.device)

    def draw_round(self, n: int, *, seed: int, rnd: int, tau: int,
                   batch_size: int, estimate: bool):
        """(tau training batches, 3 estimate batches or None) for one
        client-round under the RNG contract."""
        idx, est_idx = round_batch_indices(
            seed, rnd, n, self.num_samples(n), tau, batch_size, estimate)
        steps = [self.gather(n, i) for i in idx]
        est = None if est_idx is None else [self.gather(n, i)
                                            for i in est_idx]
        return steps, est
