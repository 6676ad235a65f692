"""FL aggregation sharding: the cohort's shards and the split coefficient.

The engine's collective merge lays *clients* out over an ordered list of
devices, the cohort's shards (``COHORT_AXIS``, the JAX package's 1-D
mesh axis): each shard folds its contiguous slice of the stacked
contributions in order, then the shard partials are folded in shard
order on the first shard's device (the JAX package's ``psum``;
:func:`repro_torch.core.aggregation.fold_shards`).  The same shards
double as the *block* axis of the merged coefficient when the server
state is sharded (``FLConfig.shard_server_state``): after the fold every
shard keeps its contiguous slice of the ``P^2`` block dimension
(:class:`SplitBlocks`), so the whole coefficient need not sit on one
device.

The devices are the run device's kind: ``cuda:0..n-1`` for a CUDA run,
one CPU device for ``device="cpu"``.  :func:`logical_devices` overrides
them with one device repeated, the counterpart of the JAX package's
``--xla_force_host_platform_device_count``: the shard arithmetic then
runs as it would across devices, and a copy to a shard's device is no
copy at all.  With fewer than two shards every helper degrades to
``None`` or a no-op, and the engine merges with its host rules.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.sharding.rules import Spec

COHORT_AXIS = "cohort"

_LOGICAL: Optional[Tuple[torch.device, ...]] = None


def _concrete(device) -> torch.device:
    """``device`` with its index filled in (``cuda`` -> ``cuda:<current>``),
    so shards compare equal to the devices their tensors report."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@contextlib.contextmanager
def logical_devices(n: int, device="cuda") -> Iterator[Tuple[torch.device,
                                                             ...]]:
    """Make the local devices ``[device] * n`` inside the block: ``n``
    logical shards of one device.  Meshes are taken when a runner is
    built, so a runner built inside keeps its shards after the block."""
    global _LOGICAL
    prev = _LOGICAL
    _LOGICAL = (_concrete(device),) * int(n)
    try:
        yield _LOGICAL
    finally:
        _LOGICAL = prev


def local_devices(device=None) -> Tuple[torch.device, ...]:
    """The devices a cohort may shard over: the :func:`logical_devices`
    override when one is active, else every CUDA device for a CUDA run
    and the one CPU device for a CPU run."""
    if _LOGICAL is not None:
        return _LOGICAL
    dev = resolve_device(device)
    if dev.type == "cuda":
        return tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    return (dev,)


@dataclasses.dataclass(frozen=True)
class CohortMesh:
    """An ordered list of shard devices (the cohort axis)."""

    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    def slices(self, rows: int) -> List[slice]:
        """Each shard's contiguous row range of a ``rows``-row stack."""
        if rows % self.size:
            raise ValueError(f"{rows} rows not divisible over "
                             f"{self.size} shards")
        per = rows // self.size
        return [slice(s * per, (s + 1) * per) for s in range(self.size)]


def cohort_mesh(max_devices: int = 0, device=None) -> Optional[CohortMesh]:
    """The cohort's shards over the local devices, or ``None`` when fewer
    than two exist.  ``max_devices > 0`` caps them; 0 means all."""
    devs = local_devices(device)
    if max_devices > 0:
        devs = devs[:max_devices]
    if len(devs) < 2:
        return None
    return CohortMesh(tuple(devs))


def contribution_spec() -> Spec:
    """Layout of stacked client contributions: client axis on the
    shards."""
    return Spec(COHORT_AXIS)


def replicated_spec() -> Spec:
    return Spec()


def block_spec() -> Spec:
    """Block-axis-split layout of the merged coefficient."""
    return Spec(COHORT_AXIS)


def client_axis_spec(axis: int) -> Spec:
    """Spec for a tensor whose client axis sits at position ``axis``."""
    return Spec(*((None,) * axis + (COHORT_AXIS,)))


def mesh_size(mesh: Optional[CohortMesh]) -> int:
    return 1 if mesh is None else mesh.size


def pad_cohort(k: int, mesh: Optional[CohortMesh]) -> int:
    """Padded client count: next multiple of the shard count (1: k)."""
    n = mesh_size(mesh)
    return ((k + n - 1) // n) * n


def can_shard_blocks(num_blocks: int, mesh: Optional[CohortMesh]) -> bool:
    """Block sharding needs the block axis divisible by the shards."""
    return mesh is not None and num_blocks % mesh.size == 0


def split_rows(t: torch.Tensor, mesh: CohortMesh,
               axis: int = 0) -> List[torch.Tensor]:
    """``t``'s contiguous slices along ``axis``, one per shard, each on
    its shard's device (the same tensor's views where that is ``t``'s
    device)."""
    return [t[(slice(None),) * axis + (sl,)].to(d)
            for sl, d in zip(mesh.slices(t.shape[axis]), mesh.devices)]


def assemble_from_host_shards(shards: Sequence[np.ndarray],
                              mesh: CohortMesh) -> List[torch.Tensor]:
    """Per-shard tensors from per-shard *host* chunks, no host concat:
    each numpy chunk goes straight to its own shard's device."""
    if len(shards) != mesh.size:
        raise ValueError(f"{len(shards)} shards for {mesh.size} devices")
    return [torch.from_numpy(np.ascontiguousarray(s)).to(d)
            for s, d in zip(shards, mesh.devices)]


class SplitBlocks:
    """A merged coefficient split over its block axis: shard ``s`` holds
    blocks ``[s * NB/n, (s + 1) * NB/n)`` on its own device, across
    rounds.  :meth:`take_blocks` takes the blocks a client needs from the
    shards holding them; :meth:`whole` assembles the complete tensor on
    the first shard's device (evaluation, checkpoints, tests)."""

    __slots__ = ("parts",)

    def __init__(self, parts: Sequence[torch.Tensor]):
        self.parts = tuple(parts)

    @classmethod
    def split(cls, whole: torch.Tensor, mesh: CohortMesh) -> "SplitBlocks":
        # each shard keeps its own storage, so the whole tensor is freed
        return cls([p.clone() for p in split_rows(whole, mesh)])

    @property
    def per(self) -> int:
        return self.parts[0].shape[0]

    @property
    def shape(self) -> torch.Size:
        p = self.parts[0]
        return torch.Size((p.shape[0] * len(self.parts),) + p.shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def device(self) -> torch.device:
        return self.parts[0].device

    def take_blocks(self, ids) -> torch.Tensor:
        """Blocks ``ids`` (host indices, in that order) on the first
        shard's device: one ``index_select`` on each shard holding some."""
        ids = np.asarray(ids, np.int64)
        owner = ids // self.per
        picked, order = [], []
        for s in np.unique(owner):
            at = np.nonzero(owner == s)[0]
            idx = torch.as_tensor(ids[at] - s * self.per,
                                  device=self.parts[s].device)
            picked.append(self.parts[s].index_select(0, idx).to(self.device))
            order.append(at)
        if not picked:
            return self.parts[0][:0]
        out = torch.cat(picked)
        perm = np.argsort(np.concatenate(order), kind="stable")
        if np.array_equal(perm, np.arange(perm.size)):
            return out
        return out.index_select(0, torch.as_tensor(perm, device=self.device))

    def whole(self) -> torch.Tensor:
        return torch.cat([p.to(self.device) for p in self.parts])


def assemble(tree):
    """``tree`` with every :class:`SplitBlocks` leaf made whole."""
    if isinstance(tree, dict):
        return {k: assemble(v) for k, v in tree.items()}
    if isinstance(tree, SplitBlocks):
        return tree.whole()
    return tree
