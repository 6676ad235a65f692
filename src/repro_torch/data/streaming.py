"""Client data pipelines: shard views, the host RNG contract, and a
per-client batch loader that hands out tensors on the run's device.

:class:`ShardView` keeps ONE global numpy array per split plus per-client
index vectors and gathers only the minibatches a round touches;
:class:`VirtualShardList` derives a population's views on demand.
:class:`ClientDataLoader` owns the *host RNG contract* shared with the JAX
package: client ``n`` in round ``r`` draws from
``np.random.default_rng((seed, r, n))`` — ``tau`` training-batch index
draws of size ``batch``, then 3 estimate-batch draws — so the port sees
the reference's exact minibatches.  The cohort trainer stages a group's
host batches on the loader's prefetch thread (:meth:`ClientDataLoader.
prefetch`), stacked on a client axis (:func:`stack_client_shards`) and
packed for one host-to-device copy (:func:`pack_arrays`).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import (Any, Callable, Iterable, Iterator, List, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from repro_torch.obs.recorder import NOOP


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


class VirtualShardList:
    """Population-sized shard sequence backed by a pure index function.

    ``parts[n]`` builds a :class:`ShardView` from ``index_fn(n)`` on
    demand, so a 10^6-client partition costs nothing until a client is
    actually sampled — the O(cohort) stand-in for a materialized
    ``num_clients``-long partition list.  ``index_fn`` must be pure in
    ``n`` (:class:`repro_torch.fl.population.VirtualPartition`), which is
    what keeps shards identical across processes and independent of the
    population size or query order.  ``registry`` optionally carries the
    :class:`~repro_torch.fl.population.PopulationRegistry` the engine
    binds its heterogeneity model and participation bookkeeping to.
    """

    virtual = True

    def __init__(self, base: np.ndarray, index_fn: Callable[[int], np.ndarray],
                 size: int, registry=None):
        self.base = base
        self.index_fn = index_fn
        self.size = size
        self.registry = registry

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, n) -> ShardView:
        n = int(n)
        if not 0 <= n < self.size:
            raise IndexError(n)
        return ShardView(self.base, self.index_fn(n))

    def __iter__(self):
        return (self[n] for n in range(self.size))


def make_shards(x: np.ndarray, y: np.ndarray, parts,
                streaming: bool = True):
    """Per-client (parts_x, parts_y) from global arrays + index lists.

    ``streaming=True`` returns :class:`ShardView`s over the single global
    array; ``streaming=False`` materializes per-client copies.  Gathered
    minibatches are byte-identical either way.

    A *lazy* partition — anything exposing ``indices(n)`` and ``len``,
    e.g. :class:`repro_torch.fl.population.VirtualPartition` — yields
    :class:`VirtualShardList`s instead: no per-client index arrays are
    materialized, each sampled client's shard is derived on demand.
    """
    if callable(getattr(parts, "indices", None)):
        size = len(parts)
        return (VirtualShardList(x, parts.indices, size),
                VirtualShardList(y, parts.indices, size))
    if streaming:
        return ([ShardView(x, p) for p in parts],
                [ShardView(y, p) for p in parts])
    return [x[p] for p in parts], [y[p] for p in parts]


def round_batch_indices(seed: int, rnd: int, n: int, num_samples: int,
                        tau: int, batch_size: int, estimate: bool,
                        tau_pad: Optional[int] = None
                        ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """The engine's host RNG contract, in one place.

    Returns ``(idx, est_idx)``: ``idx`` of shape ``(tau_pad or tau,
    batch_size)`` (padding steps repeat the last real batch; the cohort
    step masks them) and ``est_idx`` of shape ``(3, batch_size)`` or
    None.  Draw order matches ``local_train``: tau training draws, then 3
    estimate draws, whatever the padding.
    """
    rng = np.random.default_rng((seed, rnd, n))
    idx = np.stack([rng.integers(0, num_samples, batch_size)
                    for _ in range(tau)])
    pad = (tau_pad or tau) - tau
    if pad > 0:
        idx = np.concatenate([idx, np.broadcast_to(idx[-1],
                                                   (pad, batch_size))])
    est_idx = None
    if estimate:
        est_idx = np.stack([rng.integers(0, num_samples, batch_size)
                            for _ in range(3)])
    return idx, est_idx


def stack_client_shards(per_client: Sequence[np.ndarray], chunks: int,
                        step_leading: bool = False) -> List[np.ndarray]:
    """Stack per-client batch arrays into ``chunks`` contiguous groups,
    one per shard of the cohort: each chunk is stacked on its own, so the
    full cohort batch never exists contiguously on the host.  A chunk is
    ``(C/chunks, steps, ...)``, or with ``step_leading`` ``(steps,
    C/chunks, ...)``, the layout the cohort step reads a step from;
    ``chunks=1`` gives the one stack of the whole cohort."""
    n = len(per_client)
    if n % chunks:
        raise ValueError(f"{n} clients not divisible into {chunks} chunks")
    per = n // chunks
    out = []
    for c in range(chunks):
        stk = np.stack(per_client[c * per:(c + 1) * per])
        out.append(np.moveaxis(stk, 0, 1) if step_leading else stk)
    return out


def pack_arrays(arrays: Sequence[np.ndarray]):
    """Host arrays as one byte buffer, each at an 8-byte aligned offset,
    and the layout :func:`unpack_tensors` reads them back by: so a group
    of batches crosses to the device in one copy."""
    layout, parts, off = [], [], 0
    for a in arrays:
        a = np.ascontiguousarray(a)
        pad = -off % 8
        if pad:
            parts.append(np.zeros(pad, np.uint8))
            off += pad
        parts.append(a.reshape(-1).view(np.uint8))
        layout.append((off, a.nbytes, a.dtype, a.shape))
        off += a.nbytes
    buf = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    return buf, layout


def unpack_tensors(buf: torch.Tensor, layout) -> List[torch.Tensor]:
    """The arrays of :func:`pack_arrays` as views into ``buf`` (a uint8
    tensor of its bytes, on any device)."""
    out = []
    for off, nbytes, dtype, shape in layout:
        t = buf[off:off + nbytes].view(_TORCH_DTYPES[np.dtype(dtype)])
        out.append(t.reshape(shape))
    return out


_TORCH_DTYPES = {np.dtype(np.float32): torch.float32,
                 np.dtype(np.float64): torch.float64,
                 np.dtype(np.int32): torch.int32,
                 np.dtype(np.int64): torch.int64,
                 np.dtype(np.uint8): torch.uint8}


def to_batch(input_key: str, x: np.ndarray, y: np.ndarray,
             device) -> dict:
    """A host minibatch as the model's batch dict on ``device``."""
    return {input_key: torch.as_tensor(x, device=device),
            "labels": torch.as_tensor(y, dtype=torch.long, device=device)}


# host items the prefetch thread stages ahead of the consumer at most
PREFETCH_DEPTH = 2


class ClientDataLoader:
    """Per-client minibatch streams over (possibly lazy) shards, handing
    out tensors on ``device`` (:meth:`gather`) or host arrays
    (:meth:`draw_round`), and staging host work ahead of the device on a
    background thread (:meth:`prefetch`)."""

    def __init__(self, parts_x: Sequence, parts_y: Sequence, device,
                 input_key: str = "x"):
        if len(parts_x) != len(parts_y):
            raise ValueError(f"{len(parts_x)} x-shards vs {len(parts_y)} y")
        self.parts_x, self.parts_y = parts_x, parts_y
        self.device = torch.device(device)
        self.input_key = input_key
        # telemetry recorder (repro_torch.obs); the engine runner rebinds
        # it to its own, the no-op keeps a standalone loader
        # uninstrumented
        self.obs = NOOP
        # live prefetch workers: (stop event, thread) pairs, so close()
        # can release them even when a round body died before its
        # generator's cleanup ran
        self._workers: list = []
        self._workers_lock = threading.Lock()

    @classmethod
    def from_dataset(cls, dataset, parts: Sequence[np.ndarray],
                     streaming: bool = True, **kw) -> "ClientDataLoader":
        """A loader over ``dataset``'s train split cut by ``parts``
        (:func:`make_shards`); ``kw`` are the constructor's (``device``,
        ``input_key``)."""
        px, py = make_shards(dataset.x, dataset.y, parts, streaming)
        return cls(px, py, **kw)

    @property
    def num_clients(self) -> int:
        return len(self.parts_x)

    def num_samples(self, n: int) -> int:
        return len(self.parts_y[n])

    def shard(self, n: int):
        """Client ``n``'s (x, y) shard, as the loader holds it (a view
        or a copy on the host)."""
        return self.parts_x[n], self.parts_y[n]

    def gather(self, n: int, idx: np.ndarray) -> dict:
        """Client ``n``'s samples at ``idx`` as a batch dict on the device."""
        return to_batch(self.input_key, self.parts_x[n][idx],
                        self.parts_y[n][idx], self.device)

    def draw_round(self, n: int, *, seed: int, rnd: int, tau: int,
                   batch_size: int, estimate: bool,
                   tau_pad: Optional[int] = None):
        """(xs, ys, est) host arrays for one client-round under the RNG
        contract: ``xs``/``ys`` lead with the (padded) step axis, ``est``
        is the ``(3, batch, ...)`` estimate-batch pair or None."""
        idx, est_idx = round_batch_indices(
            seed, rnd, n, self.num_samples(n), tau, batch_size, estimate,
            tau_pad)
        x, y = self.parts_x[n], self.parts_y[n]
        est = None if est_idx is None else (x[est_idx], y[est_idx])
        return x[idx], y[idx], est

    def close(self) -> None:
        """Release every background prefetch worker this loader started
        (safe to call again)."""
        with self._workers_lock:
            workers, self._workers = self._workers, []
        for stop, _ in workers:
            stop.set()
        for _, t in workers:
            t.join(timeout=5.0)

    def prefetch(self, items: Iterable[Any],
                 fn: Callable[[Any], Any]) -> Iterator[Any]:
        """Yield ``fn(item)`` in order, computing up to ``PREFETCH_DEPTH``
        items ahead on a background thread.

        ``fn`` must be host-only (numpy): it runs off the main thread so
        the device step of one group overlaps the gathers of the next.
        The worker is released when the consumer finishes, raises or
        closes the generator.
        """
        items = list(items)
        if len(items) <= 1:  # nothing to overlap
            for it in items:
                yield fn(it)
            return
        q: "queue.Queue" = queue.Queue(maxsize=PREFETCH_DEPTH)
        stop = threading.Event()
        end, fail = object(), object()

        def put(obj) -> bool:
            """Bounded put that gives up when the consumer is gone."""
            while not stop.is_set():
                try:
                    q.put(obj, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for it in items:
                    if stop.is_set() or not put(fn(it)):
                        return
                put(end)
            except BaseException as e:  # raised again in the consumer
                put((fail, e))

        t = threading.Thread(target=worker, daemon=True,
                             name="client-data-prefetch")
        with self._workers_lock:
            self._workers.append((stop, t))
        t.start()
        obs = self.obs
        try:
            while True:
                if obs.enabled:
                    # stall = consumer time blocked on the staging thread;
                    # depth sampled just before the blocking get
                    obs.observe("data.prefetch_depth", q.qsize())
                    t0 = time.perf_counter()
                    got = q.get()
                    obs.observe("data.prefetch_stall_s",
                                time.perf_counter() - t0)
                else:
                    got = q.get()
                if got is end:
                    break
                if isinstance(got, tuple) and len(got) == 2 \
                        and got[0] is fail:
                    raise got[1]
                yield got
        finally:
            stop.set()
            while not q.empty():
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=5.0)
            with self._workers_lock:
                self._workers = [(s, th) for s, th in self._workers
                                 if th is not t and th.is_alive()]
