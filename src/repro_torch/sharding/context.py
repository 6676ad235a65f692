"""Activation-sharding context (the reference:
``repro/sharding/context.py``).

Model code is mesh-agnostic; the launcher installs a context (a
:class:`~torch.distributed.device_mesh.DeviceMesh`, the data-parallel
axes and a residual-stream layout) and the model calls
``constrain_residual(x)`` at layer boundaries.  Without a context, or on
a plain tensor, the call is a no-op: every one-device path is unchanged.
On a DTensor the constraint is a ``redistribute`` (the reference's
``with_sharding_constraint``).

Residual layouts:
  "d_sharded"   (dp, None, 'model')  — hidden dim sharded (baseline)
  "seq_sharded" (dp, 'model', None)  — Megatron-style sequence parallelism
  "replicated"  (dp, None, None)

``moe_shardmap`` routes :func:`repro_torch.models.moe.apply_moe` to the
expert-parallel schedule (:mod:`repro_torch.models.moe_shardmap`) on the
mesh's ("data", "model") part.
"""

from __future__ import annotations

import contextlib
import threading

from repro_torch.kernels import is_dtensor
from repro_torch.sharding.rules import _fit_to_shape, mesh_axes, to_placements

_CTX = {"mesh": None, "dp": None, "residual": "d_sharded",
        "attn_qseq": False, "moe_shardmap": False}


def set_context(mesh, dp_axes, residual: str = "d_sharded",
                attn_qseq: bool = False, moe_shardmap: bool = False) -> None:
    _CTX.update(mesh=mesh, dp=dp_axes, residual=residual,
                attn_qseq=attn_qseq, moe_shardmap=moe_shardmap)


def clear_context() -> None:
    _CTX.update(mesh=None, dp=None, residual="d_sharded", attn_qseq=False,
                moe_shardmap=False)


def get_context() -> dict:
    return dict(_CTX)


@contextlib.contextmanager
def activation_sharding(mesh, dp_axes, residual: str = "d_sharded",
                        attn_qseq: bool = False, moe_shardmap: bool = False):
    prev = dict(_CTX)
    set_context(mesh, dp_axes, residual, attn_qseq, moe_shardmap)
    try:
        yield
    finally:
        _CTX.update(prev)


def _fit(spec_parts, shape, mesh):
    return _fit_to_shape(spec_parts, shape, mesh_axes(mesh))


def constrain(x, spec_parts):
    """``x`` redistributed to ``spec_parts`` fitted to its shape on the
    context's mesh; a plain tensor, or no context, passes through."""
    mesh = _CTX["mesh"]
    if mesh is None or not is_dtensor(x):
        return x
    spec = _fit(spec_parts, x.shape, mesh)
    return x.redistribute(mesh, to_placements(spec, mesh))


def as_dtensor(t, mesh):
    """``t`` as a DTensor on ``mesh``: a plain tensor (one made inside the
    model, the same on every device) is taken as replicated."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim,
                              run_check=False)


def write_slot(cache, slot: int, value) -> None:
    """``cache[:, slot] = value`` in place.  On a DTensor cache each
    device writes its own shard: the value is laid out as the cache
    without its slot dim, and where the slot dim is sharded only the
    device holding ``slot`` writes it."""
    if not is_dtensor(cache):
        cache[:, slot] = value
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    mesh = cache.device_mesh
    placements = tuple(
        Shard(p.dim - (p.dim > 1)) if isinstance(p, Shard) and p.dim != 1
        else Replicate() for p in cache.placements)
    local = as_dtensor(value, mesh).redistribute(mesh, placements).to_local()
    shape, offset = compute_local_shape_and_global_offset(
        cache.shape, mesh, cache.placements)
    i = slot - offset[1]
    if 0 <= i < shape[1]:
        cache.to_local()[:, i] = local


def constrain_attention_q(q, k, v):
    """Context-parallel attention layout: shard the QUERY sequence over the
    model axis and replicate k/v over it, so each device's attention is
    local (causal masking sees the whole k/v).

    q: (B, S, KV, G, D); k/v: (B, S, KV, D).
    """
    if _CTX["mesh"] is None or not _CTX["attn_qseq"] or q.shape[1] <= 1:
        return q, k, v
    dp = _CTX["dp"]
    return (constrain(q, (dp, "model", None, None, None)),
            constrain(k, (dp, None, None, None)),
            constrain(v, (dp, None, None, None)))


def constrain_logits(x):
    """Logits (B, S, V) with the vocab over ``"model"`` or, where it does
    not divide (seamless: 256206), the sequence (the reference's dry-run
    ``_logits_sharding``): the full-vocab logits never sit whole on a
    device."""
    mesh = _CTX["mesh"]
    if mesh is None or not is_dtensor(x):
        return x
    dp = _CTX["dp"]
    spec = _fit((dp, None, "model"), x.shape, mesh)
    if spec[2] is None and x.shape[1] > 1:
        spec2 = _fit((dp, "model", None), x.shape, mesh)
        if spec2[1] is not None:
            spec = spec2
    return x.redistribute(mesh, to_placements(spec, mesh))


def residual_layout():
    """The configured residual-stream spec, (B, S, d)."""
    dp = _CTX["dp"]
    return {"d_sharded": (dp, None, "model"),
            "seq_sharded": (dp, "model", None),
            "replicated": (dp, None, None)}[_CTX["residual"]]


def constrain_residual(x):
    """Apply the configured residual-stream layout to a (B, S, d) tensor."""
    if _CTX["mesh"] is None:
        return x
    return constrain(x, residual_layout())



_VIEWS = None
_MODE = threading.local()  # depth: on_mesh's view mode on this thread


def _views():
    global _VIEWS
    if _VIEWS is None:
        import torch
        _VIEWS = {torch.Tensor.view, torch.Tensor.reshape, torch.reshape,
                  torch.Tensor.unflatten, torch.Tensor.flatten,
                  torch.flatten}
    return _VIEWS


def _groups(old, new) -> list:
    """A reshape's dim groups: (input dims, output dims) pairs of equal
    size, in order, the dims of size 1 left out (DTensor moves them
    freely)."""
    a = [d for d, n in enumerate(old) if n != 1]
    b = [d for d, n in enumerate(new) if n != 1]
    i = j = 0
    groups = []
    while i < len(a) and j < len(b):
        ins, outs = [a[i]], [b[j]]
        pi, pj = old[a[i]], new[b[j]]
        i, j = i + 1, j + 1
        while pi != pj:
            if pi < pj:
                ins.append(a[i])
                pi *= old[a[i]]
                i += 1
            else:
                outs.append(b[j])
                pj *= new[b[j]]
                j += 1
        groups.append((ins, outs))
    return groups


def _reshape_placements(x, shape) -> tuple:
    """x's placements with each split dim made whole that DTensor cannot
    carry through ``x.reshape(shape)``: a dim split that is not the first
    of the dims it merges with, is not split evenly, or is cut into dims
    the first of which its shard count does not divide (768 over 16
    devices into 4 heads of 192), or a dim a strided split already came
    from.  A dim the reshape keeps as it is stays split."""
    from torch.distributed.tensor import Replicate, Shard

    count = {}  # dim -> devices its shards lie over
    for n, p in zip(x.device_mesh.shape, x.placements):
        if isinstance(p, Shard):
            count[p.dim] = count.get(p.dim, 1) * n
    strided = {p.dim for p in x.placements
               if isinstance(p, Shard) and type(p) is not Shard}
    whole = set()
    for ins, outs in _groups(tuple(x.shape), tuple(shape)):
        if len(ins) == len(outs) == 1 and ins[0] not in strided:
            continue
        merged_and_cut = len(ins) > 1 and len(outs) > 1
        for pos, d in enumerate(ins):
            n = count.get(d)
            if n and (pos or d in strided or merged_and_cut
                      or x.shape[d] % n or shape[outs[0]] % n):
                whole.add(d)
    return tuple(Replicate() if isinstance(p, Shard) and p.dim in whole
                 else p for p in x.placements)


def _reshaped(x, shape):
    """``x.reshape(shape)`` on a DTensor, with the split dims made whole
    first that DTensor cannot reshape on x's layout
    (:func:`_reshape_placements`), as the reference's compiler reshards
    before such a reshape."""
    placements = _reshape_placements(x, shape)
    if placements != tuple(x.placements):
        x = x.redistribute(x.device_mesh, placements)
    return x.reshape(shape)


def _reshape_fn():
    import torch

    class Reshape(torch.autograd.Function):
        """:func:`_reshaped`, and the same for its gradient: the gradient
        may come back on a layout the forward's input did not have."""

        @staticmethod
        def forward(ctx, x, shape):
            ctx.shape = x.shape
            return _reshaped(x, shape)

        @staticmethod
        def backward(ctx, grad):
            return _reshaped(grad, ctx.shape), None

    return Reshape


def on_mesh():
    """The context the step functions run the model in on a device mesh:
    a plain tensor the model makes (positions, a rotary table, a mask, the
    step counter) meets DTensors as a replicated DTensor
    (:func:`_replicated`, and DTensor's implicit replication for what
    reaches its dispatcher, whose flag is process-wide), and every view or
    reshape of a DTensor goes through :func:`_reshaped` (its gradient
    too), which gathers the split dims that DTensor cannot reshape, as the
    reference's compiler reshards before such a reshape."""
    import torch
    from torch.overrides import TorchFunctionMode

    reshape = _reshape_fn()

    class _ReshardViews(TorchFunctionMode):
        def __enter__(self):
            _MODE.depth = getattr(_MODE, "depth", 0) + 1
            return super().__enter__()

        def __exit__(self, *exc):
            _MODE.depth -= 1
            return super().__exit__(*exc)

        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            args, kwargs = _replicated(args, kwargs)
            if func not in _views() or not args or not is_dtensor(args[0]):
                return func(*args, **kwargs)
            x = args[0]
            shape = func(torch.empty(x.shape, device="meta"), *args[1:],
                         **kwargs).shape
            if torch.is_grad_enabled() and x.requires_grad:
                return reshape.apply(x, shape)
            return _reshaped(x, shape)

    stack = contextlib.ExitStack()
    stack.enter_context(_implicit_replication())
    if not getattr(_MODE, "depth", 0):  # once a thread
        stack.enter_context(_ReshardViews())
    return stack


def _replicated(args, kwargs):
    """``args`` and ``kwargs`` with each plain tensor made a replicated
    DTensor where a DTensor is among them, so that autograd records only
    DTensor ops: its backward, in a thread of its own on the card, never
    meets a plain tensor (a rotary table or a mask the forward saved)."""
    import torch
    from torch.utils._pytree import tree_flatten, tree_map_only

    leaves = [t for t in tree_flatten((args, kwargs))[0]
              if isinstance(t, torch.Tensor)]
    mesh = next((t.device_mesh for t in leaves if is_dtensor(t)), None)
    if mesh is None or all(is_dtensor(t) for t in leaves):
        return args, kwargs
    return tree_map_only(torch.Tensor, lambda t: as_dtensor(t, mesh),
                         (args, kwargs))


_REPLICATION = {"depth": 0}  # on_mesh contexts open, in every thread
_REPLICATION_LOCK = threading.Lock()


@contextlib.contextmanager
def _implicit_replication():
    """DTensor's ``implicit_replication`` (a plain tensor meeting a DTensor
    taken as replicated), entered by the outermost :func:`on_mesh` only.
    Its flag is process-wide and its exit turns it off: a replay that
    autograd runs in its own thread nests inside the step's context and
    must leave it on."""
    from torch.distributed.tensor.experimental import implicit_replication

    with _REPLICATION_LOCK:
        first = _REPLICATION["depth"] == 0
        _REPLICATION["depth"] += 1
        ctx = implicit_replication() if first else contextlib.nullcontext()
        ctx.__enter__()
    try:
        yield
    finally:
        with _REPLICATION_LOCK:
            _REPLICATION["depth"] -= 1
            ctx.__exit__(None, None, None)


def in_mesh_context(fn):
    """``fn`` entering :func:`on_mesh` when it runs, if the caller is in
    it now: a function autograd replays in its own thread (an activation
    checkpoint's forward) keeps the mesh's context; else ``fn``."""
    if not getattr(_MODE, "depth", 0):
        return fn

    def run(*args, **kwargs):
        with on_mesh():
            return fn(*args, **kwargs)

    return run
