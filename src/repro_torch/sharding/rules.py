"""Sharding rules: param-tree paths -> specs, and specs -> DTensor
placements (the reference: ``repro/sharding/rules.py``).

Conventions (per-pod mesh ("data", "model") = (16, 16); multi-pod adds a
leading "pod" axis used for data parallelism and, where memory demands
it (kimi-k2), extra parameter sharding):

  * "column-parallel" projections (d -> heads/ff):  (..., d, out)  ->  ('data', 'model')
    — model parallelism over heads/FFN, ZeRO-style FSDP over the d rows.
  * "row-parallel" projections (heads/ff -> d):     (..., in, d)   ->  ('model', 'data')
  * expert tensors (E, d, f):                        E -> 'model' (expert
    parallel), d -> 'data' (FSDP).
  * embeddings (V, d): vocab -> 'model', d -> 'data'.
  * small/1D tensors (norms, biases, gates): replicated.

Rules are keyed by path *suffix* of the UNSTACKED weight; any extra leading
stack axes (layer stacks: 1 extra; hybrid/xlstm superblocks: 2 extra) are
padded with ``None``.  Paths are the dotted keys of the port's nested
param dicts, which are the reference's keys, so the same regexes match.

A :class:`Spec` is the port's ``PartitionSpec``: a tuple with one entry
per tensor dim, each a mesh-axis name, a tuple of names (a dim sharded
over several mesh axes) or None.  :func:`to_placements` turns it into
the placements of a ``torch.distributed`` :class:`DeviceMesh`.  A mesh
here is anything with ``.shape`` (axis name -> size) and ``.axis_names``
(:func:`mesh_axes` reads a DeviceMesh so).
"""

from __future__ import annotations

import re
from typing import Any, Tuple

from repro_torch.core.estimator import tree_map

# ordered (regex on dotted path, base spec for trailing dims)
_RULES: Tuple[Tuple[str, Tuple], ...] = (
    # --- embeddings -----------------------------------------------------
    (r"(embed|unembed)\.table$", ("model", "data")),
    # --- attention projections ------------------------------------------
    (r"(attn|self_attn|cross_attn)\.w[qkv]\.w$", ("data", "model")),
    (r"(attn|self_attn|cross_attn)\.wo\.w$", ("model", "data")),
    # factorized (Heroes composition) projections
    (r"\.w[qkvo]\.basis$", ("data", None)),
    (r"\.w[qkvo]\.coeff$", (None, None, "model")),
    # --- dense MLP -------------------------------------------------------
    (r"mlp\.(gate|up)\.w$", ("data", "model")),
    (r"mlp\.down\.w$", ("model", "data")),
    (r"mlp\.(gate|up)\.basis$", ("data", None)),
    (r"mlp\.(gate|up)\.coeff$", (None, None, "model")),
    (r"mlp\.down\.basis$", ("model", None)),
    (r"mlp\.down\.coeff$", (None, None, "data")),
    # --- MoE ---------------------------------------------------------------
    (r"moe.*router\.w$", ("data", None)),
    (r"moe.*\.(gate|up)$", ("model", "data", None)),
    (r"moe.*\.down$", ("model", None, "data")),
    (r"shared\.(gate|up)\.w$", ("data", "model")),
    (r"shared\.down\.w$", ("model", "data")),
    # --- Mamba2 -----------------------------------------------------------
    (r"in_proj\.w$", ("data", "model")),
    (r"out_proj\.w$", ("model", "data")),
    (r"in_proj\.basis$", ("data", None)),
    (r"in_proj\.coeff$", (None, None, "model")),
    (r"out_proj\.basis$", ("model", None)),
    (r"out_proj\.coeff$", (None, None, "data")),
    (r"conv_w$", (None, "model")),
    (r"conv_b$", ("model",)),
    (r"(A_log|D|dt_bias)$", (None,)),
    # --- xLSTM --------------------------------------------------------------
    (r"(up|wq|wk|wv|ff_up)\.w$", ("data", "model")),
    (r"(down|ff_down)\.w$", ("model", "data")),
    (r"(up|wq|wk|wv|ff_up)\.basis$", ("data", None)),
    (r"(up|wq|wk|wv|ff_up)\.coeff$", (None, None, "model")),
    (r"(down|ff_down)\.basis$", ("model", None)),
    (r"(down|ff_down)\.coeff$", (None, None, "data")),
    (r"wif\.w$", ("data", None)),
    (r"wx\.w$", ("data", "model")),
    (r"\br$", ("model", None, None)),
    (r"skip$", (None,)),
    (r"bias$", (None,)),
    # --- norms / scalars ------------------------------------------------
    (r"(ln1|ln2|ln_x|norm|out_norm|gn|final_norm)\.(scale|bias)$", (None,)),
)


class Spec(tuple):
    """The sharding of one tensor: one entry per dim, each a mesh-axis
    name, a tuple of names, or None (the dim is whole on every device)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def _padded(spec, ndim: int) -> Spec:
    return Spec(*(tuple(spec) + (None,) * (ndim - len(spec))))


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= mesh.shape[a]
        return n
    return mesh.shape[axis]


def _fit_to_shape(spec, shape, mesh) -> Spec:
    """Drop sharding on any dim the mesh axis doesn't divide."""
    if mesh is None:
        return _padded(spec, len(shape))
    parts = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, axis in zip(shape, parts):
        out.append(axis if axis is not None and dim % _axis_size(mesh, axis) == 0
                   else None)
    return Spec(*out)


def _spec_for(path: str, ndim: int) -> Spec:
    for pat, base in _RULES:
        if re.search(pat, path):
            pad = ndim - len(base)
            if pad < 0:  # rule longer than array (e.g. squeezed): replicate
                return Spec(*([None] * ndim))
            return Spec(*([None] * pad), *base)
    return Spec(*([None] * ndim))  # default: replicate


def _map_with_path(fn, tree, prefix: str = ""):
    """``fn(dotted path, leaf)`` over nested dicts, keeping their shape."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{prefix}.{k}" if prefix else str(k))
                for k, v in tree.items()}
    return fn(prefix, tree)


def param_specs(params: Any, mesh=None, zero_pod: bool = False,
                moe_ep: bool = False) -> Any:
    """Spec tree mirroring ``params`` (tensors, ``meta`` ones included).

    mesh: when given, any sharded dim the mesh axis size doesn't divide
      falls back to replication for that dim.
    zero_pod: additionally shard the largest tensors over the 'pod' axis
      (ZeRO across pods), used by the trillion-param config.
    moe_ep: weight-stationary expert parallelism: expert tensors shard
      ONLY over 'model' (no FSDP on the data axis), matching the
      expert-parallel schedule (repro_torch.models.moe_shardmap).
    """

    def f(name, leaf):
        spec = _spec_for(name, leaf.dim())
        if moe_ep and re.search(r"moe.*\.(gate|up|down)$", name):
            spec = Spec(*([None] * (leaf.dim() - 3)), "model", None, None)
        if zero_pod:
            spec = _add_pod(spec, leaf)
        return _fit_to_shape(spec, leaf.shape, mesh)

    return _map_with_path(f, params)


def _add_pod(spec: Spec, leaf) -> Spec:
    """Fold the pod axis into the first already-sharded dim (making it a
    tuple axis) for big tensors; small tensors stay pod-replicated."""
    if leaf.numel() < (1 << 20):
        return spec
    parts = list(spec)
    for i, s in enumerate(parts):
        if s == "model":
            dim = leaf.shape[i]
            if dim % (16 * 2) == 0:
                parts[i] = ("pod", "model")
                return Spec(*parts)
    for i, s in enumerate(parts):
        if s == "data":
            dim = leaf.shape[i]
            if dim % (16 * 2) == 0:
                parts[i] = ("pod", "data")
                return Spec(*parts)
    return spec


def batch_specs(batch_tree: Any, dp_axes, mesh=None) -> Any:
    """Shard every batch leaf's leading (batch) dim over the data axes.
    Falls back to fewer/no axes when the batch doesn't divide (long_500k
    has global_batch=1, necessarily replicated)."""

    def f(leaf):
        axes = dp_axes
        if mesh is not None:
            b = leaf.shape[0]
            if b % _axis_size(mesh, axes) != 0:
                if isinstance(axes, tuple):  # try dropping the pod axis
                    for sub in (axes[1:], None):
                        if sub is None or b % _axis_size(mesh, tuple(sub)) == 0:
                            axes = tuple(sub) if sub else None
                            break
                else:
                    axes = None
        return Spec(axes, *([None] * (leaf.dim() - 1)))

    return tree_map(f, batch_tree)


def cache_specs(cache_tree: Any, cfg, dp_axes, mesh=None) -> Any:
    """KV / recurrent cache sharding for decode.

    Stacked KV caches are (L, B, S, KV, D): batch -> data axes, kv heads ->
    'model' when they divide the axis; otherwise model-replicated.
    Recurrent (mamba/xlstm) states are (stack..., B, ...): batch -> data.
    """

    def f(name, leaf):
        if re.search(r"(k_scale|v_scale)$", name) and leaf.dim() == 4:
            # int8-cache scales (L, B, S, KV): mirror the cache layout
            if leaf.shape[3] % 16 == 0:
                spec = Spec(None, dp_axes, None, "model")
            else:
                spec = Spec(None, dp_axes, "model", None)
            return _fit_to_shape(spec, leaf.shape, mesh)
        if re.search(r"(^|\.)(k|v|mem_k|mem_v)$", name) and leaf.dim() == 5:
            # (L, B, S, KV, D): shard kv heads over 'model' when they
            # divide; otherwise shard the cache length S, which keeps
            # 32k/500k caches of MQA/GQA<16 archs within memory.
            if leaf.shape[3] % 16 == 0:
                spec = Spec(None, dp_axes, None, "model", None)
            else:
                spec = Spec(None, dp_axes, "model", None, None)
        elif re.search(r"mem_mask$", name):
            spec = Spec(dp_axes, None)
        else:
            spec = _cache_state_spec(name, leaf, dp_axes)
        return _fit_to_shape(spec, leaf.shape, mesh)

    return _map_with_path(f, cache_tree)


def _cache_state_spec(name: str, leaf, dp_axes) -> Spec:
    # mamba: cache["mamba"]["conv"]: (nsuper, per, B, W, C) / ["state"]:
    # (nsuper, per, B, H, N, P).  xlstm similar.  encdec handled above.
    if re.search(r"mamba\.(conv|state)", name):
        if "state" in name:
            return Spec(None, None, dp_axes, "model", None, None)
        return Spec(None, None, dp_axes, None, "model")
    if re.search(r"mlstm\.(C|n|m|conv)", name):
        base = {"C": (None, None, dp_axes, "model", None, None),
                "n": (None, None, dp_axes, "model", None),
                "m": (None, None, dp_axes, "model"),
                "conv": (None, None, dp_axes, None, "model")}
        leafname = name.split(".")[-1]
        return Spec(*base[leafname])
    if re.search(r"slstm\.(c|n|h|m)$", name):
        return Spec(None, dp_axes, "model", None)
    return Spec(*([None] * leaf.dim()))


def dp_axes_for(mesh) -> Any:
    """Data-parallel axes for a mesh: ('pod', 'data') when multi-pod."""
    names = mesh.axis_names
    return ("pod", "data") if "pod" in names else "data"


# ---------------------------------------------------------------------------
# specs -> DTensor placements
# ---------------------------------------------------------------------------


class MeshAxes:
    """A mesh's axis sizes by name, the rules' view of it: a
    :class:`~torch.distributed.device_mesh.DeviceMesh`'s (``mesh_dim_names``
    and ``mesh.shape``), or given as a dict (a mesh that is never built,
    as the tests' fake meshes)."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)


def mesh_axes(mesh) -> MeshAxes:
    if isinstance(mesh, MeshAxes):
        return mesh
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        return MeshAxes(mesh)
    return MeshAxes(zip(names, mesh.mesh.shape))


def to_placements(spec, mesh) -> tuple:
    """The DTensor placements of ``spec`` on the DeviceMesh ``mesh``: one
    per mesh dim, ``Shard(i)`` where tensor dim ``i`` is sharded over that
    mesh dim, else ``Replicate()``.  A dim sharded over a tuple of axes
    (``("pod", "model")``) takes ``Shard(i)`` on each of them; their
    order in the tuple is the order of the mesh dims."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names
    out = [Replicate()] * len(names)
    for i, axis in enumerate(spec):
        if axis is None:
            continue
        for a in (axis if isinstance(axis, tuple) else (axis,)):
            out[names.index(a)] = Shard(i)
    return tuple(out)


def spec_bytes(tensors: Any, specs: Any, mesh) -> int:
    """The local bytes on one device of ``tensors`` (tensors, meta ones
    included) laid out by ``specs``: each leaf's bytes over the product of
    the mesh axes its spec shards it over."""
    axes = mesh_axes(mesh)
    total = [0]

    def f(t, spec):
        n = 1
        for axis in spec:
            n *= _axis_size(axes, axis)
        total[0] += t.numel() * t.element_size() // n

    tree_map(f, tensors, specs)
    return total[0]

