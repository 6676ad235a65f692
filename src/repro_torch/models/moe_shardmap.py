"""Expert-parallel MoE over a grid of devices, with the JAX package's
explicit collective schedule (its ``shard_map`` formulation):

  * tokens are split over the grid's **data** axis (its rows) and
    replicated over its **model** axis (its columns);
  * experts are split over the model axis: ``E / |model|`` resident on
    each column's device (weight-stationary);
  * each device routes its tokens, runs ONLY its resident experts on the
    capacity-bounded subset of tokens that chose them
    (:func:`_local_expert_pass`), and one fold of the per-expert partial
    outputs over the model axis combines them (the ``psum``), in column
    order on the row's first device.

The grid is a 2-D sequence of devices, ``grid[i][j]`` for data shard
``i`` and model shard ``j``; a device may repeat (logical shards of one
device, as :func:`repro_torch.sharding.fl.logical_devices` makes them).
Or it is a ``torch.distributed`` DeviceMesh with ``"data"`` and
``"model"`` axes (and maybe ``"pod"``), on which each rank runs its part
on its local shards (``local_map``) and the fold over ``"model"`` is a
reduction of the partial outputs; :func:`repro_torch.models.moe.apply_moe`
routes here when the sharding context sets ``moe_shardmap``, as the
JAX package's does.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Sequence

import torch
import torch.nn.functional as F

from repro_torch.core.aggregation import fold_shards
from repro_torch.models import layers
from repro_torch.models.moe import router_topk

Tensor = torch.Tensor
Params = Dict[str, Any]


def _local_expert_pass(x2: Tensor, gates: Tensor, ids: Tensor,
                       gate_w: Tensor, up_w: Tensor, down_w: Tensor,
                       e_base: int, E_loc: int, cap: int,
                       activation: str) -> Tensor:
    """Run the resident experts ``[e_base, e_base + E_loc)`` on their
    tokens.

    x2 (T, d); gates/ids (T, k); expert weights (E_loc, d, f) / (E_loc,
    f, d).  Returns the partial output (T, d) covering only the resident
    experts; a token past an expert's capacity (token-index priority)
    gets nothing from it.
    """
    T, d = x2.shape
    k = ids.shape[1]
    dev = x2.device
    flat_e = ids.reshape(-1)
    flat_gate = gates.reshape(-1)
    flat_tok = torch.arange(T, device=dev).repeat_interleave(k)
    loc = flat_e - e_base
    mine = (loc >= 0) & (loc < E_loc)
    loc = torch.where(mine, loc, torch.full_like(loc, E_loc))  # sink bucket
    # position within the local expert by stable order (token priority)
    order = torch.argsort(loc, stable=True)
    sloc, stok, sgate = loc[order], flat_tok[order], flat_gate[order]
    starts = torch.searchsorted(sloc, torch.arange(E_loc + 1, device=dev))
    pos = torch.arange(T * k, device=dev) - starts[sloc]
    keep = (sloc < E_loc) & (pos < cap)
    buf = torch.where(keep, sloc * cap + pos,
                      torch.full_like(sloc, E_loc * cap))
    xbuf = torch.zeros((E_loc * cap + 1, d), dtype=x2.dtype, device=dev)
    xbuf = xbuf.index_put((buf,), torch.where(keep[:, None], x2[stok], 0))
    xe = xbuf[:-1].reshape(E_loc, cap, d)
    g = torch.einsum("ecd,edf->ecf", xe, gate_w.to(x2.dtype))
    u = torch.einsum("ecd,edf->ecf", xe, up_w.to(x2.dtype))
    if activation == "geglu":
        h = F.gelu(g, approximate="tanh") * u
    else:
        h = F.silu(g) * u
    ye = torch.einsum("ecf,efd->ecd", h,
                      down_w.to(x2.dtype)).reshape(E_loc * cap, d)
    contrib = torch.where(keep[:, None],
                          ye[buf.clamp(max=E_loc * cap - 1)]
                          * sgate[:, None].to(ye.dtype), 0)
    return torch.zeros((T, d), dtype=x2.dtype, device=dev).index_add(
        0, torch.where(keep, stok, torch.zeros_like(stok)),
        contrib.to(x2.dtype))


def apply_moe_shardmap(params: Params, cfg, x: Tensor,
                       grid: Sequence[Sequence[torch.device]]) -> Tensor:
    """x: (B, S, d), B divisible by the grid's rows; the expert count
    divisible by its columns.  Returns y (B, S, d) on ``x``'s device
    (the MoE output without an aux loss, as in the JAX package)."""
    if hasattr(grid, "mesh_dim_names"):
        return _on_mesh(params, cfg, x, grid)
    m = cfg.moe
    E = m.num_experts
    n_data, n_model = len(grid), len(grid[0])
    if E % n_model:
        raise ValueError(f"{E} experts do not divide over {n_model} "
                         "model shards")
    B, S, d = x.shape
    if B % n_data:
        raise ValueError(f"batch {B} does not divide over {n_data} data "
                         "shards")
    E_loc, B_loc = E // n_model, B // n_data
    rows = []
    for i, row in enumerate(grid):
        partials = []
        for j, dev in enumerate(row):
            x2 = x[i * B_loc:(i + 1) * B_loc].to(dev).reshape(B_loc * S, d)
            T = x2.shape[0]
            cap = max(4, -(-math.ceil(T * m.top_k * m.capacity_factor / E)
                           // 4) * 4)
            _, gates, ids = router_topk(
                {"w": params["router"]["w"].to(dev)}, x2, cfg)
            experts = slice(j * E_loc, (j + 1) * E_loc)
            partials.append(_local_expert_pass(
                x2, gates, ids, params["gate"][experts].to(dev),
                params["up"][experts].to(dev),
                params["down"][experts].to(dev), j * E_loc, E_loc, cap,
                cfg.activation))
        rows.append(fold_shards(partials).reshape(B_loc, S, d).to(x.device))
    y = torch.cat(rows)
    if "shared" in params:
        y = y + layers.apply_mlp(params["shared"], x, cfg.activation)
    return y


def _on_mesh(params: Params, cfg, x: Tensor, mesh) -> Tensor:
    """:func:`apply_moe_shardmap` on a DeviceMesh: tokens over ``"data"``
    (whole over the other axes), the router whole, each expert tensor's E
    over ``"model"`` and whatever other axes hold it split already (the
    "pod" axis of ``zero_pod``: its shards are never gathered); each rank
    routes its tokens and runs its resident experts, and the partial
    outputs are summed over the expert axes (the reference's ``psum``)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.kernels.ops import _on_shards, is_dtensor
    m = cfg.moe
    E = m.num_experts
    names = mesh.mesh_dim_names
    held = (params["gate"].placements if is_dtensor(params["gate"])
            else ())
    axes = [i for i, p in enumerate(held)
            if isinstance(p, Shard) and p.dim == 0]
    if names.index("model") not in axes:
        axes = sorted(axes + [names.index("model")])
    n_exp = math.prod(mesh.mesh.shape[i] for i in axes)
    if E % n_exp:
        raise ValueError(f"{E} experts do not divide over {n_exp} shards "
                         f"of {[names[i] for i in axes]}")
    E_loc = E // n_exp
    whole = tuple(Replicate() for _ in names)
    experts = tuple(Shard(0) if i in axes else Replicate()
                    for i in range(len(names)))
    tokens = tuple(Shard(0) if a == "data" and i not in axes
                   else Replicate() for i, a in enumerate(names))
    out = tuple(Partial() if i in axes else p for i, p in enumerate(tokens))

    def body(router_w, gate_w, up_w, down_w, xs):
        B_loc, S, d = xs.shape
        x2 = xs.reshape(B_loc * S, d)
        T = x2.shape[0]
        cap = max(4, -(-math.ceil(T * m.top_k * m.capacity_factor / E)
                       // 4) * 4)
        _, gates, ids = router_topk({"w": router_w}, x2, cfg)
        j = 0  # this rank's block of experts, the axes in mesh order
        for i in axes:
            j = j * mesh.mesh.shape[i] + mesh.get_local_rank(names[i])
        y = _local_expert_pass(x2, gates, ids, gate_w, up_w, down_w,
                               j * E_loc, E_loc, cap, cfg.activation)
        return y.reshape(B_loc, S, d)

    y = _on_shards(body, mesh, out, (whole, experts, experts, experts,
                                     tokens),
                   params["router"]["w"], params["gate"], params["up"],
                   params["down"], x)
    y = y.redistribute(mesh, tokens)
    if "shared" in params:
        y = y + layers.apply_mlp(params["shared"], x, cfg.activation)
    return y
