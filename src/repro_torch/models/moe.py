"""Mixture-of-Experts FFN: top-k router + capacity-based GShard dispatch,
in PyTorch.

The baseline dispatch is the dense one-hot formulation (GShard /
Switch): a ``(T, E, C)`` combine tensor routes tokens to expert slots
through two einsums, and the experts' gated FFN is one batched product
per weight.  These are matrix products that the reference computes
outside any Pallas kernel, so they stay ``torch.einsum`` here.

Capacity: C = ceil(T * top_k * capacity_factor / E), rounded up to a
multiple of 4 (at least 4); tokens over capacity are dropped (the
residual passes through).  Priority within an expert is token order.
The aux load-balance loss follows Switch: E * sum_e f_e * p_e.

The top-k is a stable descending sort, so tied probabilities rank the
lower expert id first, as ``jax.lax.top_k`` does: the combine tensor
fills slots in that order.  As in the reference, :func:`apply_moe`
routes to the weight-stationary expert-parallel schedule
(:func:`repro_torch.models.moe_shardmap.apply_moe_shardmap`) when the
sharding context (:mod:`repro_torch.sharding.context`) holds a mesh and
sets ``moe_shardmap``; its aux loss is then 0, as the reference's.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import layers, module

Tensor = torch.Tensor
Params = Dict[str, Any]


def init_moe(gen, cfg, dtype) -> Params:
    """Router (f32 whatever ``dtype``), ``gate``/``up`` (E, d, d_expert),
    ``down`` (E, d_expert, d) and, with shared experts, a gated MLP of
    ``d_expert * num_shared_experts``.  The expert tensors are drawn in
    chunks (:func:`module.normal`), so a bf16 layer never holds an f32
    copy of itself."""
    m = cfg.moe
    d, de, E = cfg.d_model, m.d_expert, m.num_experts
    scale = 1.0 / math.sqrt(d)
    p: Params = {
        "router": {"w": module.normal(gen, (d, E), torch.float32, scale)},
        "gate": module.normal(gen, (E, d, de), dtype, scale),
        "up": module.normal(gen, (E, d, de), dtype, scale),
        "down": module.normal(gen, (E, de, d), dtype, 1.0 / math.sqrt(de)),
    }
    if m.num_shared_experts:
        p["shared"] = layers.init_mlp(gen, d, de * m.num_shared_experts,
                                      cfg.activation, cfg, dtype)
    return p


def capacity(tokens: int, cfg) -> int:
    m = cfg.moe
    c = math.ceil(tokens * m.top_k * m.capacity_factor / m.num_experts)
    return max(4, -(-c // 4) * 4)  # round up to a multiple of 4


def router_topk(router_params: Params, x2d: Tensor,
                cfg) -> Tuple[Tensor, Tensor, Tensor]:
    """x2d (..., T, d) -> (probs (..., T, E) f32, top-k gate values (...,
    T, k) renormalised to sum 1, top-k expert ids (..., T, k))."""
    logits = x2d.float() @ router_params["w"].float()
    probs = torch.softmax(logits, dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.moe.top_k
    gates, ids = vals[..., :k], ids[..., :k]
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    return probs, gates, ids


def make_combine(probs: Tensor, gates: Tensor, ids: Tensor, cfg,
                 cap: int) -> Tuple[Tensor, Tensor]:
    """GShard combine tensor (..., T, E, C) f32 and the Switch aux loss
    (...), over any leading group axes.  Slot by slot of the top-k, a
    token takes the next free position of its expert; past ``cap`` it is
    dropped.  A token's k experts are distinct, so each (t, e) entry gets
    at most one gate value."""
    *lead, T, E = probs.shape
    k = cfg.moe.top_k
    counts = torch.zeros((*lead, 1, E), dtype=torch.int64,
                         device=probs.device)
    combine = torch.zeros((*lead, T, E * cap), dtype=torch.float32,
                          device=probs.device)
    for slot in range(k):  # static small loop over top-k slots
        e = ids[..., slot]  # (..., T)
        onehot = F.one_hot(e, E)  # (..., T, E)
        pos = onehot.cumsum(-2) - 1 + counts  # (..., T, E)
        pos_t = pos.gather(-1, e[..., None])[..., 0]  # (..., T)
        keep = pos_t < cap
        index = e * cap + pos_t.clamp(max=cap - 1)
        combine = combine.scatter_add(
            -1, index[..., None], (gates[..., slot] * keep)[..., None])
        counts = counts + (onehot * keep[..., None]).sum(-2, keepdim=True)
    # Switch aux loss: E * sum_e (token fraction) * (mean prob)
    frac = F.one_hot(ids[..., 0], E).float().mean(-2)
    aux = E * (frac * probs.mean(-2)).sum(-1)
    return combine.reshape(*lead, T, E, cap), aux


def expert_ffn(params: Params, cfg, xec: Tensor) -> Tensor:
    """Per-expert gated FFN on dispatched tokens.  xec: (..., E, C, d)."""
    g = torch.einsum("...ecd,edf->...ecf", xec, params["gate"].to(xec.dtype))
    u = torch.einsum("...ecd,edf->...ecf", xec, params["up"].to(xec.dtype))
    if cfg.activation == "geglu":
        h = F.gelu(g, approximate="tanh") * u
    else:
        h = F.silu(g) * u
    return torch.einsum("...ecf,efd->...ecd", h,
                        params["down"].to(xec.dtype))


def _moe_group(params, cfg, xg: Tensor,
               experts: slice = None) -> Tuple[Tensor, Tensor]:
    """Dispatch groups (GShard 'group').  xg: (..., T, d), one group per
    leading index (the reference vmaps this over its groups).  With
    ``experts``, ``params`` holds only those experts' tensors and the
    output is their part of the sum over experts (the aux loss is the
    whole one)."""
    cap = capacity(xg.shape[-2], cfg)
    probs, gates, ids = router_topk(params["router"], xg, cfg)
    combine, aux = make_combine(probs, gates, ids, cfg, cap)
    if experts is not None:
        combine = combine[..., experts, :]
    dispatch = (combine > 0).to(xg.dtype)  # (..., T, E, C)
    xec = torch.einsum("...tec,...td->...ecd", dispatch, xg)
    yec = expert_ffn(params, cfg, xec)
    y = torch.einsum("...tec,...ecd->...td", combine.to(xg.dtype), yec)
    return y, aux


def _grouped(x: Tensor) -> bool:
    """The reference's grouping rule: one dispatch group per batch row
    when the sequence is long (S >= 512) and there are several rows,
    else one group over all B*S tokens.  Capacity, and so the outputs,
    depend on it."""
    B, S, _ = x.shape
    return S >= 512 and B > 1


def apply_moe(params: Params, cfg, x: Tensor) -> Tuple[Tensor, Tensor]:
    """x: (B, S, d) -> (y, aux_loss * router_aux_weight)."""
    B, S, d = x.shape
    from repro_torch.sharding.context import get_context
    ctx = get_context()
    if ctx["moe_shardmap"] and ctx["mesh"] is not None:
        from repro_torch.models.moe_shardmap import apply_moe_shardmap
        y = apply_moe_shardmap(params, cfg, x, ctx["mesh"])
        return y, torch.zeros((), dtype=torch.float32, device=x.device)
    if ops.is_dtensor(x):
        y, aux = _moe_on_mesh(params, cfg, x)
    elif _grouped(x):
        y, aux = _moe_group(params, cfg, x)
        aux = aux.mean()
    else:
        y, aux = _moe_group(params, cfg, x.reshape(B * S, d))
        y = y.reshape(B, S, d)
    if "shared" in params:
        y = y + layers.apply_mlp(params["shared"], x, cfg.activation)
    return y, aux * cfg.moe.router_aux_weight


def _moe_on_mesh(params: Params, cfg, x: Tensor) -> Tuple[Tensor, Tensor]:
    """The GShard dispatch on a device mesh, each rank on its local
    shards: every rank routes the tokens of its groups (the batch rows
    over the data-parallel axes when grouped, else all B*S tokens: the
    capacity and the token priority are the group's) and runs its
    resident experts (E over ``"model"`` where it divides); the partial
    outputs are summed over ``"model"``.  Returns (y, aux) as
    :func:`apply_moe` takes them (the aux loss not yet weighted)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    B, S, d = x.shape
    E = cfg.moe.num_experts
    n_model = mesh.mesh.shape[names.index("model")]
    split = E % n_model == 0
    E_loc = E // n_model if split else E
    grouped = _grouped(x)
    xp = (ops._placements(mesh, (ops._dp(mesh), None, None), x.shape)
          if grouped else (Replicate(),) * len(names))
    whole = (Replicate(),) * len(names)
    ep = tuple(Shard(0) if split and a == "model" else Replicate()
               for a in names)
    yp = tuple(Partial() if split and a == "model" else p
               for a, p in zip(names, xp))
    # every model rank computes the whole aux loss: rank 0 of "model"
    # gives it and the others zeros, summed over "model", so that its
    # gradient is counted once
    ap = yp if grouped else tuple(Partial() if split and a == "model"
                                  else Replicate() for a in names)

    def body(router_w, gate, up, down, xl):
        j = mesh.get_local_rank("model") if split else 0
        p = {"router": {"w": router_w}, "gate": gate, "up": up,
             "down": down}
        experts = slice(j * E_loc, (j + 1) * E_loc)
        if grouped:
            y, aux = _moe_group(p, cfg, xl, experts)
        else:
            y, aux = _moe_group(p, cfg, xl.reshape(B * S, d), experts)
            y = y.reshape(B, S, d)
        return y, aux * (j == 0)

    y, aux = ops._on_shards(body, mesh, (yp, ap),
                            (whole, ep, ep, ep, xp), params["router"]["w"],
                            params["gate"], params["up"], params["down"], x)
    return y, (aux.mean() if grouped else aux)


# ---------------------------------------------------------------------------
# sort-based dispatch (the reference's perf variant)
# ---------------------------------------------------------------------------


def apply_moe_sorted(params: Params, cfg,
                     x: Tensor) -> Tuple[Tensor, Tensor]:
    """Gather/scatter dispatch: sort token-slots by expert, segment the
    sorted buffer into fixed-capacity expert bins, run the same expert
    FFN, scatter back.  The same math as :func:`apply_moe` on kept tokens
    (same capacity rule, same priority order = token index), grouped as
    it is."""
    B, S, d = x.shape
    if _grouped(x):
        outs = [_moe_sorted_group(params, cfg, xg) for xg in x.unbind(0)]
        y = torch.stack([o[0] for o in outs])
        aux = torch.stack([o[1] for o in outs]).mean()
    else:
        y, aux = _moe_sorted_group(params, cfg, x.reshape(B * S, d))
        y = y.reshape(B, S, d)
    if "shared" in params:
        y = y + layers.apply_mlp(params["shared"], x, cfg.activation)
    return y, aux * cfg.moe.router_aux_weight


def _moe_sorted_group(params: Params, cfg,
                      x2d: Tensor) -> Tuple[Tensor, Tensor]:
    T, d = x2d.shape
    k, E = cfg.moe.top_k, cfg.moe.num_experts
    cap = capacity(T, cfg)
    dev = x2d.device
    probs, gates, ids = router_topk(params["router"], x2d, cfg)
    flat_e = ids.reshape(-1)  # (T*k,) expert of each slot, slot-major
    flat_g = gates.reshape(-1)
    flat_tok = torch.arange(T, device=dev).repeat_interleave(k)
    # priority: lower token index first within an expert (GShard's cumsum
    # order); a stable sort by expert keeps token order within experts
    order = torch.argsort(flat_e, stable=True)
    se, sg, st = flat_e[order], flat_g[order], flat_tok[order]
    starts = torch.searchsorted(se, torch.arange(E, device=dev))
    pos = torch.arange(T * k, device=dev) - starts[se]
    keep = pos < cap
    slot_idx = torch.where(keep, se * cap + pos, E * cap)  # overflow bin
    xbuf = torch.zeros((E * cap + 1, d), dtype=x2d.dtype, device=dev)
    xbuf = xbuf.index_put((slot_idx,), torch.where(keep[:, None], x2d[st],
                                                   0))
    yec = expert_ffn(params, cfg, xbuf[:-1].reshape(E, cap, d))
    ybuf = yec.reshape(E * cap, d)
    contrib = torch.where(keep[:, None],
                          ybuf[slot_idx.clamp(max=E * cap - 1)], 0)
    y = torch.zeros((T, d), dtype=x2d.dtype, device=dev).index_add(
        0, st, contrib * sg[:, None].to(x2d.dtype))
    frac = F.one_hot(ids[:, 0], E).float().mean(0)
    aux = E * (frac * probs.mean(0)).sum()
    return y, aux
