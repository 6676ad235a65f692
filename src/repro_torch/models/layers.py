"""Norms, MLPs, embeddings — shared across the zoo's families.

The ``rmsnorm`` norm goes through :func:`repro_torch.kernels.ops.rmsnorm`
(the hand-written kernel on a CUDA tensor, its plain version on the
CPU); ``layernorm`` stays plain PyTorch.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import module

Tensor = torch.Tensor
Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# normalisation
# ---------------------------------------------------------------------------


def init_norm(d: int, kind: str, dtype, device=None) -> Params:
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def apply_norm(params: Params, x: Tensor, kind: str,
               eps: float = 1e-6) -> Tensor:
    if kind == "rmsnorm":
        return ops.rmsnorm(x, params["scale"], eps=eps)
    if ops.is_dtensor(x):
        # each rank normalises its own rows whole, as rmsnorm does (the
        # card's torch plans var's backward on a 2x16x16 mesh with a
        # redistribution it does not support)
        from torch.distributed.tensor import Replicate
        xp = ops._rows_placements(x)
        whole = (Replicate(),) * len(xp)
        return ops._on_shards(
            lambda xl, sl, bl: apply_norm({"scale": sl, "bias": bl}, xl,
                                          kind, eps),
            x.device_mesh, xp, (xp, whole, whole), x, params["scale"],
            params["bias"])
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * params["scale"].float() + params["bias"].float()
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (gated + plain)
# ---------------------------------------------------------------------------


def init_mlp(gen, d: int, d_ff: int, activation: str, cfg, dtype) -> Params:
    p = {}
    if activation in ("swiglu", "geglu"):
        p["gate"] = module.maybe_factorized(gen, d, d_ff, cfg, dtype)
    p["up"] = module.maybe_factorized(gen, d, d_ff, cfg, dtype)
    p["down"] = module.maybe_factorized(gen, d_ff, d, cfg, dtype)
    return p


def apply_mlp(params: Params, x: Tensor, activation: str) -> Tensor:
    if activation == "swiglu":
        h = F.silu(module.linear(params["gate"], x)) * module.linear(
            params["up"], x)
    elif activation == "geglu":
        h = F.gelu(module.linear(params["gate"], x),
                   approximate="tanh") * module.linear(params["up"], x)
    else:  # gelu
        h = F.gelu(module.linear(params["up"], x), approximate="tanh")
    return module.linear(params["down"], h)


def mlp_flops(d: int, d_ff: int, activation: str, tokens: int) -> int:
    """FLOPs of the MLP's products over ``tokens`` rows (2 per MAC)."""
    n = 3 if activation in ("swiglu", "geglu") else 2
    return 2 * n * d * d_ff * tokens


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------


def embed(params: Params, tokens: Tensor, compute_dtype) -> Tensor:
    if ops.is_dtensor(params["table"]):
        return _embed_on_shards(params["table"], tokens, compute_dtype)
    return params["table"][tokens.long()].to(compute_dtype)


def _embed_on_shards(table, tokens, compute_dtype):
    """:func:`embed` on a device mesh: each rank looks its token rows up
    in the whole table (gathered), so that no index op of DTensor's (whose
    backward some torch versions cannot place) is recorded."""
    from torch.distributed.tensor import Replicate

    mesh = table.device_mesh
    tp = ops._placements(mesh, (ops._dp(mesh),), tokens.shape)
    return ops._on_shards(
        lambda t, ids: t[ids.long()].to(compute_dtype), mesh, tp,
        ((Replicate(),) * mesh.ndim, tp), table, tokens)


def unembed(params: Params, x: Tensor, softcap: float = 0.0) -> Tensor:
    logits = x @ params["table"].t().to(x.dtype)
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    return logits


def cross_entropy(logits: Tensor, labels: Tensor,
                  mask: Optional[Tensor] = None) -> Tensor:
    """Mean token-level cross-entropy; logits (..., V), labels (...) int.
    On a device mesh the vocab may stay sharded (:func:`_nll_on_shards`)."""
    if ops.is_dtensor(logits):
        nll = _nll_on_shards(logits, labels)
        if mask is not None:
            mask = mask.float()
            return (nll * mask).sum() / mask.sum().clamp(min=1.0)
        return nll.mean()
    logits = logits.float()
    logz = torch.logsumexp(logits, -1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / mask.sum().clamp(min=1.0)
    return nll.mean()


def _nll_on_shards(logits, labels):
    """Token NLL of DTensor logits (B, S, V) without gathering the vocab:
    each rank takes the log-sum-exp of its vocab slice and the gold logit
    where the label falls in it; the slices' log-sum-exps are combined
    and the gold logits summed over ``"model"``."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = logits.device_mesh
    names = mesh.mesh_dim_names
    dp = ops._dp(mesh)
    lp = ops._placements(mesh, (dp, None, "model"), logits.shape)
    split = any(isinstance(p, Shard) and p.dim == 2 for p in lp)
    bp = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
               for p in lp)
    lse_p = tuple(Shard(2) if split and a == "model" else p
                  for a, p in zip(names, bp))
    gold_p = tuple(Partial() if split and a == "model" else p
                   for a, p in zip(names, bp))

    def local(lg, lb):
        lg = lg.float()
        v0 = mesh.get_local_rank("model") * lg.shape[-1] if split else 0
        idx = lb.long() - v0
        inside = (idx >= 0) & (idx < lg.shape[-1])
        gold = torch.gather(lg, -1, idx.clamp(0, lg.shape[-1] - 1)[..., None])
        return (torch.logsumexp(lg, -1)[..., None],
                torch.where(inside, gold[..., 0], 0.0))

    lse, gold = ops._on_shards(local, mesh, (lse_p, gold_p), (lp, bp),
                               logits, labels)
    return torch.logsumexp(lse, -1) - gold
