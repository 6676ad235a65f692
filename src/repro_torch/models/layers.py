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
    return params["table"][tokens.long()].to(compute_dtype)


def unembed(params: Params, x: Tensor, softcap: float = 0.0) -> Tensor:
    logits = x @ params["table"].t().to(x.dtype)
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    return logits


def cross_entropy(logits: Tensor, labels: Tensor,
                  mask: Optional[Tensor] = None) -> Tensor:
    """Mean token-level cross-entropy; logits (..., V), labels (...) int."""
    logits = logits.float()
    logz = torch.logsumexp(logits, -1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / mask.sum().clamp(min=1.0)
    return nll.mean()
