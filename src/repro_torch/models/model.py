"""Unified model API over the zoo's families, in PyTorch.

Functions keyed off ``cfg.family``, mirroring the reference's:

  init(seed, cfg, device)                          -> params
  forward(params, cfg, batch)                      -> (logits, aux_loss)
  loss_fn(params, cfg, batch)                      -> (loss, metrics)
  init_cache(cfg, batch, max_len, device)          -> cache
  prefill(params, cfg, batch, cache)               -> (logits, cache)
  serve_step(params, cfg, batch, cache, cache_len) -> (logits, cache)

The port runs the ``hybrid`` family (zamba2) so far; the others raise
``NotImplementedError`` (ROADMAP A11).  ``init`` and ``init_cache`` run
on the CUDA card unless given ``device="cpu"``.  The SSD-chunk, RMSNorm
and attention kernels are forward-only, so this is the serving and
evaluation path: call it under ``torch.no_grad()``.

Batch keys: ``tokens`` (B, S) int; for ``loss_fn`` also ``labels``
(B, S) and optionally ``loss_mask`` (B, S).  Positions count from 0 in
``forward`` and are ``cache_len`` in ``serve_step``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.models import attention, layers, module, transformer

Tensor = torch.Tensor
Params = Dict[str, Any]


def _require_hybrid(cfg) -> None:
    if cfg.family != "hybrid" or cfg.encdec is not None:
        raise NotImplementedError(
            f"the {cfg.family} family is not ported (ROADMAP A11); the "
            "port runs the hybrid family (zamba2-2.7b)")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init(seed: int, cfg, device=None) -> Params:
    """Random parameters from ``seed``, drawn on ``device`` (the CUDA card
    unless given ``device="cpu"``) by a generator living there."""
    _require_hybrid(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(dev).manual_seed(seed)
    p: Params = {
        "embed": module.init_embedding(gen, cfg.vocab, cfg.d_model,
                                       cfg.pdtype),
        "final_norm": layers.init_norm(cfg.d_model, cfg.norm, cfg.pdtype,
                                       dev),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = module.init_embedding(gen, cfg.vocab, cfg.d_model,
                                             cfg.pdtype)
    p["stack"] = transformer.init_hybrid_stack(gen, cfg)
    return p


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------


def _unembed(params, cfg, x: Tensor) -> Tensor:
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return layers.unembed(table, x, cfg.logit_softcap)


# ---------------------------------------------------------------------------
# forward (full sequence)
# ---------------------------------------------------------------------------


def forward(params: Params, cfg,
            batch: Dict[str, Tensor]) -> Tuple[Tensor, Tensor]:
    _require_hybrid(cfg)
    x = layers.embed(params["embed"], batch["tokens"], cfg.cdtype)
    B, S, _ = x.shape
    pos = attention.default_positions(B, S, device=x.device)
    cos, sin = attention.angles_for(cfg, pos)
    x, aux = transformer.apply_hybrid(params["stack"], cfg, x, cos, sin)
    x = layers.apply_norm(params["final_norm"], x, cfg.norm)
    return _unembed(params, cfg, x), aux


def loss_fn(params: Params, cfg,
            batch: Dict[str, Tensor]) -> Tuple[Tensor, Dict[str, Tensor]]:
    logits, aux = forward(params, cfg, batch)
    ce = layers.cross_entropy(logits, batch["labels"], batch.get("loss_mask"))
    return ce + aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------


def init_cache(cfg, batch: int, max_len: int, device=None) -> Dict[str, Any]:
    """Zeroed decode caches on ``device`` (the CUDA card unless given
    ``device="cpu"``)."""
    _require_hybrid(cfg)
    return transformer.init_hybrid_cache(cfg, batch, max_len,
                                         resolve_device(device))


def prefill(params: Params, cfg, batch: Dict[str, Tensor],
            cache: Optional[Dict[str, Any]] = None
            ) -> Tuple[Tensor, Optional[Dict[str, Any]]]:
    """Full-sequence forward.  As in the reference, the cache is handed
    back as it came: KV-cache write-back during prefill is modelled as
    the forward pass."""
    logits, _ = forward(params, cfg, batch)
    return logits, cache


def serve_step(params: Params, cfg, batch: Dict[str, Tensor],
               cache: Dict[str, Any], cache_len
               ) -> Tuple[Tensor, Dict[str, Any]]:
    """One new token given a populated cache.  batch["tokens"]: (B, 1);
    ``cache_len`` (an int) tokens are already in the cache, which is
    updated in place and returned."""
    _require_hybrid(cfg)
    x = layers.embed(params["embed"], batch["tokens"], cfg.cdtype)
    pos = torch.full((x.shape[0], 1), int(cache_len), dtype=torch.int32,
                     device=x.device)
    cos, sin = attention.angles_for(cfg, pos)
    x, cache = transformer.decode_hybrid(params["stack"], cfg, x, cache,
                                         cache_len, cos, sin)
    x = layers.apply_norm(params["final_norm"], x, cfg.norm)
    return _unembed(params, cfg, x), cache
