"""Unified model API over the zoo's families, in PyTorch.

Functions keyed off ``cfg.family``, mirroring the reference's:

  init(seed, cfg, device)                          -> params
  forward(params, cfg, batch, skip_blocks)         -> (logits, aux_loss)
  loss_fn(params, cfg, batch, skip_blocks)         -> (loss, metrics)
  init_cache(cfg, batch, max_len, device)          -> cache
  prefill(params, cfg, batch, cache)               -> (logits, cache)
  serve_step(params, cfg, batch, cache, cache_len) -> (logits, cache)

The port runs every family of the zoo: ``dense`` (gemma-2b,
stablelm-3b, deepseek-coder-33b, granite-34b), ``moe`` (olmoe-1b-7b,
kimi-k2-1t-a32b), ``ssm`` (xlstm-125m), ``vlm`` (qwen2-vl-7b, M-RoPE; its
vision tower is the reference's stub: the batch may carry patch
``embeddings``), ``hybrid`` (zamba2) and ``audio`` (seamless-m4t-medium,
an encoder-decoder over stub frame embeddings, :mod:`.encdec`), with
sliding-window attention and, for the decoder-only attention stacks, the
int8 KV cache.  ``init`` and ``init_cache`` run on the CUDA card unless
given ``device="cpu"``.  The RMSNorm, SSD-chunk and attention kernels are
forward-only; ``kernels.ops`` gives them the backward of their plain
versions (attention in bf16: its backward kernel pair), so ``loss_fn``
trains and serving launches them alike.  The
MoE layers' router aux loss reaches ``loss_fn`` through ``forward``.

Batch keys: ``tokens`` (B, S) int, or ``embeddings`` (B, S, d) in their
place; optionally ``positions`` (B, S), or (B, 3, S) (t, h, w) ids for
M-RoPE; for the audio family ``enc_embeddings`` (B, S_enc, d) and
optionally ``enc_mask`` (B, S_enc) bool; for ``loss_fn`` also ``labels``
(B, S) and optionally ``loss_mask`` (B, S).  Positions count from 0 in
``forward`` and are ``cache_len`` in ``serve_step`` (all three ids, for
M-RoPE).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.models import (attention, encdec, layers, module,
                                transformer)
from repro_torch.sharding.context import constrain_logits, constrain_residual

Tensor = torch.Tensor
Params = Dict[str, Any]

def _is_encdec(cfg) -> bool:
    return cfg.family == "audio" or cfg.encdec is not None


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init(seed: int, cfg, device=None) -> Params:
    """Random parameters from ``seed``, drawn on ``device`` (the CUDA card
    unless given ``device="cpu"``) by a generator living there."""
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
    if _is_encdec(cfg):
        p["stack"] = encdec.init_encdec(gen, cfg)
    elif cfg.family == "hybrid":
        p["stack"] = transformer.init_hybrid_stack(gen, cfg)
    elif cfg.family == "ssm":
        p["stack"] = transformer.init_xlstm_stack(gen, cfg)
    else:  # dense / moe / vlm
        p["stack"] = transformer.init_stack(gen, cfg)
    return p


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _rounded(value: float, dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python float."""
    return float(torch.tensor(value, dtype=dtype))


def _input_embeddings(params, cfg, batch) -> Tensor:
    if "embeddings" in batch:
        return batch["embeddings"].to(cfg.cdtype)
    x = layers.embed(params["embed"], batch["tokens"], cfg.cdtype)
    if cfg.arch_id.startswith("gemma"):  # gemma scales embeddings by sqrt(d)
        # the scale is rounded to the compute type first, as the
        # reference's jnp.asarray(d**0.5, cdtype); a Python float then
        # multiplies on the device without a host-to-device copy
        x = x * _rounded(cfg.d_model ** 0.5, cfg.cdtype)
    return x


def _positions(cfg, batch, seq: int, batchsize: int, device):
    if "positions" in batch:
        return batch["positions"]
    pos = attention.default_positions(batchsize, seq, device=device)
    if cfg.rope_type == "mrope":  # text: t, h and w ids all equal
        return pos[:, None, :].expand(pos.shape[0], 3, seq)
    return pos


def _unembed(params, cfg, x: Tensor) -> Tensor:
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return constrain_logits(layers.unembed(table, x, cfg.logit_softcap))


def _encode(params, cfg, batch) -> Tuple[Tensor, Optional[Tensor]]:
    """The enc-dec encoder over the batch's ``enc_embeddings``: (memory,
    the batch's ``enc_mask`` or None)."""
    mem = batch["enc_embeddings"].to(cfg.cdtype)
    enc_pos = attention.default_positions(mem.shape[0], mem.shape[1],
                                          device=mem.device)
    ecos, esin = attention.angles_for(cfg, enc_pos)
    mem_mask = batch.get("enc_mask")
    return (encdec.encode(params["stack"], cfg, mem, mem_mask, ecos, esin),
            mem_mask)


def _decode_train(params, cfg, batch, memory, mem_mask) -> Tensor:
    """The enc-dec decoder over the batch's tokens, then the final norm
    and the unembedding."""
    x = constrain_residual(_input_embeddings(params, cfg, batch))
    B, S, _ = x.shape
    cos, sin = attention.angles_for(cfg, _positions(cfg, batch, S, B,
                                                    x.device))
    x = encdec.decode_train(params["stack"], cfg, x, memory, mem_mask, cos,
                            sin)
    x = layers.apply_norm(params["final_norm"], x, cfg.norm)
    return _unembed(params, cfg, x)


# ---------------------------------------------------------------------------
# forward (train / eval, full sequence)
# ---------------------------------------------------------------------------


def forward(params: Params, cfg, batch: Dict[str, Tensor],
            skip_blocks: bool = False) -> Tuple[Tensor, Tensor]:
    """Logits over the full sequence, and the aux loss.  ``skip_blocks``
    has the CPU's chunked softmax skip the KV chunks that causality or
    the window mask entirely (the same logits, fewer FLOPs); on a CUDA
    tensor the flash-attention kernel skips such tiles whatever it
    says."""
    if _is_encdec(cfg):
        memory, mem_mask = _encode(params, cfg, batch)
        return (_decode_train(params, cfg, batch, memory, mem_mask),
                torch.zeros((), dtype=torch.float32, device=memory.device))
    x = constrain_residual(_input_embeddings(params, cfg, batch))
    B, S, _ = x.shape
    if cfg.family == "ssm":  # xLSTM: no attention, no positions
        x, aux = transformer.apply_xlstm(params["stack"], cfg, x)
    else:
        pos = _positions(cfg, batch, S, B, x.device)
        cos, sin = attention.angles_for(cfg, pos)
        stack = (transformer.apply_hybrid if cfg.family == "hybrid"
                 else transformer.apply_stack)
        x, aux = stack(params["stack"], cfg, x, cos, sin, skip_blocks)
    x = layers.apply_norm(params["final_norm"], x, cfg.norm)
    return _unembed(params, cfg, x), aux


def loss_fn(params: Params, cfg, batch: Dict[str, Tensor],
            skip_blocks: bool = False) -> Tuple[Tensor, Dict[str, Tensor]]:
    logits, aux = forward(params, cfg, batch, skip_blocks)
    ce = layers.cross_entropy(logits, batch["labels"], batch.get("loss_mask"))
    return ce + aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------


def init_cache(cfg, batch: int, max_len: int, device=None) -> Dict[str, Any]:
    """Zeroed decode caches on ``device`` (the CUDA card unless given
    ``device="cpu"``); with a sliding window the KV cache is a ring of
    ``min(max_len, window)`` slots.  The xLSTM's recurrent state does not
    grow with ``max_len``."""
    dev = resolve_device(device)
    if _is_encdec(cfg):
        return encdec.init_encdec_cache(cfg, batch, max_len, dev)
    cache_len = (min(max_len, cfg.sliding_window) if cfg.sliding_window
                 else max_len)
    if cfg.family == "hybrid":
        return transformer.init_hybrid_cache(cfg, batch, cache_len, dev)
    if cfg.family == "ssm":
        return transformer.init_xlstm_cache(cfg, batch, dev)
    return transformer.init_kv_cache(cfg, batch, cache_len, device=dev)


def prefill(params: Params, cfg, batch: Dict[str, Tensor],
            cache: Optional[Dict[str, Any]] = None
            ) -> Tuple[Tensor, Optional[Dict[str, Any]]]:
    """Full-sequence forward.  As in the reference, the cache is handed
    back as it came: KV-cache write-back during prefill is modelled as
    the forward pass.  An enc-dec model also encodes the memory and,
    given a cache, writes each layer's cross K/V and the mask into it in
    place (:func:`encdec.prefill_memory`); ``enc_mask`` defaults to all
    frames."""
    if _is_encdec(cfg):
        memory, mem_mask = _encode(params, cfg, batch)
        if mem_mask is None:
            mem_mask = torch.ones(memory.shape[:2], dtype=torch.bool,
                                  device=memory.device)
        if cache is not None:
            cache = encdec.prefill_memory(params["stack"], cfg, memory,
                                          mem_mask, cache)
        return _decode_train(params, cfg, batch, memory, mem_mask), cache
    logits, _ = forward(params, cfg, batch)
    return logits, cache


def serve_step(params: Params, cfg, batch: Dict[str, Tensor],
               cache: Dict[str, Any], cache_len
               ) -> Tuple[Tensor, Dict[str, Any]]:
    """One new token given a populated cache.  batch["tokens"]: (B, 1);
    ``cache_len`` (an int) tokens are already in the cache, which is
    updated in place and returned."""
    x = constrain_residual(_input_embeddings(params, cfg, batch))
    if cfg.family == "ssm":
        x, cache = transformer.decode_xlstm(params["stack"], cfg, x, cache)
    else:
        pos = batch.get("positions")
        if pos is None:
            shape = ((x.shape[0], 3, 1) if cfg.rope_type == "mrope"
                     else (x.shape[0], 1))
            pos = torch.full(shape, int(cache_len), dtype=torch.int32,
                             device=x.device)
        cos, sin = attention.angles_for(cfg, pos)
        decode = (encdec.decode_step if _is_encdec(cfg)
                  else transformer.decode_hybrid if cfg.family == "hybrid"
                  else transformer.decode_stack)
        x, cache = decode(params["stack"], cfg, x, cache, cache_len, cos,
                          sin)
    x = layers.apply_norm(params["final_norm"], x, cfg.norm)
    return _unembed(params, cfg, x), cache
