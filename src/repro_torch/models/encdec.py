"""Encoder-decoder backbone (seamless-m4t-medium style), in PyTorch.

The audio codec / mel frontend is a stub, as in the reference: the
encoder consumes precomputed frame embeddings ``(B, S_enc, d)``
(:func:`repro_torch.models.frontends.audio_frame_embeddings`).  Encoder
layers: non-causal self-attention + FFN.  Decoder layers: causal
self-attention + cross-attention over the encoder memory + FFN.  The
cross-attention K/V are computed once per sequence (prefill) into the
serve cache.

As the dense stack does, the port keeps the reference's layer-stacked
parameter tree (``{"encoder", "decoder"}``, every leaf ``(L, ...)``) and
walks it with Python loops; with ``cfg.remat`` and a gradient being
recorded, each encoder and decoder layer runs under
``torch.utils.checkpoint``.  The caches have real storage and are
written in place: the self-attention KV cache by :func:`decode_step`,
the memory K/V and mask by :func:`prefill_memory` (the reference
returns new arrays; ROADMAP C.14).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models import attention, layers, module, transformer

Tensor = torch.Tensor
Params = Dict[str, Any]


def init_encoder_layer(gen, cfg) -> Params:
    enc_ff = cfg.encdec.encoder_d_ff or cfg.d_ff
    dev = gen.device
    return {
        "ln1": layers.init_norm(cfg.d_model, cfg.norm, cfg.pdtype, dev),
        "attn": attention.init_attention(gen, cfg),
        "ln2": layers.init_norm(cfg.d_model, cfg.norm, cfg.pdtype, dev),
        "mlp": layers.init_mlp(gen, cfg.d_model, enc_ff, cfg.activation,
                               cfg, cfg.pdtype),
    }


def init_decoder_layer(gen, cfg) -> Params:
    dev = gen.device
    return {
        "ln1": layers.init_norm(cfg.d_model, cfg.norm, cfg.pdtype, dev),
        "self_attn": attention.init_attention(gen, cfg),
        "ln_x": layers.init_norm(cfg.d_model, cfg.norm, cfg.pdtype, dev),
        "cross_attn": attention.init_cross_attention(gen, cfg),
        "ln2": layers.init_norm(cfg.d_model, cfg.norm, cfg.pdtype, dev),
        "mlp": layers.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.activation,
                               cfg, cfg.pdtype),
    }


def init_encdec(gen, cfg) -> Params:
    return {
        "encoder": module.stacked_init(lambda g: init_encoder_layer(g, cfg),
                                       gen, cfg.encdec.num_encoder_layers),
        "decoder": module.stacked_init(lambda g: init_decoder_layer(g, cfg),
                                       gen, cfg.num_layers),
    }


def _encoder_layer(lp: Params, cfg, h: Tensor, cos, sin) -> Tensor:
    hs = layers.apply_norm(lp["ln1"], h, cfg.norm)
    h = h + attention.self_attention(lp["attn"], cfg, hs, cos, sin,
                                     causal=False)
    hm = layers.apply_norm(lp["ln2"], h, cfg.norm)
    return h + layers.apply_mlp(lp["mlp"], hm, cfg.activation)


def encode(params: Params, cfg, mem: Tensor, mem_mask: Optional[Tensor],
           cos, sin) -> Tensor:
    """Encoder over stub frame embeddings.  mem: (B, S_enc, d).  Like the
    reference's, it takes ``mem_mask`` and does not use it: every frame
    attends every frame (ROADMAP C.14)."""
    del mem_mask
    remat = cfg.remat and transformer._recording(params)
    for lp in transformer._unstack(params["encoder"]):
        mem = transformer._run(remat, _encoder_layer, lp, cfg, mem, cos, sin)
    return mem


def _decoder_layer(lp: Params, cfg, h: Tensor, memory: Tensor,
                   mem_mask: Optional[Tensor], cos, sin) -> Tensor:
    hs = layers.apply_norm(lp["ln1"], h, cfg.norm)
    h = h + attention.self_attention(lp["self_attn"], cfg, hs, cos, sin)
    hx = layers.apply_norm(lp["ln_x"], h, cfg.norm)
    mk, mv = attention.encode_memory(lp["cross_attn"], cfg, memory)
    h = h + attention.cross_attention(lp["cross_attn"], cfg, hx, mk, mv,
                                      mem_mask)
    hm = layers.apply_norm(lp["ln2"], h, cfg.norm)
    return h + layers.apply_mlp(lp["mlp"], hm, cfg.activation)


def decode_train(params: Params, cfg, x: Tensor, memory: Tensor,
                 mem_mask: Optional[Tensor], cos, sin) -> Tensor:
    """Teacher-forced decoder over the full target sequence x (B, S, d),
    each layer's cross K/V computed from ``memory``."""
    remat = cfg.remat and transformer._recording(params)
    for lp in transformer._unstack(params["decoder"]):
        x = transformer._run(remat, _decoder_layer, lp, cfg, x, memory,
                             mem_mask, cos, sin)
    return x


def init_encdec_cache(cfg, batch: int, max_len: int,
                      device=None) -> Dict[str, Any]:
    """Self-attention KV cache + per-layer cross-attention memory K/V,
    ``(L, B, encoder_seq, KV, D)`` in the compute type, and the memory's
    (B, encoder_seq) mask, all False until :func:`prefill_memory`."""
    L = cfg.num_layers
    Sm = cfg.encdec.encoder_seq
    shape = (L, batch, Sm, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {
        "self": transformer.init_kv_cache(cfg, batch, max_len,
                                          device=device),
        "mem_k": torch.zeros(shape, dtype=cfg.cdtype, device=device),
        "mem_v": torch.zeros(shape, dtype=cfg.cdtype, device=device),
        "mem_mask": torch.zeros((batch, Sm), dtype=torch.bool,
                                device=device),
    }


@torch.no_grad()
def prefill_memory(params: Params, cfg, memory: Tensor, mem_mask: Tensor,
                   cache: Dict[str, Any]) -> Dict[str, Any]:
    """Each decoder layer's cross K/V of the encoder output ``memory`` (B,
    S, d), written into the cache in place, with the mask.  A memory
    shorter than ``encoder_seq`` fills the leading rows; the rest stay
    masked.  Returns the cache."""
    S = memory.shape[1]
    if S > cache["mem_k"].shape[2]:
        raise ValueError(f"prefill_memory: {S} frames, the cache holds "
                         f"{cache['mem_k'].shape[2]}")
    cache["mem_mask"].zero_()
    cache["mem_mask"][:, :S] = mem_mask.to(cache["mem_mask"].device)
    for i, lp in enumerate(transformer._unstack(params["decoder"])):
        mk, mv = attention.encode_memory(lp["cross_attn"], cfg, memory)
        cache["mem_k"][i, :, :S] = mk.to(cache["mem_k"].dtype)
        cache["mem_v"][i, :, :S] = mv.to(cache["mem_v"].dtype)
    return cache


def decode_step(params: Params, cfg, x: Tensor, cache: Dict[str, Any],
                cache_len, cos, sin) -> Tuple[Tensor, Dict[str, Any]]:
    """One decoder token x (B, 1, d) with the cached self-attention KV
    (written in place at ``cache_len``) and the cached memory K/V."""
    self_k, self_v = cache["self"]["k"], cache["self"]["v"]
    for i, lp in enumerate(transformer._unstack(params["decoder"])):
        hs = layers.apply_norm(lp["ln1"], x, cfg.norm)
        so = attention.decode_self_attention(lp["self_attn"], cfg, hs,
                                             self_k[i], self_v[i],
                                             cache_len, cos, sin)[0]
        x = x + so
        hx = layers.apply_norm(lp["ln_x"], x, cfg.norm)
        x = x + attention.cross_attention(lp["cross_attn"], cfg, hx,
                                          cache["mem_k"][i],
                                          cache["mem_v"][i],
                                          cache["mem_mask"])
        hm = layers.apply_norm(lp["ln2"], x, cfg.norm)
        x = x + layers.apply_mlp(lp["mlp"], hm, cfg.activation)
    return x, cache
