"""Attention: RoPE, chunked streaming-softmax attention, KV-cache decode.

Layouts (the JAX package's):
  q           (B, S, KV, G, D)   G = q heads per kv head (GQA groups)
  k, v        (B, S, KV, D)
  kv cache    (B, Smax, KV, D)   keys stored *post-RoPE*

:func:`flash_attention` is the training and prefill path: a loop over
query chunks and, inside it, over KV chunks with a running max and sum,
so the (S x S) score matrix never materialises.  It is plain PyTorch and
differentiable by autograd, as the reference's scan is; the forward-only
CUDA kernel with the same schedule is
:func:`repro_torch.kernels.flash_attention.flash_attention`.

The attention block of the model zoo (:func:`self_attention`,
:func:`decode_self_attention`) runs on a CUDA tensor through the two
forward-only kernels (``kernels.ops.flash_attention`` and
``kernels.ops.decode_attention``) and on the CPU through the plain
:func:`flash_attention` and :func:`decode_attention` here, with
sliding-window attention (a ring-buffer cache of ``window`` slots in
decode) and the int8 KV cache (per-token-per-head scales).  Positions
rotate by RoPE or, for qwen2-vl, by M-RoPE (:func:`mrope_angles`: (t, h,
w) position ids, one per frequency section).  The audio family's
encoder runs :func:`self_attention` without the causal mask, and its
decoder's :func:`cross_attention` attends over a precomputed encoder
memory (:func:`encode_memory`) of ragged valid length: one query row
through the decode kernel, more through the flash kernel with a key
count a row.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops, use_kernel
from repro_torch.models import module
from repro_torch.sharding.context import constrain_attention_q, write_slot

Tensor = torch.Tensor
Params = Dict[str, Any]
NEG_INF = -1e30


def rope_angles(positions: Tensor, head_dim: int,
                theta: float) -> Tuple[Tensor, Tensor]:
    """cos/sin for plain RoPE.  positions (..., S) int -> (..., S, D/2)."""
    half = head_dim // 2
    inv = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                  device=positions.device) / half)
    ang = positions.to(torch.float32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def mrope_angles(positions: Tensor, head_dim: int, theta: float,
                 sections: Tuple[int, int, int]) -> Tuple[Tensor, Tensor]:
    """Multimodal RoPE (Qwen2-VL): positions (B, 3, S) — (t, h, w) ids.

    Frequency slot i takes its position id from the section it belongs
    to; sections sum to head_dim//2.  Returns cos/sin (B, S, D/2)."""
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {sections} != head_dim/2 {half}")
    dev = positions.device
    inv = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                  device=dev) / half)
    sec_id = torch.cat([torch.full((s,), i, dtype=torch.long, device=dev)
                        for i, s in enumerate(sections)])  # (half,)
    # gather per-frequency positions: (B, 3, S) -> (B, S, half)
    pos = positions.index_select(1, sec_id).transpose(-1, -2)
    ang = pos.to(torch.float32) * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rotary(x: Tensor, cos: Tensor, sin: Tensor) -> Tensor:
    """Rotate-half convention.  x (B, S, H, D); cos/sin (B|1, S, D/2)."""
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    c = cos[..., None, :].to(x.dtype)  # (B, S, 1, D/2)
    s = sin[..., None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    window: int = 0, q_chunk: int = 2048,
                    kv_chunk: int = 1024,
                    valid_len: Optional[Tensor] = None,
                    skip_masked_blocks: bool = False) -> Tensor:
    """Streaming-softmax attention.

    Args:
      q: (B, Sq, KV, G, D);  k/v: (B, Sk, KV, D).
      causal: causal mask with q positions aligned to the *end* of k.
      window: sliding-window size (0 = full).
      q_chunk, kv_chunk: chunk sizes, clamped to the sequence lengths.
      valid_len: optional (B,) — mask out k positions >= valid_len.
      skip_masked_blocks: skip KV chunks that causality or the window
        mask entirely (same output, fewer FLOPs).

    Returns (B, Sq, KV, G, D) in q's type.
    """
    B, Sq, KV, G, D = q.shape
    Sk = k.shape[1]
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Sk)
    scale = D ** -0.5
    q_offset = Sk - Sq  # causal alignment (q last token attends to k last)
    outs = []
    for q0 in range(0, Sq, q_chunk):
        qc = q[:, q0:q0 + q_chunk]
        nq = qc.shape[1]
        qpos = torch.arange(q0, q0 + nq, device=q.device) + q_offset
        m = torch.full((B, KV, G, nq), NEG_INF, device=q.device)
        l = torch.zeros((B, KV, G, nq), device=q.device)
        acc = torch.zeros((B, KV, G, nq, D), device=q.device)
        for k0 in range(0, Sk, kv_chunk):
            k_hi = min(k0 + kv_chunk, Sk)
            if skip_masked_blocks:
                if causal and k0 > q0 + nq - 1 + q_offset:
                    continue  # entirely in the future
                if window > 0 and (q0 + q_offset) - (k_hi - 1) >= window:
                    continue  # entirely out of the window
            kc, vc = k[:, k0:k_hi], v[:, k0:k_hi]
            kpos = torch.arange(k0, k_hi, device=q.device)
            s = torch.einsum("bqhgd,bkhd->bhgqk", qc.float(),
                             kc.float()) * scale
            mask = torch.ones((nq, k_hi - k0), dtype=torch.bool,
                              device=q.device)
            if causal:
                mask &= qpos[:, None] >= kpos[None, :]
            if window > 0:
                mask &= (qpos[:, None] - kpos[None, :]) < window
            maskb = mask[None, None, None]
            if valid_len is not None:
                vl = valid_len.to(q.device)[:, None, None, None, None]
                maskb = maskb & (kpos[None, None, None, None, :] < vl)
            s = torch.where(maskb, s, NEG_INF)
            # the running max only stabilises the exponentials: the result
            # does not depend on it, so it carries no gradient
            m_new = torch.maximum(m, s.amax(-1)).detach()
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(vc.dtype).float(),
                              vc.float())
            acc = acc * corr[..., None] + pv
            m = m_new
        out = acc / l.clamp(min=1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4))  # (B, nq, KV, G, D)
    return torch.cat(outs, dim=1).to(q.dtype)


def default_positions(batch: int, seq: int, offset=0,
                      device=None) -> Tensor:
    """(1, seq) int32 positions starting at ``offset``."""
    return (torch.arange(seq, dtype=torch.int32, device=device)[None, :]
            + int(offset))


def angles_for(cfg, positions: Tensor) -> Tuple[Tensor, Tensor]:
    """positions: (B, S) for rope, (B, 3, S) for mrope."""
    d = cfg.resolved_head_dim
    if cfg.rope_type == "mrope":
        return mrope_angles(positions, d, cfg.rope_theta,
                            cfg.mrope_sections)
    return rope_angles(positions, d, cfg.rope_theta)


def decode_attention(q: Tensor, k_cache: Tensor, v_cache: Tensor,
                     valid_mask: Tensor) -> Tensor:
    """One-token attention over a KV cache, plain.

    q: (B, 1, KV, G, D); caches (B, S, KV, D); valid_mask (B, S) bool.
    """
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.float(),
                     k_cache.float()) * (q.shape[-1] ** -0.5)
    s = torch.where(valid_mask[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# attention block (projections + cache plumbing)
# ---------------------------------------------------------------------------


def init_attention(gen, cfg, d_model: Optional[int] = None) -> Params:
    d = d_model or cfg.d_model
    hd = cfg.resolved_head_dim
    return {
        "wq": module.maybe_factorized(gen, d, cfg.num_heads * hd, cfg,
                                      cfg.pdtype),
        "wk": module.maybe_factorized(gen, d, cfg.num_kv_heads * hd, cfg,
                                      cfg.pdtype),
        "wv": module.maybe_factorized(gen, d, cfg.num_kv_heads * hd, cfg,
                                      cfg.pdtype),
        "wo": module.maybe_factorized(gen, cfg.num_heads * hd, d, cfg,
                                      cfg.pdtype),
    }


def qkv(params: Params, cfg, x: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    KV, G = cfg.num_kv_heads, cfg.q_per_kv
    q = module.linear(params["wq"], x).reshape(B, S, KV, G, hd)
    k = module.linear(params["wk"], x).reshape(B, S, KV, hd)
    v = module.linear(params["wv"], x).reshape(B, S, KV, hd)
    return q, k, v


def _rotate(cfg, q: Tensor, k: Tensor, cos: Tensor, sin: Tensor):
    if cfg.rope_type == "none":
        return q, k
    B, S = q.shape[:2]
    qf = q.reshape(B, S, -1, q.shape[-1])
    return (apply_rotary(qf, cos, sin).reshape(q.shape),
            apply_rotary(k, cos, sin))


def self_attention(params: Params, cfg, x: Tensor, cos: Tensor,
                   sin: Tensor, *, causal: bool = True,
                   skip_masked_blocks: bool = False) -> Tensor:
    """Full-sequence self attention (train / prefill), windowed by
    ``cfg.sliding_window``: the flash-attention kernel on a CUDA tensor
    (which skips masked tiles by itself), the plain chunked softmax on
    the CPU."""
    B, S, _ = x.shape
    q, k, v = qkv(params, cfg, x)
    q, k = _rotate(cfg, q, k, cos, sin)
    q, k, v = constrain_attention_q(q, k, v)
    if use_kernel(x) or ops.is_dtensor(x):  # a mesh: kernels on shards
        out = ops.flash_attention(q, k, v, causal=causal,
                                  window=cfg.sliding_window)
    else:
        out = flash_attention(q, k, v, causal=causal,
                              window=cfg.sliding_window,
                              q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
                              skip_masked_blocks=skip_masked_blocks)
    out = out.reshape(B, S, cfg.num_heads * cfg.resolved_head_dim)
    return module.linear(params["wo"], out)


def _quantize_kv(t: Tensor) -> Tuple[Tensor, Tensor]:
    """Per-token-per-head int8 quantization.  t (B, 1, KV, D) -> (int8
    values, (B, 1, KV) f32 scales).  ``torch.round`` rounds half to even,
    as ``jnp.round`` does."""
    tf = t.float()
    scale = (tf.abs().amax(-1) / 127.0).clamp(min=1e-8)
    q = torch.clamp(torch.round(tf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def decode_self_attention(params: Params, cfg, x: Tensor, cache_k: Tensor,
                          cache_v: Tensor, cache_len: int, cos: Tensor,
                          sin: Tensor, cache_scales=None):
    """One-token decode step.

    x: (B, 1, d); caches (B, Smax, KV, D); ``cache_len`` (an int) tokens
    are already in the cache.  The new key and value are written *in
    place* (the reference returns updated copies) into slot ``cache_len``,
    or, with ``cfg.sliding_window > 0``, slot ``cache_len % Smax`` of a
    ring of ``Smax`` slots.  The query attends over the first ``min(
    cache_len, Smax - 1) + 1`` slots with a window (every written slot),
    ``cache_len + 1`` without: exactly the reference's ``valid`` prefix,
    which on a CUDA tensor is the decode-attention kernel's lengths.

    With ``cache_scales = (k_scale, v_scale)``, each (B, Smax, KV) f32,
    the caches are int8 with per-token-per-head scales: the new entries
    are quantized and written in place with their scales, and the whole
    cache is dequantized to ``cfg.cdtype`` for the attention, as the
    reference does.

    Returns (out, cache_k, cache_v[, cache_scales]).
    """
    B = x.shape[0]
    Smax = cache_k.shape[1]
    t = int(cache_len)
    slot = t % Smax if cfg.sliding_window > 0 else t
    n = min(t, Smax - 1) + 1 if cfg.sliding_window > 0 else t + 1
    q, k, v = qkv(params, cfg, x)
    q, k = _rotate(cfg, q, k, cos, sin)
    if cache_scales is not None:
        k_scale, v_scale = cache_scales
        kq, ks = _quantize_kv(k)
        vq, vs = _quantize_kv(v)
        for cache, val in ((cache_k, kq), (k_scale, ks), (cache_v, vq),
                           (v_scale, vs)):
            write_slot(cache, slot, val[:, 0])
        k_full = cache_k.to(cfg.cdtype) * k_scale[..., None].to(cfg.cdtype)
        v_full = cache_v.to(cfg.cdtype) * v_scale[..., None].to(cfg.cdtype)
    else:
        write_slot(cache_k, slot, k[:, 0].to(cache_k.dtype))
        write_slot(cache_v, slot, v[:, 0].to(cache_v.dtype))
        k_full, v_full = cache_k, cache_v
    if use_kernel(x) or ops.is_dtensor(x):
        lengths = torch.full((B,), n, dtype=torch.int32, device=x.device)
        out = ops.decode_attention(q, k_full, v_full, lengths)
    else:
        valid = (torch.arange(Smax, device=x.device) < n)[None, :]
        out = decode_attention(q, k_full, v_full, valid.expand(B, Smax))
    out = out.reshape(B, 1, cfg.num_heads * cfg.resolved_head_dim)
    out = module.linear(params["wo"], out)
    if cache_scales is not None:
        return out, cache_k, cache_v, cache_scales
    return out, cache_k, cache_v


# ---------------------------------------------------------------------------
# cross-attention (the audio family's encoder-decoder)
# ---------------------------------------------------------------------------


def init_cross_attention(gen, cfg) -> Params:
    """Cross-attention projections: q from the decoder, k/v precomputed
    from the memory."""
    return init_attention(gen, cfg)


def encode_memory(params: Params, cfg, mem: Tensor) -> Tuple[Tensor,
                                                             Tensor]:
    """Cross-attention K/V of the encoder output ``mem`` (B, Sm, d):
    each (B, Sm, KV, D)."""
    B, Sm, _ = mem.shape
    hd = cfg.resolved_head_dim
    k = module.linear(params["wk"], mem).reshape(B, Sm, cfg.num_kv_heads,
                                                 hd)
    v = module.linear(params["wv"], mem).reshape(B, Sm, cfg.num_kv_heads,
                                                 hd)
    return k, v


def cross_attention(params: Params, cfg, x: Tensor, mem_k: Tensor,
                    mem_v: Tensor, mem_mask: Optional[Tensor] = None
                    ) -> Tensor:
    """Decoder cross-attention over precomputed memory K/V.

    x (B, Sq, d); mem_k/mem_v (B, Sm, KV, D); mem_mask (B, Sm) bool, all
    True when None.  No RoPE on cross-attention (the seamless
    convention).  The mask is read as its per-row count of valid frames,
    the leading ones (ROADMAP C.14): the reference's ``valid_len`` at
    ``Sq > 1``, and at ``Sq == 1`` the mask itself, which is the same on
    a prefix mask.  On a CUDA tensor ``Sq == 1`` launches the decode
    kernel with the counts as lengths and ``Sq > 1`` the flash kernel,
    non-causal, with the counts as ``kv_len``; on the CPU the plain
    :func:`decode_attention` and :func:`flash_attention` take the same
    counts.
    """
    B, Sq, _ = x.shape
    hd = cfg.resolved_head_dim
    KV, G = cfg.num_kv_heads, cfg.q_per_kv
    q = module.linear(params["wq"], x).reshape(B, Sq, KV, G, hd)
    Sm = mem_k.shape[1]
    if mem_mask is None:
        counts = torch.full((B,), Sm, dtype=torch.int32, device=x.device)
    else:
        counts = mem_mask.to(x.device).sum(-1, dtype=torch.int32)
    if use_kernel(x) or ops.is_dtensor(x):
        if Sq == 1:
            out = ops.decode_attention(q, mem_k, mem_v, counts)
        else:
            out = ops.flash_attention(q, mem_k, mem_v, causal=False,
                                      kv_len=counts)
    elif Sq == 1:
        valid = torch.arange(Sm, device=x.device)[None, :] < counts[:, None]
        out = decode_attention(q, mem_k, mem_v, valid)
    else:
        out = flash_attention(q, mem_k, mem_v, causal=False,
                              q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
                              valid_len=counts)
    out = out.reshape(B, Sq, cfg.num_heads * hd)
    return module.linear(params["wo"], out)
