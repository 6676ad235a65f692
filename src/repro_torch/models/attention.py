"""Attention: RoPE and a chunked streaming-softmax attention, in PyTorch.

Layouts (the JAX package's):
  q           (B, S, KV, G, D)   G = q heads per kv head (GQA groups)
  k, v        (B, S, KV, D)

:func:`flash_attention` is the training and prefill path: a loop over
query chunks and, inside it, over KV chunks with a running max and sum,
so the (S x S) score matrix never materialises.  It is plain PyTorch and
differentiable by autograd, as the reference's scan is; the forward-only
CUDA kernel with the same schedule is
:func:`repro_torch.kernels.flash_attention.flash_attention`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

Tensor = torch.Tensor
NEG_INF = -1e30


def rope_angles(positions: Tensor, head_dim: int,
                theta: float) -> Tuple[Tensor, Tensor]:
    """cos/sin for plain RoPE.  positions (..., S) int -> (..., S, D/2)."""
    half = head_dim // 2
    inv = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                  device=positions.device) / half)
    ang = positions.to(torch.float32)[..., None] * inv
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
