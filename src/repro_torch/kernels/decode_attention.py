"""Decode attention: one query per row over a ragged KV cache, on Hopper.

The serving hot spot: each generated token attends once over every cached
key of its head.  ``decode_attention`` launches the CUDA kernel
(``csrc/decode_attention.cu``) for tensors on a CUDA device and takes the
plain PyTorch version (:func:`_decode_math`) for tensors on the CPU.

Layout (the kernel's): q ``(BH, D)``, k/v ``(BKV, S, D)`` with
``BH = BKV * q_per_kv`` (GQA: query row ``b`` reads KV row
``b // q_per_kv``; the cache is never repeated), lengths ``(BH,)``.  The
composed-transformer serving path (:func:`repro_torch.fl.transformer.
greedy_decode`) keeps its per-layer caches in this layout.  Model-layout
callers go through :func:`repro_torch.kernels.ops.decode_attention`.

Forward only, as the reference's ``pallas_call`` is: the wrapper raises
when asked to record a gradient.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import (DTYPE_CODES, check_operands, launch,
                                 no_grad_guard, use_kernel)

Tensor = torch.Tensor

NEG_INF = -1e30
MAX_HEAD_DIM = 256


def _decode_math(q: Tensor, k: Tensor, v: Tensor, lengths: Tensor,
                 q_per_kv: int = 1) -> Tensor:
    """Plain version of the kernel, in f32: scores of the first
    ``lengths[b]`` keys, softmax, weighted sum; keys past the length
    weigh nothing (a row of length 0 gives zeros, as the kernel)."""
    BH, D = q.shape
    BKV, S, _ = k.shape
    qf = q.float().reshape(BKV, q_per_kv, D)
    s = torch.einsum("bgd,bsd->bgs", qf, k.float()) * (D ** -0.5)
    valid = (torch.arange(S, device=q.device)
             < lengths.reshape(BKV, q_per_kv, 1).clamp(max=S))
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bgs,bsd->bgd", p, v.float()) / l.clamp(min=1e-30)
    return out.reshape(BH, D).to(q.dtype)


def decode_attention(q: Tensor, k: Tensor, v: Tensor, lengths: Tensor, *,
                     q_per_kv: int = 1) -> Tensor:
    """q (BH, D); k/v (BKV, S, D); lengths (BH,) int -> (BH, D) in q's
    type.  f32 or bf16; head_dim up to 256."""
    no_grad_guard("decode_attention", q, k, v)
    BH, D = q.shape
    BKV, S, D2 = k.shape
    if D2 != D or tuple(v.shape) != (BKV, S, D) or BH != BKV * q_per_kv \
            or tuple(lengths.shape) != (BH,):
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, lengths "
                         f"{tuple(lengths.shape)} disagree with q_per_kv="
                         f"{q_per_kv}")
    if not use_kernel(q):
        return _decode_math(q, k, v, lengths, q_per_kv)
    check_operands("decode_attention", tuple(DTYPE_CODES), q=q, k=k, v=v)
    if D > MAX_HEAD_DIM:
        raise ValueError(f"decode_attention: head_dim {D} > {MAX_HEAD_DIM}")
    lens = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    launch("decode_attention", (q, k, v, lens, out), BH, S, D, q_per_kv,
           DTYPE_CODES[q.dtype])
    return out
