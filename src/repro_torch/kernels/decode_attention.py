"""Decode attention: one query per row over a ragged KV cache, on Hopper.

The serving hot spot: each generated token attends once over every cached
key of its head.  ``decode_attention`` launches the CUDA kernel
(``csrc/decode_attention.cu``) for tensors on a CUDA device and takes the
plain PyTorch version (:func:`_decode_math`) for tensors on the CPU.

Layout: q ``(BH, D)``; the caches either in the kernel layout
``(BKV, S, D)`` or in the model layout ``(B, S, KV, D)`` (read as they
are, never copied; the kernel layout is the model layout with ``KV = 1``),
with ``BH = B * KV * q_per_kv`` (GQA: query row ``(b * KV + kv) * G + g``
reads KV row ``(b, kv)``; the cache is never repeated), lengths ``(BH,)``.
The composed-transformer serving path (:func:`repro_torch.fl.transformer.
greedy_decode`) keeps its per-layer caches in the kernel layout; the zoo's
go through :func:`repro_torch.kernels.ops.decode_attention` in the model
layout.

The kernel splits each KV row's keys into :func:`split_plan`'s splits,
one block per (KV row, split) holding the row's whole query group, and
merges the splits' ``(m, l, acc)`` in split order; :func:`_split_math`
is that arithmetic in plain PyTorch.

Forward only, as the reference's ``pallas_call`` is: the wrapper raises
when asked to record a gradient.
"""

from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import (DTYPE_CODES, check_operands, launch,
                                 no_grad_guard, use_kernel)

Tensor = torch.Tensor

NEG_INF = -1e30
MAX_HEAD_DIM = 256
# the kernel's block: 16 query rows of a group, 64-key tiles; a split
# holds at least 256 keys, and the grid aims at 4 blocks per SM
GROUP_ROWS = 16
SPLIT_ALIGN = 64
MIN_SPLIT_KEYS = 256
BLOCKS_PER_SM = 4


def split_plan(row_blocks: int, S: int, sm_count: int) -> tuple:
    """(splits, chunk): split ``s`` of every KV row reads keys ``[s *
    chunk, (s + 1) * chunk)``.  Enough splits that ``row_blocks`` (KV rows
    times 16-row chunks of the group) times the splits cover the SMs
    ``BLOCKS_PER_SM`` times, none shorter than ``MIN_SPLIT_KEYS``; chunks
    are whole 64-key tiles."""
    want = -(-BLOCKS_PER_SM * sm_count // max(row_blocks, 1))
    most = max(1, -(-S // MIN_SPLIT_KEYS))
    splits = max(1, min(want, most))
    chunk = SPLIT_ALIGN * max(1, -(-S // (splits * SPLIT_ALIGN)))
    return max(1, -(-S // chunk)), chunk


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _kv_rows(k: Tensor) -> Tensor:
    """A cache as (BKV, S, D) rows: the model layout (B, S, KV, D)
    permuted (a copy, for the plain version on the CPU only)."""
    if k.dim() == 3:
        return k
    B, S, KV, D = k.shape
    return k.permute(0, 2, 1, 3).reshape(B * KV, S, D)


def _scores(q: Tensor, k: Tensor, lengths: Tensor, q_per_kv: int):
    """f32 scores (BKV, G, S) and their validity (keys below each row's
    length)."""
    BH, D = q.shape
    BKV, S, _ = k.shape
    qf = q.float().reshape(BKV, q_per_kv, D)
    s = torch.einsum("bgd,bsd->bgs", qf, k.float()) * (D ** -0.5)
    valid = (torch.arange(S, device=q.device)
             < lengths.reshape(BKV, q_per_kv, 1).clamp(max=S))
    return s, valid


def _decode_math(q: Tensor, k: Tensor, v: Tensor, lengths: Tensor,
                 q_per_kv: int = 1) -> Tensor:
    """Plain version of the kernel: f32 scores of the first
    ``lengths[b]`` keys, max-shifted exponentials and their f32 total;
    the exponentials rounded to v's type before the weighted sum (f32
    accumulation), as the reference's kernel does; keys past the length
    weigh nothing (a row of length 0 gives zeros, as the kernel)."""
    BH, D = q.shape
    s, valid = _scores(q, k, lengths, q_per_kv)
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bgs,bsd->bgd", p.to(v.dtype).float(), v.float())
    out = out / l.clamp(min=1e-30)
    return out.reshape(BH, D).to(q.dtype)


def _split_math(q: Tensor, k: Tensor, v: Tensor, lengths: Tensor,
                q_per_kv: int, splits: int, chunk: int) -> Tensor:
    """The kernel's split arithmetic in plain PyTorch: each split's keys
    give their own max ``m_s``, f32 total ``l_s`` and f32 sum ``acc_s`` of
    the exponentials (rounded to v's type) times v; the merge rescales
    each by ``exp(m_s - M)``, ``M`` the largest, and sums in split
    order.  A split with no valid key keeps ``m_s = -1e30``, ``l_s = 0``."""
    BH, D = q.shape
    S = k.shape[1]
    s, valid = _scores(q, k, lengths, q_per_kv)
    parts = []
    for i in range(splits):
        lo, hi = i * chunk, min(S, (i + 1) * chunk)
        ok = valid[..., lo:hi]
        si = torch.where(ok, s[..., lo:hi], NEG_INF)
        m = si.amax(-1, keepdim=True) if hi > lo else torch.full_like(
            s[..., :1], NEG_INF)
        p = torch.where(ok, torch.exp(si - m), 0.0)
        acc = torch.einsum("bgs,bsd->bgd", p.to(v.dtype).float(),
                           v[:, lo:hi].float())
        parts.append((m, p.sum(-1, keepdim=True), acc))
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    L = torch.zeros_like(M)
    A = torch.zeros((*M.shape[:-1], D), dtype=torch.float32, device=q.device)
    for m, l, acc in parts:
        w = torch.exp(m - M)
        L = L + l * w
        A = A + acc * w
    return (A / L.clamp(min=1e-30)).reshape(BH, D).to(q.dtype)


def decode_attention(q: Tensor, k: Tensor, v: Tensor, lengths: Tensor, *,
                     q_per_kv: int = 1) -> Tensor:
    """q (BH, D); k/v (BKV, S, D) or (B, S, KV, D); lengths (BH,) int ->
    (BH, D) in q's type.  f32 or bf16; head_dim up to 256."""
    no_grad_guard("decode_attention", q, k, v)
    BH, D = q.shape
    if k.dim() == 4:
        B, S, KV, D2 = k.shape
    else:
        (B, S, D2), KV = k.shape, 1
    if D2 != D or tuple(v.shape) != tuple(k.shape) \
            or BH != B * KV * q_per_kv or tuple(lengths.shape) != (BH,):
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, lengths "
                         f"{tuple(lengths.shape)} disagree with q_per_kv="
                         f"{q_per_kv}")
    if not use_kernel(q):
        return _decode_math(q, _kv_rows(k), _kv_rows(v), lengths, q_per_kv)
    check_operands("decode_attention", tuple(DTYPE_CODES), q=q, k=k, v=v)
    if D > MAX_HEAD_DIM:
        raise ValueError(f"decode_attention: head_dim {D} > {MAX_HEAD_DIM}")
    lens = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    splits, chunk = split_plan(B * KV * math.ceil(q_per_kv / GROUP_ROWS), S,
                               _sm_count(q.device))
    if splits > 1:
        part_ml = torch.empty((BH, splits, 2), dtype=torch.float32,
                              device=q.device)
        part_acc = torch.empty((BH, splits, D), dtype=torch.float32,
                               device=q.device)
    else:  # one split writes the output itself
        part_ml = part_acc = out
    launch("decode_attention", (q, k, v, lens, out, part_ml, part_acc), B, S,
           KV, q_per_kv, D, splits, chunk, DTYPE_CODES[q.dtype])
    return out
