"""Flash attention on Hopper: the blockwise streaming-softmax forward and,
for bf16, its backward.

``flash_attention`` launches the CUDA kernel (``csrc/flash_attention.cu``)
for tensors on a CUDA device and takes the plain PyTorch version
(:func:`_flash_math`) for tensors on the CPU.  Asked for it
(``with_lse``), the kernel also writes each row's log-sum-exp, which
``flash_attention_bwd`` (``csrc/flash_attention_bwd.cu``) rebuilds the
softmax from: dq, dk and dv of bf16 tensors on the card, from two kernels
with no atomics, so the same inputs give bitwise the same gradients.

Layout (the kernel's): q ``(BH, Sq, D)``, k/v ``(BKV, Sk, D)`` with
``BH = BKV * q_per_kv`` (GQA by index: query row ``b`` reads KV row
``b // q_per_kv``; K/V are never repeated).  Queries align to the end of
the keys (``q_offset = Sk - Sq``); masks are causal and sliding-window,
computed from positions, and, with ``kv_len`` ``(BKV,)``, KV row ``b``
has only its first ``kv_len[b]`` keys (the reference's ``valid_len``: an
encoder memory of ragged valid length under cross-attention).  A query
row that sees no key at all because of its count (``kv_len`` 0) gives
zeros, in the kernel and its plain version alike.  The kernel gives zeros,
and the backward zero gradients, to any row that sees no key (a causal
query before the first key when ``Sq > Sk``, a window wholly past the
count), where the plain version, with every score at -1e30, averages
all the keys.  Model-layout callers
go through :func:`repro_torch.kernels.ops.flash_attention`.

The reference's ``pallas_call`` is forward only, and so are these
wrappers: ``flash_attention`` raises when asked to record a gradient.
:func:`repro_torch.kernels.ops.flash_attention` makes attention
differentiable: for bf16 tensors on the card its backward is
``flash_attention_bwd``, for f32 or CPU tensors the gradient of
:func:`_flash_math` replayed under autograd.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import (DTYPE_CODES, check_operands, launch,
                                 no_grad_guard, use_kernel)
from repro_torch.kernels.decode_attention import MAX_HEAD_DIM, NEG_INF

Tensor = torch.Tensor


def attention_mask(sq: int, sk: int, causal: bool, window: int,
                   device=None) -> Tensor:
    """(Sq, Sk) bool: True where query i may see key j (queries aligned
    to the end of the keys)."""
    qpos = torch.arange(sq, device=device)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= qpos >= kpos
    if window > 0:
        mask &= (qpos - kpos) < window
    return mask


def _flash_math(q: Tensor, k: Tensor, v: Tensor, causal: bool = True,
                window: int = 0, q_per_kv: int = 1,
                kv_len: Optional[Tensor] = None) -> Tensor:
    """Plain version of the kernel: masked scores (-1e30) in f32,
    max-shifted exponentials, their f32 total; the exponentials rounded
    to v's type before the weighted sum (f32 accumulation), as the
    reference's kernel does (``p.astype(v.dtype)``), then divided by the
    total.  In f32 the rounding is a no-op.  With ``kv_len`` (BKV,), keys
    ``j >= kv_len[b]`` of KV row ``b`` are masked too, and a row whose
    count is 0 gives zeros."""
    BH, Sq, D = q.shape
    BKV, Sk, _ = k.shape
    qf = q.float().reshape(BKV, q_per_kv, Sq, D)
    s = torch.einsum("bgqd,bkd->bgqk", qf, k.float()) * (D ** -0.5)
    mask = attention_mask(Sq, Sk, causal, window, q.device)
    if kv_len is not None:
        n = kv_len.to(q.device)[:, None, None, None]
        mask = mask & (torch.arange(Sk, device=q.device) < n)
    s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    if kv_len is not None:  # no key at all: zeros, as the kernel
        p = p * (n > 0)
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bgqk,bkd->bgqd", p.to(v.dtype).float(), v.float())
    out = out / l.clamp(min=1e-30)
    return out.reshape(BH, Sq, D).to(q.dtype)


def _check_shapes(name: str, q: Tensor, k: Tensor, v: Tensor,
                  q_per_kv: int, window: int,
                  kv_len: Optional[Tensor]) -> None:
    BH, Sq, D = q.shape
    BKV, Sk, D2 = k.shape
    if D2 != D or tuple(v.shape) != (BKV, Sk, D) or BH != BKV * q_per_kv:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} disagree "
                         f"with q_per_kv={q_per_kv}")
    if window < 0:
        raise ValueError(f"{name}: window {window} < 0")
    if kv_len is not None and tuple(kv_len.shape) != (BKV,):
        raise ValueError(f"{name}: kv_len {tuple(kv_len.shape)} "
                         f"is not ({BKV},)")


def _check_card(name: str, q: Tensor, kv_len: Optional[Tensor]) -> None:
    if kv_len is not None:
        check_operands(name, (torch.int32,), kv_len=kv_len)
        if kv_len.device != q.device:
            raise ValueError(f"{name}: kv_len is on another device")
    if q.shape[-1] > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head_dim {q.shape[-1]} > {MAX_HEAD_DIM}")


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    window: int = 0, q_block: int = 128, kv_block: int = 128,
                    q_per_kv: int = 1, kv_len: Optional[Tensor] = None,
                    with_lse: bool = False):
    """q (BH, Sq, D); k/v (BKV, Sk, D); kv_len None or (BKV,) int ->
    (BH, Sq, D) in q's type; with ``with_lse`` (on the card only) the pair
    ``(out, lse)``, lse (BH, Sq) f32 each row's log-sum-exp of its masked,
    scaled scores (natural log), for :func:`flash_attention_bwd`.

    f32 or bf16; head_dim up to 256.  ``q_block`` and ``kv_block`` are
    accepted for signature parity with the reference; the kernel's tiling
    is its own.
    """
    del q_block, kv_block
    no_grad_guard("flash_attention", q, k, v)
    _check_shapes("flash_attention", q, k, v, q_per_kv, window, kv_len)
    if not use_kernel(q):
        if with_lse:
            raise ValueError("flash_attention: the row log-sum-exp is the "
                             "kernel's, on a CUDA device")
        return _flash_math(q, k, v, causal, window, q_per_kv, kv_len)
    check_operands("flash_attention", tuple(DTYPE_CODES), q=q, k=k, v=v)
    _check_card("flash_attention", q, kv_len)
    BH, Sq, D = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((BH, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    launch("flash_attention", (q, k, v, out, kv_len, lse), BH, Sq,
           k.shape[1], D, q_per_kv, int(causal), window,
           DTYPE_CODES[q.dtype])
    return (out, lse) if with_lse else out


def flash_attention_bwd(q: Tensor, k: Tensor, v: Tensor, out: Tensor,
                        dout: Tensor, lse: Tensor, *, causal: bool = True,
                        window: int = 0, q_per_kv: int = 1,
                        kv_len: Optional[Tensor] = None) -> tuple:
    """The gradient of :func:`flash_attention` for bf16 tensors on the
    card: q, out, dout (BH, Sq, D), k/v (BKV, Sk, D), lse (BH, Sq) f32
    (the forward's ``with_lse``), the forward's masks -> (dq, dk, dv) in
    the inputs' shapes and type.  One launch of two kernels: dq (and each
    row's delta = dout . out, in an f32 scratch), then dk and dv, GQA
    summed over each KV row's query heads in registers."""
    _check_shapes("flash_attention_bwd", q, k, v, q_per_kv, window, kv_len)
    check_operands("flash_attention_bwd", (torch.bfloat16,), q=q, k=k, v=v,
                   out=out, dout=dout)
    check_operands("flash_attention_bwd", (torch.float32,), lse=lse)
    _check_card("flash_attention_bwd", q, kv_len)
    BH, Sq, D = q.shape
    if out.shape != q.shape or dout.shape != q.shape or \
            tuple(lse.shape) != (BH, Sq) or lse.device != q.device:
        raise ValueError(f"flash_attention_bwd: out {tuple(out.shape)}, "
                         f"dout {tuple(dout.shape)}, lse "
                         f"{tuple(lse.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    delta = torch.empty_like(lse)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    launch("flash_attention_bwd",
           (q, k, v, out, dout, lse, delta, dq, dk, dv, kv_len), BH, Sq,
           k.shape[1], D, q_per_kv, int(causal), window,
           DTYPE_CODES[q.dtype])
    return dq, dk, dv
