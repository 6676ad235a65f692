"""Public wrappers over the port's kernels, in the model layer's layouts.

Each op takes the layouts :mod:`repro_torch.models` and
:mod:`repro_torch.fl.models` use and reaches a hand-written kernel for
tensors on a CUDA device, or its plain PyTorch version for tensors on the
CPU (the platform gate :func:`repro_torch.kernels.use_kernel`): the four
composition ops, ``flash_attention``, ``decode_attention``, ``ssd_chunk``
and ``rmsnorm``.  Oracles live in :mod:`repro_torch.kernels.ref`.

``flash_attention``, ``ssd_chunk`` and ``rmsnorm`` are differentiable,
so the model zoo trains through them: the forward runs the kernel (or,
on the CPU, its plain version) and the backward recomputes the plain
version and takes its gradient (:class:`_PlainBackward`).  The kernel
wrappers themselves stay forward-only, as the reference's
``pallas_call`` is, and raise under autograd.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.compose import (compose, compose_dense_apply,
                                         rank_dense_apply)
from repro_torch.kernels.conv_rank import conv_rank_apply
from repro_torch.kernels.decode_attention import (
    decode_attention as decode_attention_kernel)
from repro_torch.kernels.flash_attention import _flash_math
from repro_torch.kernels.flash_attention import (
    flash_attention as flash_attention_kernel)
from repro_torch.kernels.rmsnorm import _rmsnorm_math
from repro_torch.kernels.rmsnorm import rmsnorm as rmsnorm_kernel
from repro_torch.kernels.ssd_chunk import _ssd_math
from repro_torch.kernels.ssd_chunk import ssd_chunk as ssd_chunk_kernel

__all__ = [
    "compose", "rank_dense_apply", "conv_rank_apply", "compose_dense_apply",
    "flash_attention", "decode_attention", "ssd_chunk", "rmsnorm",
]

Tensor = torch.Tensor

# compose / rank_dense_apply / conv_rank_apply / compose_dense_apply are
# re-exported as they are: their signatures already speak the model
# layer's layout (basis (ksq, I, R), gathered coefficient blocks
# (m, R, O)) and they carry their own autograd Functions.


class _PlainBackward(torch.autograd.Function):
    """A forward-only kernel made differentiable: the forward calls the
    kernel wrapper ``kernel(*tensors, **kw)``; the backward recomputes
    its plain version ``plain(*tensors, **kw)`` under autograd and
    returns that version's gradient, as ``_ConvRank`` and ``_RankDense``
    pair a kernel forward with a plain backward.  The recomputation
    holds the plain version's intermediates (attention's whole score
    matrix) for the backward's duration."""

    @staticmethod
    def forward(ctx, kernel, plain, kw, *tensors):
        ctx.plain, ctx.kw = plain, kw
        ctx.save_for_backward(*tensors)
        return kernel(*tensors, **kw)

    @staticmethod
    def backward(ctx, grad):
        need = ctx.needs_input_grad[3:]
        tensors = [t.detach().requires_grad_(n)
                   for t, n in zip(ctx.saved_tensors, need)]
        with torch.enable_grad():
            out = ctx.plain(*tensors, **ctx.kw)
        grads = iter(torch.autograd.grad(
            out, [t for t in tensors if t.requires_grad], grad))
        return (None, None, None,
                *(next(grads) if n else None for n in need))


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    window: int = 0,
                    kv_len: Optional[Tensor] = None) -> Tensor:
    """Model layout: q (B, Sq, KV, G, D), k/v (B, Sk, KV, D) -> (B, Sq,
    KV, G, D); queries align to the end of the keys.  ``kv_len`` (B,)
    keeps batch row ``b`` to its first ``kv_len[b]`` keys (every KV head
    of the row: expanded to the kernel's (B * KV,) rows, as
    :func:`decode_attention` expands ``lengths``)."""
    B, Sq, KV, G, D = q.shape
    Sk = k.shape[1]
    qf = q.permute(0, 2, 3, 1, 4).reshape(B * KV * G, Sq, D).contiguous()
    kf = k.permute(0, 2, 1, 3).reshape(B * KV, Sk, D).contiguous()
    vf = v.permute(0, 2, 1, 3).reshape(B * KV, Sk, D).contiguous()
    kw = dict(causal=causal, window=window, q_per_kv=G)
    if kv_len is not None:
        kw["kv_len"] = torch.repeat_interleave(
            kv_len.to(device=q.device, dtype=torch.int32), KV)
    out = _PlainBackward.apply(flash_attention_kernel, _flash_math, kw, qf,
                               kf, vf)
    return out.reshape(B, KV, G, Sq, D).permute(0, 3, 1, 2, 4)


def decode_attention(q: Tensor, k_cache: Tensor, v_cache: Tensor,
                     lengths: Tensor) -> Tensor:
    """Model layout: q (B, 1, KV, G, D), caches (B, S, KV, D), lengths
    (B,) -> (B, 1, KV, G, D).  The kernel reads the caches as they are
    (no copy)."""
    B, _, KV, G, D = q.shape
    qf = q[:, 0].reshape(B * KV * G, D).contiguous()
    lens = torch.repeat_interleave(lengths.to(torch.int32), KV * G)
    out = decode_attention_kernel(qf, k_cache, v_cache, lens, q_per_kv=G)
    return out.reshape(B, 1, KV, G, D)


def ssd_chunk(cb: Tensor, bb: Tensor, xw: Tensor, cum: Tensor,
              h_in: Tensor, *, heads: int = 1) -> Tensor:
    """Mamba2 SSD intra-chunk block plus carry-in (the reference's
    layout): cb/bb (BCH, Q, N) replicated per head, xw (BCH, Q, P), cum
    (BCH, Q) f32, h_in (BCH, N, P) -> y (BCH, Q, P).  With ``heads > 1``
    cb/bb hold one row per group of ``heads`` rows instead
    (:func:`repro_torch.models.ssm.ssd_chunked` passes them so)."""
    return _PlainBackward.apply(ssd_chunk_kernel, _ssd_math,
                                dict(heads=heads), cb.contiguous(),
                                bb.contiguous(), xw.contiguous(),
                                cum.contiguous(), h_in.contiguous())


def rmsnorm(x: Tensor, scale: Tensor, *, eps: float = 1e-6) -> Tensor:
    """Fused RMSNorm: x (..., d), scale (d,) -> x's shape and type."""
    return _PlainBackward.apply(rmsnorm_kernel, _rmsnorm_math,
                                dict(eps=eps), x.contiguous(), scale)
