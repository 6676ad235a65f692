"""Plain PyTorch oracles for the ported kernels (the allclose targets).

Deliberately naive — the simplest correct formulation of each op — for
the parity tests and ``chip_smoke.py``.  Layouts follow the JAX package:
NHWC activations and HWIO-ordered ``(ksq, I, O)`` weights; attention in
the kernels' ``(BH, S, D)`` rows with one KV row per query row.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.conv_rank import _same_conv


def compose_ref(basis: torch.Tensor, coeff: torch.Tensor) -> torch.Tensor:
    """Neural-composition product (paper Eq. 4, pre-reshape).

    basis (ksq, I, R) x coeff (m, R, O) -> (ksq, I, m*O), with an optional
    leading client axis on both operands.
    """
    inter = torch.einsum("...kir,...mro->...kimo", basis, coeff)
    return inter.reshape(inter.shape[:-2] + (-1,))


def _composed_weight(basis: torch.Tensor, coeff: torch.Tensor, p: int,
                     mode: str) -> torch.Tensor:
    """Composed weight with the paper's block reshape: (ksq, gI, D)."""
    inter = torch.einsum("kir,mro->kimo", basis, coeff)
    ksq, I, m, O = inter.shape
    if mode == "grow_out":
        return inter.reshape(ksq, I, m * O)
    if mode == "grow_in":
        return inter.permute(0, 2, 1, 3).reshape(ksq, p * I, O)
    inter = inter.reshape(ksq, I, p, p, O)
    return inter.permute(0, 2, 1, 3, 4).reshape(ksq, p * I, p * O)


def conv_rank_ref(x: torch.Tensor, basis: torch.Tensor, coeff: torch.Tensor,
                  p: int, mode: str = "square", stride: int = 1
                  ) -> torch.Tensor:
    """Oracle for the fused conv rank path: compose, then one SAME conv.

    x (N, H, W, gI) x basis (ksq, I, R) x coeff (m, R, O) -> (N, Ho, Wo, D).
    """
    return _same_conv(x, _composed_weight(basis, coeff, p, mode), stride)


def compose_apply_ref(x: torch.Tensor, basis: torch.Tensor,
                      coeff: torch.Tensor, p: int, mode: str = "square"
                      ) -> torch.Tensor:
    """Oracle for both fused dense paths: compose, then matmul.

    x (..., gI) x basis (1, I, R) x coeff (m, R, O) -> (..., D).
    """
    return x @ _composed_weight(basis, coeff, p, mode)[0]


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (BH, Sq, D), k/v (BH, Sk, D) -> (BH, Sq, D), f32 softmax."""
    BH, Sq, D = q.shape
    Sk = k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q, k).float() * (D ** -0.5)
    qpos = torch.arange(Sq, device=s.device)[:, None] + (Sk - Sq)
    kpos = torch.arange(Sk, device=s.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=s.device)
    if causal:
        mask &= qpos >= kpos
    if window > 0:
        mask &= (qpos - kpos) < window
    s = torch.where(mask[None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p.to(v.dtype), v)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """q (BH, D), k/v (BH, S, D), lengths (BH,) -> (BH, D)."""
    BH, S, D = k.shape
    s = torch.einsum("bd,bkd->bk", q, k).float() * (D ** -0.5)
    mask = torch.arange(S, device=s.device)[None, :] < lengths[:, None]
    s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bk,bkd->bd", p.to(v.dtype), v)


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """x (..., d), scale (d,) -> x's shape and type; f32 statistics."""
    xf = x.float()
    ms = torch.mean(torch.square(xf), -1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


def ssd_chunk_ref(cb: torch.Tensor, bb: torch.Tensor, xw: torch.Tensor,
                  cum: torch.Tensor, h_in: torch.Tensor) -> torch.Tensor:
    """Intra-chunk SSD block + carry-in (oracle for the ssd_chunk kernel).

    cb/bb (B, Q, N), xw (B, Q, P), cum (B, Q), h_in (B, N, P) -> (B, Q, P).
    """
    Q = cb.shape[1]
    scores = torch.einsum("bin,bjn->bij", cb, bb)
    diff = cum[:, :, None] - cum[:, None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=cb.device))
    w = scores * torch.where(mask[None], torch.exp(diff), 0.0)
    y_intra = torch.einsum("bij,bjp->bip", w, xw.to(w.dtype))
    carry = torch.einsum("bin,bnp->bip", cb, h_in)
    return y_intra + torch.exp(cum)[:, :, None] * carry
