"""Fused conv rank path: basis conv + coefficient contraction, on Hopper.

The conv rank path applies a factorized k×k weight without materialising
it: a group-batched basis conv projects every input group into rank space
(I → R) and a 1×1 coefficient contraction finishes the job (R → pO, the
paper's block reshape folded into the coefficient layout).
``conv_rank_kernel`` does both in one CUDA kernel (``csrc/conv_rank.cu``);
the rank intermediate never reaches device memory.

``conv_rank_apply`` is the public autograd Function.  Backward stays in
rank space: the coefficient gradients are einsums through R, and the
input/basis gradients are the basis conv's own (recomputing ``t``, the
cheap I→R half), so no direction builds the ``(ksq, pI, pO)`` weight.

Padding follows XLA's asymmetric ``"SAME"`` convention (low = total//2),
so every formulation samples the positions the JAX package does.  Public
functions keep its NHWC activations and HWIO-ordered ``(ksq, I, R)``
weights.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import (SMEM_MAX, check_operands, launch, round4,
                                 use_kernel)

Tensor = torch.Tensor

CONV_MODES = ("square", "grow_out", "grow_in")


def _same_pads(size: int, k: int, stride: int) -> tuple[int, tuple[int, int]]:
    """Output size and (lo, hi) padding of XLA "SAME" for one dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return out, (total // 2, total - total // 2)


def _same_conv(x: Tensor, w3: Tensor, stride: int = 1) -> Tensor:
    """x NHWC, w3 (k*k, I, O) -> NHWC conv with XLA's "SAME" padding.

    The padding is explicit and asymmetric (low = total // 2):
    ``F.conv2d(padding="same")`` rejects stride > 1.
    """
    ksq, i, o = w3.shape
    k = int(round(ksq ** 0.5))
    _, H, W, _ = x.shape
    _, (ph_lo, ph_hi) = _same_pads(H, k, stride)
    _, (pw_lo, pw_hi) = _same_pads(W, k, stride)
    xp = F.pad(x.permute(0, 3, 1, 2), (pw_lo, pw_hi, ph_lo, ph_hi))
    w = w3.reshape(k, k, i, o).permute(3, 2, 0, 1)
    return F.conv2d(xp, w, stride=stride).permute(0, 2, 3, 1)


def _u2_conv_layout(u: Tensor, p: int, mode: str) -> Tensor:
    """Coefficient blocks (m, R, O) as the (g·R, D) contraction matrix.

    Row block ``a`` holds the R coefficients of input group ``a``; the
    column layout bakes in the compose block reshape, so ``t2 @ u2``
    lands directly in the composed output-channel order.
    """
    R, O = u.shape[-2], u.shape[-1]
    if mode == "grow_out":
        return u.permute(1, 0, 2).reshape(R, p * O)
    if mode == "grow_in":
        return u.reshape(p * R, O)
    u4 = u.reshape(p, p, R, O)
    return u4.permute(0, 2, 1, 3).reshape(p * R, p * O)


def _u2_conv_unlayout(du2: Tensor, p: int, R: int, O: int,
                      mode: str) -> Tensor:
    """Inverse of :func:`_u2_conv_layout` for the coefficient gradient."""
    if mode == "grow_out":
        return du2.reshape(R, p, O).permute(1, 0, 2)
    if mode == "grow_in":
        return du2.reshape(p, R, O)
    du4 = du2.reshape(p, R, p, O).permute(0, 2, 1, 3)
    return du4.reshape(p * p, R, O)


def _basis_conv(x: Tensor, basis: Tensor, p: int, mode: str,
                stride: int) -> Tensor:
    """Group-batched basis conv: x (N, H, W, g·I) -> t2 (N, Ho, Wo, g·R).

    The linear map whose gradients carry the input/basis gradients of the
    fused primitive — one conv, groups folded into the batch.
    """
    ksq, I, R = basis.shape
    g = 1 if mode == "grow_out" else p
    N, H, W, _ = x.shape
    if g == 1:
        return _same_conv(x, basis, stride)
    xg = x.reshape(N, H, W, g, I).permute(0, 3, 1, 2, 4)
    t = _same_conv(xg.reshape(N * g, H, W, I), basis, stride)
    Ho, Wo = t.shape[1], t.shape[2]
    t2 = t.reshape(N, g, Ho, Wo, R).permute(0, 2, 3, 1, 4)
    return t2.reshape(N, Ho, Wo, g * R)


def _fused_math(x: Tensor, basis: Tensor, u2: Tensor, p: int, mode: str,
                stride: int) -> Tensor:
    """Plain version of the conv_rank kernel, on the kernel's operands.

    Group-batched modes run the basis conv as k² shifted matmuls over the
    SAME-padded image (the kernel body's math) and contract with ``u2``;
    ``grow_out`` (one group) takes the basis conv, then the contraction.
    """
    ksq, I, R = basis.shape
    k = int(round(ksq ** 0.5))
    g = 1 if mode == "grow_out" else p
    if g == 1:
        return _basis_conv(x, basis, p, mode, stride) @ u2
    N, H, W, _ = x.shape
    Ho, (ph_lo, ph_hi) = _same_pads(H, k, stride)
    Wo, (pw_lo, pw_hi) = _same_pads(W, k, stride)
    xp = F.pad(x, (0, 0, pw_lo, pw_hi, ph_lo, ph_hi))
    xg = xp.reshape(N, xp.shape[1], xp.shape[2], g, I)
    acc = torch.zeros((N, Ho, Wo, g, R), dtype=x.dtype, device=x.device)
    for ky in range(k):
        for kx in range(k):
            win = xg[:, ky:ky + stride * (Ho - 1) + 1:stride,
                     kx:kx + stride * (Wo - 1) + 1:stride]
            acc = acc + torch.einsum("nhwai,ir->nhwar", win,
                                     basis[ky * k + kx])
    return acc.reshape(N, Ho, Wo, g * R) @ u2


# launch geometry of the conv_rank kernel (csrc/conv_rank.cu)
TILE_BLOCKS = 128  # blocks a call aims at: about one an SM of the H100's 132
TILE_PIX = 32      # output pixels a block owns at most


def _conv_smem(g: int, I: int, R: int, D: int, k: int, stride: int, th: int,
               tw: int) -> int:
    """Shared bytes of one conv_rank block (``conv_rank_smem_floats`` in
    the kernel): the basis and u2 padded to 4 columns, the input window
    of a th x tw output rectangle, and k partial rank tiles."""
    R4, D4 = round4(R), round4(D)
    win = ((th - 1) * stride + k) * ((tw - 1) * stride + k) * g * I
    return 4 * (k * k * I * R4 + g * R4 * D4 + round4(win)
                + k * th * tw * g * R4)


def _conv_tiles(N: int, Ho: int, Wo: int, g: int, I: int, R: int, D: int,
                k: int = 3, stride: int = 1) -> tuple[int, int, int]:
    """The rectangle of output pixels one block owns, (th, tw), and its
    shared bytes: about ``N*Ho*Wo / TILE_BLOCKS`` pixels (1 to
    ``TILE_PIX``), a row segment first, whole rows stacked after; shrunk
    until its tiles fit in shared memory.  The blocks tile every image's
    Ho x Wo outputs exactly, the last row and column of tiles ragged."""
    want = max(1, min(TILE_PIX, (N * Ho * Wo) // TILE_BLOCKS))
    tw = max(1, min(Wo, want))
    th = max(1, min(Ho, want // tw))
    while _conv_smem(g, I, R, D, k, stride, th, tw) > SMEM_MAX:
        if th > 1:
            th -= 1
        elif tw > 1:
            tw -= 1
        else:
            raise ValueError("conv_rank: one output pixel's tiles do not "
                             "fit in shared memory")
    return th, tw, _conv_smem(g, I, R, D, k, stride, th, tw)


def conv_rank_kernel(x: Tensor, basis: Tensor, u2: Tensor, *, p: int,
                     mode: str = "square", stride: int = 1) -> Tensor:
    """Fused conv rank kernel: x (N, H, W, g·I) × basis (9, I, R) ×
    u2 (g·R, D) -> (N, Ho, Wo, D) for a 3×3 SAME conv at stride 1 or 2."""
    if mode not in CONV_MODES:
        raise ValueError(f"unknown conv mode {mode!r} "
                         f"(expected one of {CONV_MODES})")
    if not use_kernel(x):
        return _fused_math(x, basis, u2, p, mode, stride)
    check_operands("conv_rank", x=x, basis=basis, u2=u2)
    ksq, I, R = basis.shape
    k = int(round(ksq ** 0.5))
    if k * k != ksq or k != 3:
        raise ValueError(f"conv_rank: the kernel takes 3x3 convs, got "
                         f"ksq={ksq}")
    if stride not in (1, 2):
        raise ValueError(f"conv_rank: the kernel takes stride 1 or 2, got "
                         f"{stride}")
    g = 1 if mode == "grow_out" else p
    N, H, W, C = x.shape
    if C != g * I or u2.dim() != 2 or u2.shape[0] != g * R:
        raise ValueError(f"conv_rank: x {tuple(x.shape)}, basis "
                         f"{tuple(basis.shape)}, u2 {tuple(u2.shape)} "
                         f"disagree at p={p}, mode={mode}")
    D = u2.shape[1]
    Ho, (ph_lo, _) = _same_pads(H, k, stride)
    Wo, (pw_lo, _) = _same_pads(W, k, stride)
    th, tw, _ = _conv_tiles(N, Ho, Wo, g, I, R, D, k, stride)
    y = torch.empty((N, Ho, Wo, D), device=x.device, dtype=x.dtype)
    launch("conv_rank", (x, basis, u2, y), N, H, W, g, I, R, D, k, stride,
           Ho, Wo, ph_lo, pw_lo, th, tw)
    return y


class _ConvRank(torch.autograd.Function):
    """conv_rank kernel forward, rank-space backward (reference
    ``_conv_rank_fn``): the residual is the primal operands only."""

    @staticmethod
    def forward(ctx, x, basis, u, p, mode, stride):
        u2 = _u2_conv_layout(u, p, mode).contiguous()
        ctx.save_for_backward(x, basis, u)
        ctx.p, ctx.mode, ctx.stride = p, mode, stride
        return conv_rank_kernel(x.contiguous(), basis.contiguous(), u2, p=p,
                                mode=mode, stride=stride)

    @staticmethod
    def backward(ctx, dy):
        x, basis, u = ctx.saved_tensors
        p, mode, stride = ctx.p, ctx.mode, ctx.stride
        R, O = u.shape[-2], u.shape[-1]
        with torch.enable_grad():
            xd = x.detach().requires_grad_()
            vd = basis.detach().requires_grad_()
            t2 = _basis_conv(xd, vd, p, mode, stride)
        u2 = _u2_conv_layout(u, p, mode)
        du2 = torch.einsum("nhwk,nhwd->kd", t2.detach(), dy)
        dt2 = torch.einsum("nhwd,kd->nhwk", dy, u2)
        dx, dbasis = torch.autograd.grad(t2, (xd, vd), dt2)
        du = _u2_conv_unlayout(du2, p, R, O, mode)
        return dx, dbasis, du, None, None, None


def conv_rank_apply(x: Tensor, basis: Tensor, reduced_coeff: Tensor, p: int,
                    mode: str = "square", *, stride: int = 1) -> Tensor:
    """Rank-space conv application with a rank-space backward.

    x (N, H, W, C) NHWC with C = g·I (g = p for square/grow_in, 1 for
    grow_out); basis (ksq, I, R); reduced_coeff (m, R, O) gathered blocks.
    Returns what ``conv(x, compose(...))`` returns, up to float
    re-association, without building the ``(ksq, pI, pO)`` weight in
    either direction.
    """
    if mode not in CONV_MODES:
        raise ValueError(f"unknown conv mode {mode!r} "
                         f"(expected one of {CONV_MODES})")
    return _ConvRank.apply(x, basis, reduced_coeff, p, mode, stride)
