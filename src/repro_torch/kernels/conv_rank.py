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
The kernel, its plain version and the Function also take a leading
client axis (one basis and coefficient per client), which is how a
cohort under ``torch.func.vmap`` takes one launch.

Padding follows XLA's asymmetric ``"SAME"`` convention (low = total//2),
so every formulation samples the positions the JAX package does.  Public
functions keep its NHWC activations and HWIO-ordered ``(ksq, I, R)``
weights.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import (SMEM_MAX, ClientVmap, check_operands,
                                 launch, on_clients, round4, use_kernel)

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
    """Coefficient blocks (..., m, R, O) as the (..., g·R, D) contraction
    matrix (any leading client axes).

    Row block ``a`` holds the R coefficients of input group ``a``; the
    column layout bakes in the compose block reshape, so ``t2 @ u2``
    lands directly in the composed output-channel order.
    """
    *lead, _, R, O = u.shape
    if mode == "grow_out":
        return u.transpose(-3, -2).reshape(*lead, R, p * O)
    if mode == "grow_in":
        return u.reshape(*lead, p * R, O)
    u4 = u.reshape(*lead, p, p, R, O)
    return u4.transpose(-3, -2).reshape(*lead, p * R, p * O)


def _u2_conv_unlayout(du2: Tensor, p: int, R: int, O: int,
                      mode: str) -> Tensor:
    """Inverse of :func:`_u2_conv_layout` for the coefficient gradient."""
    lead = du2.shape[:-2]
    if mode == "grow_out":
        return du2.reshape(lead + (R, p, O)).transpose(-3, -2)
    if mode == "grow_in":
        return du2.reshape(lead + (p, R, O))
    du4 = du2.reshape(lead + (p, R, p, O)).transpose(-3, -2)
    return du4.reshape(lead + (p * p, R, O))


def _grouped_operands(x: Tensor, basis: Tensor, p: int, mode: str,
                      stride: int):
    """The basis conv of client-batched x (C, N, H, W, g·I) and basis
    (C, ksq, I, R) as one grouped conv (groups = C, one per client's
    basis; the input groups folded into the batch): the SAME-padded input
    (N·g, C·I, Hp, Wp), the weight (C·R, I, k, k) and the low pads."""
    C, ksq, I, R = basis.shape
    k = int(round(ksq ** 0.5))
    g = 1 if mode == "grow_out" else p
    _, N, H, W, _ = x.shape
    _, (ph_lo, ph_hi) = _same_pads(H, k, stride)
    _, (pw_lo, pw_hi) = _same_pads(W, k, stride)
    xg = x.reshape(C, N, H, W, g, I).permute(1, 4, 0, 5, 2, 3)
    xp = F.pad(xg.reshape(N * g, C * I, H, W), (pw_lo, pw_hi, ph_lo, ph_hi))
    w = basis.reshape(C, k, k, I, R).permute(0, 4, 3, 1, 2)
    return xp, w.reshape(C * R, I, k, k), (ph_lo, pw_lo)


def _from_grouped(t: Tensor, C: int, g: int) -> Tensor:
    """A grouped conv's (N·g, C·R, Ho, Wo) as t2 (C, N, Ho, Wo, g·R)."""
    Ng, CR, Ho, Wo = t.shape
    t = t.reshape(Ng // g, g, C, CR // C, Ho, Wo).permute(2, 0, 4, 5, 1, 3)
    return t.reshape(C, Ng // g, Ho, Wo, -1)


def _to_grouped(t2: Tensor, g: int) -> Tensor:
    """Inverse of :func:`_from_grouped`."""
    C, N, Ho, Wo, gR = t2.shape
    t = t2.reshape(C, N, Ho, Wo, g, gR // g).permute(1, 4, 0, 5, 2, 3)
    return t.reshape(N * g, C * (gR // g), Ho, Wo)


def _basis_conv(x: Tensor, basis: Tensor, p: int, mode: str,
                stride: int) -> Tensor:
    """Group-batched basis conv of each client: x (C, N, H, W, g·I) ×
    basis (C, ksq, I, R) -> t2 (C, N, Ho, Wo, g·R), or the same without
    the client axis: one grouped conv (:func:`_grouped_operands`)."""
    if x.dim() == 4:
        return _basis_conv(x[None], basis[None], p, mode, stride)[0]
    C = basis.shape[0]
    xp, w, _ = _grouped_operands(x, basis, p, mode, stride)
    t = F.conv2d(xp, w, stride=stride, groups=C)
    return _from_grouped(t, C, 1 if mode == "grow_out" else p)


def _basis_conv_vjp(x: Tensor, basis: Tensor, p: int, mode: str,
                    stride: int, dt2_fn):
    """The basis conv's t2 and its vjp, for client-batched operands:
    (dx, dbasis) for the cotangent ``dt2_fn(t2)`` of t2, taken with
    ``aten.convolution_backward`` (what autograd runs for the conv) and
    the padding cropped, so no tensor is marked to require grad."""
    C, ksq, I, R = basis.shape
    k = int(round(ksq ** 0.5))
    g = 1 if mode == "grow_out" else p
    _, N, H, W, _ = x.shape
    xp, w, (ph_lo, pw_lo) = _grouped_operands(x, basis, p, mode, stride)
    t2 = _from_grouped(F.conv2d(xp, w, stride=stride, groups=C), C, g)
    dxp, dw, _ = torch.ops.aten.convolution_backward(
        _to_grouped(dt2_fn(t2), g), xp, w, None, (stride, stride), (0, 0),
        (1, 1), False, (0, 0), C, (True, True, False))
    dx = dxp[:, :, ph_lo:ph_lo + H, pw_lo:pw_lo + W]
    dx = dx.reshape(N, g, C, I, H, W).permute(2, 0, 4, 5, 1, 3)
    dbasis = dw.reshape(C, R, I, k, k).permute(0, 3, 4, 2, 1)
    return dx.reshape(x.shape), dbasis.reshape(basis.shape)


def _fused_math(x: Tensor, basis: Tensor, u2: Tensor, p: int, mode: str,
                stride: int) -> Tensor:
    """Plain version of the conv_rank kernel, on the kernel's operands:
    x (C, N, H, W, g·I), basis (C, 9, I, R), u2 (C, g·R, D) ->
    (C, N, Ho, Wo, D), or the same without the client axis C.

    Group-batched modes run the basis conv as k² shifted matmuls over the
    SAME-padded image (the kernel body's math) and contract with ``u2``;
    ``grow_out`` (one group) takes the basis conv, then the contraction.
    """
    batched = x.dim() == 5
    if not batched:
        x, basis, u2 = x[None], basis[None], u2[None]
    C, ksq, I, R = basis.shape
    k = int(round(ksq ** 0.5))
    g = 1 if mode == "grow_out" else p
    if g == 1:
        t2 = _basis_conv(x, basis, p, mode, stride)
        y = (t2.reshape(C, -1, R) @ u2).reshape(t2.shape[:-1]
                                                + (u2.shape[-1],))
        return y if batched else y[0]
    _, N, H, W, _ = x.shape
    Ho, (ph_lo, ph_hi) = _same_pads(H, k, stride)
    Wo, (pw_lo, pw_hi) = _same_pads(W, k, stride)
    xp = F.pad(x, (0, 0, pw_lo, pw_hi, ph_lo, ph_hi))
    xg = xp.reshape(C, N, xp.shape[2], xp.shape[3], g, I)
    acc = torch.zeros((C, N, Ho, Wo, g, R), dtype=x.dtype, device=x.device)
    for ky in range(k):
        for kx in range(k):
            win = xg[:, :, ky:ky + stride * (Ho - 1) + 1:stride,
                     kx:kx + stride * (Wo - 1) + 1:stride]
            acc = acc + torch.einsum("cnhwai,cir->cnhwar", win,
                                     basis[:, ky * k + kx])
    y = (acc.reshape(C, N * Ho * Wo, g * R) @ u2).reshape(
        C, N, Ho, Wo, u2.shape[-1])
    return y if batched else y[0]


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
    shared bytes, over ``N`` images (a cohort's C*N: the blocks are
    counted over every client): about ``N*Ho*Wo / TILE_BLOCKS`` pixels (1 to
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
    u2 (g·R, D) -> (N, Ho, Wo, D) for a 3×3 SAME conv at stride 1 or 2;
    with a leading client axis on all three, (C, N, H, W, g·I) ×
    (C, 9, I, R) × (C, g·R, D) -> (C, N, Ho, Wo, D) in one launch (the
    unbatched call is its C = 1 case)."""
    if mode not in CONV_MODES:
        raise ValueError(f"unknown conv mode {mode!r} "
                         f"(expected one of {CONV_MODES})")
    if not use_kernel(x):
        return _fused_math(x, basis, u2, p, mode, stride)
    check_operands("conv_rank", x=x, basis=basis, u2=u2)
    *lead, N, H, W, Ch = x.shape
    ksq, I, R = basis.shape[-3:]
    k = int(round(ksq ** 0.5))
    if k * k != ksq or k != 3:
        raise ValueError(f"conv_rank: the kernel takes 3x3 convs, got "
                         f"ksq={ksq}")
    if stride not in (1, 2):
        raise ValueError(f"conv_rank: the kernel takes stride 1 or 2, got "
                         f"{stride}")
    g = 1 if mode == "grow_out" else p
    D = u2.shape[-1]
    if (len(lead) > 1 or basis.shape != (*lead, ksq, I, R)
            or u2.shape != (*lead, g * R, D) or Ch != g * I):
        raise ValueError(f"conv_rank: x {tuple(x.shape)}, basis "
                         f"{tuple(basis.shape)}, u2 {tuple(u2.shape)} "
                         f"disagree at p={p}, mode={mode}")
    C = lead[0] if lead else 1
    Ho, (ph_lo, _) = _same_pads(H, k, stride)
    Wo, (pw_lo, _) = _same_pads(W, k, stride)
    # the cohort's C*N images share one grid: ~TILE_BLOCKS blocks in all
    th, tw, _ = _conv_tiles(C * N, Ho, Wo, g, I, R, D, k, stride)
    y = torch.empty((*lead, N, Ho, Wo, D), device=x.device, dtype=x.dtype)
    launch("conv_rank", (x, basis, u2, y), C, N, H, W, g, I, R, D, k, stride,
           Ho, Wo, ph_lo, pw_lo, th, tw)
    return y


class _ConvRank(torch.autograd.Function):
    """conv_rank kernel forward, rank-space backward (reference
    ``_conv_rank_fn``), on x (N, H, W, g·I), basis (9, I, R), u (m, R, O),
    or the three with a leading client axis; the residual is the primal
    operands only."""

    @staticmethod
    def forward(ctx, x, basis, u, p, mode, stride):
        ctx.save_for_backward(x, basis, u)
        ctx.p, ctx.mode, ctx.stride = p, mode, stride
        u2 = _u2_conv_layout(u, p, mode).contiguous()
        return conv_rank_kernel(x.contiguous(), basis.contiguous(), u2, p=p,
                                mode=mode, stride=stride)

    @staticmethod
    def backward(ctx, dy):
        x, basis, u = ctx.saved_tensors
        p, mode, stride = ctx.p, ctx.mode, ctx.stride
        R, O = u.shape[-2], u.shape[-1]
        batched = x.dim() == 5
        if not batched:  # the C = 1 case: views only
            x, basis, u, dy = x[None], basis[None], u[None], dy[None]
        u2 = _u2_conv_layout(u, p, mode)
        du2 = None

        def dt2_fn(t2):  # the cotangent of the rank tile, and du2 from it
            nonlocal du2
            du2 = torch.einsum("cnhwk,cnhwd->ckd", t2, dy)
            return torch.einsum("cnhwd,ckd->cnhwk", dy, u2)

        # the basis conv differs per client: one grouped conv's backward
        dx, dbasis = _basis_conv_vjp(x, basis, p, mode, stride, dt2_fn)
        du = _u2_conv_unlayout(du2, p, R, O, mode)
        if not batched:
            dx, dbasis, du = dx[0], dbasis[0], du[0]
        return dx, dbasis, du, None, None, None


class _ConvRankVmap(ClientVmap):
    """``_ConvRank`` under ``torch.func.vmap``: one launch for the
    cohort."""

    real = staticmethod(_ConvRank.apply)
    rank = 4  # x (N, H, W, g·I)


def conv_rank_apply(x: Tensor, basis: Tensor, reduced_coeff: Tensor, p: int,
                    mode: str = "square", *, stride: int = 1) -> Tensor:
    """Rank-space conv application with a rank-space backward.

    x (N, H, W, C) NHWC with C = g·I (g = p for square/grow_in, 1 for
    grow_out); basis (ksq, I, R); reduced_coeff (m, R, O) gathered blocks.
    Returns what ``conv(x, compose(...))`` returns, up to float
    re-association, without building the ``(ksq, pI, pO)`` weight in
    either direction.  Under ``torch.func.vmap`` over clients the whole
    cohort takes one kernel launch.
    """
    if mode not in CONV_MODES:
        raise ValueError(f"unknown conv mode {mode!r} "
                         f"(expected one of {CONV_MODES})")
    return on_clients(_ConvRank.apply, _ConvRankVmap,
                      (x, basis, reduced_coeff), (p, mode, stride))
