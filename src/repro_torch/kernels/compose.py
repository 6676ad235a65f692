"""Composition kernels for the dense hot path (paper Eq. 4), on Hopper.

Three primitives back the factorized client compute:

``compose``
    ``w[k] = basis[k] @ coeff_flat`` for every spatial slice ``k`` — the
    step that materialises a p-width weight from the shared basis and the
    gathered coefficient blocks, with an optional leading client axis.
    An autograd Function: CUDA kernel forward (``csrc/compose.cu``),
    einsum backward through the rank-R bottleneck.

``rank_dense_apply``
    the fused rank-space application ``y = (x·v)·û`` for dense layers
    (``csrc/rank_apply.cu``); its backward stays in rank space, so neither
    direction builds the p-width weight.

``compose_dense_apply``
    compose+apply fusion for layers the cost model keeps weight-shaped:
    each group's weight slice ``W_a = v·û_a`` is built in shared memory
    and contracted with the matching input group in the same kernel
    (``csrc/compose_apply.cu``).  Shares the rank-space backward with
    ``rank_dense_apply``: the two compute the same function.

Each ``*_kernel`` wrapper launches its CUDA kernel for a tensor on a CUDA
device and takes its plain PyTorch version (in this module, or
:func:`repro_torch.kernels.ref.compose_ref`) only for a tensor on the CPU.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import check_operands, launch, use_kernel
from repro_torch.kernels.ref import compose_ref

Tensor = torch.Tensor

# ---------------------------------------------------------------------------
# compose: v · û  (materialisation)
# ---------------------------------------------------------------------------


def compose_kernel(basis: Tensor, coeff: Tensor) -> Tensor:
    """basis (ksq, I, R) x coeff (m, R, O) -> (ksq, I, m*O); with a leading
    client axis on both, (C, ksq, I, R) x (C, m, R, O) -> (C, ksq, I, m*O)
    in one launch."""
    if not use_kernel(basis):
        return compose_ref(basis, coeff)
    check_operands("compose", basis=basis, coeff=coeff)
    if basis.dim() not in (3, 4) or coeff.dim() != basis.dim():
        raise ValueError(f"compose: basis {tuple(basis.shape)} and coeff "
                         f"{tuple(coeff.shape)} must both be 3-d or 4-d")
    batched = basis.dim() == 4
    b4 = basis if batched else basis.unsqueeze(0)
    c4 = coeff if batched else coeff.unsqueeze(0)
    C, ksq, I, R = b4.shape
    C2, m, R2, O = c4.shape
    if (C, R) != (C2, R2):
        raise ValueError(f"compose: basis {tuple(basis.shape)} does not "
                         f"match coeff {tuple(coeff.shape)}")
    out = torch.empty((C, ksq, I, m * O), device=basis.device,
                      dtype=basis.dtype)
    launch("compose", (b4, c4, out), C, ksq, I, R, m, O)
    return out if batched else out[0]


class _Compose(torch.autograd.Function):
    """Kernel forward, einsum backward (reference ``_compose_vjp_fn``):
    ``dv = g·uᵀ`` and ``du = vᵀ·g`` contract through R only."""

    @staticmethod
    def forward(ctx, basis, coeff):
        ctx.save_for_backward(basis, coeff)
        return compose_kernel(basis.contiguous(), coeff.contiguous())

    @staticmethod
    def backward(ctx, g):
        basis, coeff = ctx.saved_tensors
        m, O = coeff.shape[-3], coeff.shape[-1]
        g = g.reshape(g.shape[:-1] + (m, O))  # (..., ksq, I, m, O)
        if basis.dim() == 4:
            dv = torch.einsum("ckimo,cmro->ckir", g, coeff)
            du = torch.einsum("ckir,ckimo->cmro", basis, g)
        else:
            dv = torch.einsum("kimo,mro->kir", g, coeff)
            du = torch.einsum("kir,kimo->mro", basis, g)
        return dv, du


def compose(basis: Tensor, coeff: Tensor) -> Tensor:
    """Differentiable :func:`compose_kernel`: (ksq, I, R) x (m, R, O) ->
    (ksq, I, m*O), optionally with a leading client axis."""
    return _Compose.apply(basis, coeff)


# ---------------------------------------------------------------------------
# fused rank-space dense apply: y = (x·v)·û
# ---------------------------------------------------------------------------


def _u2_layout(u: Tensor, p: int, mode: str) -> Tensor:
    """Coefficient blocks as the (g*R, D) matrix the fused kernels eat."""
    R, O = u.shape[-2], u.shape[-1]
    if mode == "grow_out":
        return u.permute(1, 0, 2).reshape(R, p * O)
    if mode == "grow_in":
        return u.reshape(p * R, O)
    u4 = u.reshape(p, p, R, O)
    return u4.permute(0, 2, 1, 3).reshape(p * R, p * O)


def _fwd_math(xg: Tensor, v2: Tensor, u2: Tensor) -> Tensor:
    """Plain version of the rank_apply kernel: (xg·v) reshaped to
    (M, g*R), then ·u2."""
    M, g, I = xg.shape
    t = (xg.reshape(M * g, I) @ v2).reshape(M, g * v2.shape[1])
    return t @ u2


def rank_apply_kernel(xg: Tensor, v2: Tensor, u2: Tensor) -> Tensor:
    """Fused two-stage contraction: xg (M, g, I) x v2 (I, R) x u2 (g*R, D)
    -> (M, D); the (M, g*R) rank intermediate stays in shared memory."""
    if not use_kernel(xg):
        return _fwd_math(xg, v2, u2)
    check_operands("rank_apply", xg=xg, v2=v2, u2=u2)
    M, g, I = xg.shape
    I2, R = v2.shape
    if I2 != I or u2.dim() != 2 or u2.shape[0] != g * R:
        raise ValueError(f"rank_apply: xg {tuple(xg.shape)}, v2 "
                         f"{tuple(v2.shape)}, u2 {tuple(u2.shape)} disagree")
    D = u2.shape[1]
    if g * R * 4 > 227 * 1024:
        raise ValueError(f"rank_apply: a (g*R = {g * R}) rank row does not "
                         "fit in shared memory")
    bm = max(1, min(16, (48 * 1024) // (4 * g * R)))
    y = torch.empty((M, D), device=xg.device, dtype=xg.dtype)
    launch("rank_apply", (xg, v2, u2, y), M, g, I, R, D, bm)
    return y


def _rank_residual(xg: Tensor, v2: Tensor, mode: str) -> Tensor:
    """Rank-space residual t of the shared backward, recomputed cheaply
    (M·g·I·R MACs) — never the composed weight."""
    t = torch.einsum("mgi,ir->mgr", xg, v2)
    return t[:, 0] if mode == "grow_out" else t


def _rank_space_bwd(p: int, mode: str, x2: Tensor, v2: Tensor, u: Tensor,
                    t: Tensor, dy: Tensor):
    """Shared rank-space backward for ``rank_dense_apply`` and
    ``compose_dense_apply`` (same function, different forward
    associations); every contraction routes through the R bottleneck."""
    R, O = u.shape[-2], u.shape[-1]
    if mode == "grow_out":
        dyr = dy.reshape(dy.shape[0], p, O)
        dt = torch.einsum("mbo,bro->mr", dyr, u)
        dx = dt @ v2.T
        dv2 = x2.T @ dt
        du = torch.einsum("mr,mbo->bro", t, dyr)
        return dx, dv2, du
    xr = x2.reshape(x2.shape[0], p, -1)
    if mode == "grow_in":
        dt = torch.einsum("mo,aro->mar", dy, u)
        du = torch.einsum("mar,mo->aro", t, dy)
    else:
        u4 = u.reshape(p, p, R, O)
        dyr = dy.reshape(dy.shape[0], p, O)
        dt = torch.einsum("mbo,abro->mar", dyr, u4)
        du = torch.einsum("mar,mbo->abro", t, dyr).reshape(p * p, R, O)
    dx = torch.einsum("mar,ir->mai", dt, v2).reshape(x2.shape)
    dv2 = torch.einsum("mai,mar->ir", xr, dt)
    return dx, dv2, du


class _RankDense(torch.autograd.Function):
    """rank_apply kernel forward, rank-space backward (reference
    ``_rank_dense_fn``)."""

    @staticmethod
    def forward(ctx, x2, v2, u, p, mode):
        g = 1 if mode == "grow_out" else p
        xg = x2.reshape(x2.shape[0], g, -1)
        y = rank_apply_kernel(xg.contiguous(), v2.contiguous(),
                              _u2_layout(u, p, mode).contiguous())
        ctx.save_for_backward(x2, v2, u, _rank_residual(xg, v2, mode))
        ctx.p, ctx.mode = p, mode
        return y

    @staticmethod
    def backward(ctx, dy):
        dx, dv2, du = _rank_space_bwd(ctx.p, ctx.mode, *ctx.saved_tensors, dy)
        return dx, dv2, du, None, None


def rank_dense_apply(x: Tensor, basis: Tensor, reduced_coeff: Tensor, p: int,
                     mode: str = "square") -> Tensor:
    """Rank-space dense application with a rank-space backward.

    x (..., pI_total), basis (1, I, R), reduced_coeff (m, R, O) gathered
    blocks -> (..., pO_total): what ``x @ compose(...)`` returns, up to
    float re-association, without building the p-width weight.
    """
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    y2 = _RankDense.apply(x2, basis[0], reduced_coeff, p, mode)
    return y2.reshape(lead + (y2.shape[-1],))


# ---------------------------------------------------------------------------
# fused compose+apply: y = x · (v · û), weight built in shared memory
# ---------------------------------------------------------------------------


def _compose_apply_math(xg: Tensor, v2: Tensor, u3: Tensor) -> Tensor:
    """Plain version of the compose_apply kernel: per-group weights as one
    batched einsum, then one grouped contraction."""
    w = torch.einsum("ir,arj->aij", v2, u3)
    return torch.einsum("nai,aij->nj", xg, w)


def compose_apply_kernel(xg: Tensor, v2: Tensor, u3: Tensor) -> Tensor:
    """Fused compose+apply: xg (M, g, I) x v2 (I, R) x u3 (g, R, D) ->
    (M, D); each ``W_a = v2 @ u3[a]`` exists only in shared memory."""
    if not use_kernel(xg):
        return _compose_apply_math(xg, v2, u3)
    check_operands("compose_apply", xg=xg, v2=v2, u3=u3)
    M, g, I = xg.shape
    I2, R = v2.shape
    if I2 != I or u3.dim() != 3 or tuple(u3.shape[:2]) != (g, R):
        raise ValueError(f"compose_apply: xg {tuple(xg.shape)}, v2 "
                         f"{tuple(v2.shape)}, u3 {tuple(u3.shape)} disagree")
    D = u3.shape[2]
    dt = min(D, 256)
    bm = max(1, min(M, 64, 1024 // dt))  # bm * dt <= 4 outputs x 256 threads
    if (I * dt + bm * I) * 4 > 227 * 1024:
        raise ValueError(f"compose_apply: an (I = {I}, {dt}) weight slice "
                         "does not fit in shared memory")
    y = torch.empty((M, D), device=xg.device, dtype=xg.dtype)
    launch("compose_apply", (xg, v2, u3, y), M, g, I, R, D, bm, dt)
    return y


class _ComposeDense(torch.autograd.Function):
    """compose_apply kernel forward, the shared rank-space backward
    (reference ``_compose_dense_fn``)."""

    @staticmethod
    def forward(ctx, x2, v2, u, p, mode):
        g = 1 if mode == "grow_out" else p
        xg = x2.reshape(x2.shape[0], g, -1)
        u3 = _u2_layout(u, p, mode).reshape(g, u.shape[-2], -1)
        y = compose_apply_kernel(xg.contiguous(), v2.contiguous(),
                                 u3.contiguous())
        ctx.save_for_backward(x2, v2, u, _rank_residual(xg, v2, mode))
        ctx.p, ctx.mode = p, mode
        return y

    @staticmethod
    def backward(ctx, dy):
        dx, dv2, du = _rank_space_bwd(ctx.p, ctx.mode, *ctx.saved_tensors, dy)
        return dx, dv2, du, None, None


def compose_dense_apply(x: Tensor, basis: Tensor, reduced_coeff: Tensor,
                        p: int, mode: str = "square") -> Tensor:
    """Fused compose+apply dense application (materialize-path fusion).

    Same arguments and result as :func:`rank_dense_apply`; the forward
    associates ``x·(v·û)`` with the composed weight living only in shared
    memory, and the backward is the shared rank-space one.  Used by
    ``auto`` dispatch when ``fused_compose_gain < 1``.
    """
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    y2 = _ComposeDense.apply(x2, basis[0], reduced_coeff, p, mode)
    return y2.reshape(lead + (y2.shape[-1],))
