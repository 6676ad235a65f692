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
Each also takes a leading client axis on every operand (one launch for a
cohort), which is how the primitives under ``torch.func.vmap`` over
clients launch once (:class:`repro_torch.kernels.ClientVmap`).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import (SMEM_DEFAULT, SMEM_MAX, ClientVmap,
                                 check_operands, launch, on_clients, round4,
                                 use_kernel)
from repro_torch.kernels.ref import compose_ref

Tensor = torch.Tensor

# ---------------------------------------------------------------------------
# compose: v · û  (materialisation)
# ---------------------------------------------------------------------------


# launch geometry of the compose kernel (csrc/compose.cu)
CO_THREADS = 128  # threads a block has at most
CO_QUADS = 2      # column quads a block row spans at most (four-column threads)
CO_COLS = 32      # columns a block row spans at most (one-column threads)


def _compose_tiles(rows: int, m: int, O: int,
                   cw: int = 4) -> tuple[int, int]:
    """Rows and column threads one block owns, (by, cx), over a client's
    (rows = ksq*I, m*O) output, for threads that own ``cw`` (4 or 1)
    neighbouring output columns each.  cx covers m*O, at most
    ``CO_QUADS`` quads (so a warp spans many rows and few coefficient
    quads) or ``CO_COLS`` columns (a warp reads one 128-byte line of a
    coefficient row); by fills the block to ``CO_THREADS`` threads, so a
    call launches as few blocks as its shape allows (a block's dispatch
    costs more than its threads' work at the path shapes).  The blocks
    tile the output exactly, the last row and column tiles ragged.
    Raises where the kernel's reciprocal for j / O is not exact (m*O*O
    >= 2^32)."""
    if m * O * O >= 1 << 32:
        raise ValueError(f"compose: m*O*O = {m * O * O} passes 2^32")
    cx = max(1, min(CO_QUADS if cw == 4 else CO_COLS, -(-(m * O) // cw)))
    by = max(1, min(rows, CO_THREADS // cx))
    return by, cx


def _compose_width(basis: Tensor, coeff: Tensor, out: Tensor) -> int:
    """The output columns a compose thread owns: four (float4 reads and
    stores) where O and R are multiples of 4, O < 32 and every operand is
    16-byte aligned; one otherwise.  From O = 32 up a warp of one-column
    threads reads whole 128-byte lines of the coefficient's rows, which
    read faster on the H100 (PERF.md, PR 17)."""
    O = coeff.shape[-1]
    return 4 if (O % 4 == 0 and O < 32 and basis.shape[-1] % 4 == 0
                 and all(t.data_ptr() % 16 == 0
                         for t in (basis, coeff, out))) else 1


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
    cw = _compose_width(b4, c4, out)
    by, cx = _compose_tiles(ksq * I, m, O, cw)
    launch("compose", (b4, c4, out), C, ksq, I, R, m, O, by, cx, cw)
    return out if batched else out[0]


class _Compose(torch.autograd.Function):
    """Kernel forward, einsum backward (reference ``_compose_vjp_fn``), on
    basis (ksq, I, R), coeff (m, R, O), or the two with a leading client
    axis: ``dv = g·uᵀ`` and ``du = vᵀ·g`` contract through R only."""

    @staticmethod
    def forward(ctx, basis, coeff):
        ctx.save_for_backward(basis, coeff)
        return compose_kernel(basis.contiguous(), coeff.contiguous())

    @staticmethod
    def backward(ctx, g):
        basis, coeff = ctx.saved_tensors
        m, O = coeff.shape[-3], coeff.shape[-1]
        g = g.reshape(g.shape[:-1] + (m, O))  # (..., ksq, I, m, O)
        dv = torch.einsum("...kimo,...mro->...kir", g, coeff)
        du = torch.einsum("...kir,...kimo->...mro", basis, g)
        return dv, du


class _ComposeVmap(ClientVmap):
    """``_Compose`` under ``torch.func.vmap``: one launch for the cohort."""

    real = staticmethod(_Compose.apply)
    rank = 3  # basis (ksq, I, R)


def compose(basis: Tensor, coeff: Tensor) -> Tensor:
    """Differentiable :func:`compose_kernel`: (ksq, I, R) x (m, R, O) ->
    (ksq, I, m*O), optionally with a leading client axis; under
    ``torch.func.vmap`` over clients, one launch for the cohort."""
    return on_clients(_Compose.apply, _ComposeVmap, (basis, coeff))


# ---------------------------------------------------------------------------
# fused rank-space dense apply: y = (x·v)·û
# ---------------------------------------------------------------------------


def _u2_layout(u: Tensor, p: int, mode: str) -> Tensor:
    """Coefficient blocks (..., m, R, O) as the (..., g*R, D) matrix the
    fused kernels eat (any leading client axes)."""
    *lead, _, R, O = u.shape
    if mode == "grow_out":
        return u.transpose(-3, -2).reshape(*lead, R, p * O)
    if mode == "grow_in":
        return u.reshape(*lead, p * R, O)
    u4 = u.reshape(*lead, p, p, R, O)
    return u4.transpose(-3, -2).reshape(*lead, p * R, p * O)


def _fwd_math(xg: Tensor, v2: Tensor, u2: Tensor,
              with_t: bool = False):
    """Plain version of the rank_apply kernel, on its operands xg
    (M, g, I), v2 (I, R), u2 (g*R, D), each with the same leading client
    axis or none: t = xg·v (M, g, R), then t reshaped to (M, g*R) ·u2;
    with ``with_t`` the pair (y, t)."""
    lead, (M, g, I) = xg.shape[:-3], xg.shape[-3:]
    t = (xg.reshape(lead + (M * g, I)) @ v2).reshape(
        lead + (M, g, v2.shape[-1]))
    y = t.reshape(lead + (M, -1)) @ u2
    return (y, t) if with_t else y


# launch geometry of the rank_apply kernel (csrc/rank_apply.cu)
RA_BLOCKS = 128  # blocks a call aims at: about one an SM of the H100's 132
RA_ROWS = 16     # rows a block owns at most
RA_COLS = 32     # output columns a block owns at most (a multiple of 4)


def _rank_apply_smem(g: int, I: int, R: int, bm: int, bd: int) -> int:
    """Shared bytes of one rank_apply block (``rank_apply_smem_floats`` in
    the kernel): v and the u2 column tile padded to 4 columns, the
    block's xg rows and its rank tile."""
    R4 = round4(R)
    return 4 * (I * R4 + g * R4 * bd + bm * round4(g * I) + bm * g * R4)


def _rank_apply_tiles(M: int, g: int, I: int, R: int, D: int,
                      C: int = 1) -> tuple[int, int, int]:
    """Rows and output columns one block owns, (bm, bd), and its shared
    bytes.  bd is D rounded up to 4, at most ``RA_COLS``; bm halves from
    ``RA_ROWS`` while the grid has fewer than ``RA_BLOCKS`` blocks over
    all ``C`` clients, and while the block passes 48 KB.  The blocks tile
    each client's (M, D) output exactly, the last row and column tiles
    ragged."""
    bd = min(round4(D), RA_COLS)
    n_cols = -(-D // bd)
    bm = RA_ROWS
    while bm > 1 and (C * -(-M // bm) * n_cols < RA_BLOCKS
                      or _rank_apply_smem(g, I, R, bm, bd) > SMEM_DEFAULT):
        bm //= 2
    smem = _rank_apply_smem(g, I, R, bm, bd)
    if smem > SMEM_MAX:
        raise ValueError(f"rank_apply: v ({I}, {R}) and one row's tiles do "
                         "not fit in shared memory")
    return bm, bd, smem


def _dense_operands(name: str, xg: Tensor, v2: Tensor, w: Tensor,
                    w_rank: int):
    """Check a dense kernel's operands (xg (M, g, I), v2 (I, R) and its
    coefficient ``w`` of rank ``w_rank``, each with the same leading
    client axis or none) and return (C, M, g, I, R, D)."""
    check_operands(name, xg=xg, v2=v2, w=w)
    *lead, M, g, I = xg.shape
    R, D = v2.shape[-1], w.shape[-1]
    if (len(lead) > 1 or v2.shape != (*lead, I, R)
            or w.shape != ((*lead, g * R, D) if w_rank == 2
                           else (*lead, g, R, D))):
        raise ValueError(f"{name}: xg {tuple(xg.shape)}, v2 "
                         f"{tuple(v2.shape)}, {tuple(w.shape)} disagree")
    return (lead[0] if lead else 1), M, g, I, R, D


def rank_apply_kernel(xg: Tensor, v2: Tensor, u2: Tensor, *,
                      with_t: bool = False):
    """Fused two-stage contraction: xg (M, g, I) x v2 (I, R) x u2 (g*R, D)
    -> (M, D); the (M, g*R) rank intermediate stays in shared memory.
    With ``with_t`` also returns it, as t (M, g, R): the pair (y, t).
    With a leading client axis C on all three operands (and the
    results), one launch for the cohort; the unbatched call is its C = 1
    case."""
    if not use_kernel(xg):
        return _fwd_math(xg, v2, u2, with_t)
    C, M, g, I, R, D = _dense_operands("rank_apply", xg, v2, u2, 2)
    bm, bd, _ = _rank_apply_tiles(M, g, I, R, D, C)
    lead = (C,) if xg.dim() == 4 else ()
    y = torch.empty((*lead, M, D), device=xg.device, dtype=xg.dtype)
    t = (torch.empty((*lead, M, g, R), device=xg.device, dtype=xg.dtype)
         if with_t else None)
    launch("rank_apply", (xg, v2, u2, y, t), C, M, g, I, R, D, bm, bd)
    return (y, t) if with_t else y


def _rank_space_bwd(p: int, mode: str, x2: Tensor, v2: Tensor, u: Tensor,
                    t: Tensor, dy: Tensor):
    """Shared rank-space backward for ``rank_dense_apply`` and
    ``compose_dense_apply`` (same function, different forward
    associations), on x2 (M, g*I), v2 (I, R), u (m, R, O), t and dy
    (M, D), each with the same leading client axis or none; every
    contraction routes through the R bottleneck."""
    R, O = u.shape[-2], u.shape[-1]
    lead, M = x2.shape[:-2], x2.shape[-2]
    if mode == "grow_out":
        dyr = dy.reshape(lead + (M, p, O))
        dt = torch.einsum("...mbo,...bro->...mr", dyr, u)
        dx = dt @ v2.transpose(-1, -2)
        dv2 = x2.transpose(-1, -2) @ dt
        du = torch.einsum("...mr,...mbo->...bro", t, dyr)
        return dx, dv2, du
    xr = x2.reshape(lead + (M, p, -1))
    if mode == "grow_in":
        dt = torch.einsum("...mo,...aro->...mar", dy, u)
        du = torch.einsum("...mar,...mo->...aro", t, dy)
    else:
        u4 = u.reshape(lead + (p, p, R, O))
        dyr = dy.reshape(lead + (M, p, O))
        dt = torch.einsum("...mbo,...abro->...mar", dyr, u4)
        du = torch.einsum("...mar,...mbo->...abro", t, dyr).reshape(
            lead + (p * p, R, O))
    dx = torch.einsum("...mar,...ir->...mai", dt, v2).reshape(x2.shape)
    dv2 = torch.einsum("...mai,...mar->...ir", xr, dt)
    return dx, dv2, du


def _records_graph(*tensors: Tensor) -> bool:
    """Whether autograd records a graph through these operands: grad mode
    on and one of them requiring grad (inside a ``Function.forward`` grad
    mode is off, so the dense wrappers ask before they apply one).  Under
    ``torch.func.vmap`` a batched operand reports no grad, so the question
    waits for the :class:`ClientVmap` rule, which asks it of the real
    operands."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _rank_args(x2: Tensor, v2: Tensor, u: Tensor, p: int, mode: str):
    """rank_apply's operands for a dense layer: xg (M, g, I), v2, u2, each
    with the leading client axis of x2 (M, g*I) or none."""
    g = 1 if mode == "grow_out" else p
    *lead, M, _ = x2.shape
    return (x2.reshape(*lead, M, g, -1).contiguous(), v2.contiguous(),
            _u2_layout(u, p, mode).contiguous())


class _DenseFunction(torch.autograd.Function):
    """The two fused dense primitives' common autograd wiring, on x2
    (M, g*I), v2 (I, R), u (m, R, O), or the three with a leading client
    axis: the subclass's ``_kernel`` forward, the shared rank-space
    backward.  The kernel hands back the residual t it computed on the
    way, so the forward runs no second contraction for it.  Applied only
    when a graph is recorded (:func:`_dense_real`): without one, the
    kernel launches alone."""

    @staticmethod
    def _kernel(x2, v2, u, p, mode, with_t):
        raise NotImplementedError

    @classmethod
    def forward(cls, ctx, x2, v2, u, p, mode):
        y, t = cls._kernel(x2, v2, u, p, mode, True)
        ctx.save_for_backward(x2, v2, u,
                              t[..., 0, :] if mode == "grow_out" else t)
        ctx.p, ctx.mode = p, mode
        return y

    @staticmethod
    def backward(ctx, dy):
        dx, dv2, du = _rank_space_bwd(ctx.p, ctx.mode, *ctx.saved_tensors, dy)
        return dx, dv2, du, None, None


def _dense_real(x2: Tensor, v2: Tensor, u: Tensor, p: int, mode: str,
                fn) -> Tensor:
    """``fn`` (a :class:`_DenseFunction`) on operands with storage where a
    graph is recorded, else its kernel alone."""
    if _records_graph(x2, v2, u):
        return fn.apply(x2, v2, u, p, mode)
    return fn._kernel(x2, v2, u, p, mode, False)


def _dense_apply(fn, vmapped, x: Tensor, basis: Tensor,
                 reduced_coeff: Tensor, p: int, mode: str) -> Tensor:
    """A dense layer x (..., g*I) -> (..., D) through ``fn`` (``vmapped``
    under vmap)."""
    y = on_clients(_dense_real, vmapped,
                   (x.reshape(-1, x.shape[-1]), basis[0], reduced_coeff),
                   (p, mode, fn))
    return y.reshape(x.shape[:-1] + (y.shape[-1],))


class _RankDense(_DenseFunction):
    """rank_apply kernel forward, rank-space backward (reference
    ``_rank_dense_fn``)."""

    @staticmethod
    def _kernel(x2, v2, u, p, mode, with_t):
        return rank_apply_kernel(*_rank_args(x2, v2, u, p, mode),
                                 with_t=with_t)


class _RankDenseVmap(ClientVmap):
    """``rank_dense_apply`` under ``torch.func.vmap``: one launch for the
    cohort, with or without a graph."""

    real = staticmethod(_dense_real)
    rank = 2  # x2 (M, g*I)


def rank_dense_apply(x: Tensor, basis: Tensor, reduced_coeff: Tensor, p: int,
                     mode: str = "square") -> Tensor:
    """Rank-space dense application with a rank-space backward.

    x (..., pI_total), basis (1, I, R), reduced_coeff (m, R, O) gathered
    blocks -> (..., pO_total): what ``x @ compose(...)`` returns, up to
    float re-association, without building the p-width weight.  Without
    a recorded graph the kernel launches alone; under ``torch.func.vmap``
    over clients, once for the cohort.
    """
    return _dense_apply(_RankDense, _RankDenseVmap, x, basis, reduced_coeff,
                        p, mode)


# ---------------------------------------------------------------------------
# fused compose+apply: y = x · (v · û), weight built in shared memory
# ---------------------------------------------------------------------------


def _compose_apply_math(xg: Tensor, v2: Tensor, u3: Tensor,
                        with_t: bool = False):
    """Plain version of the compose_apply kernel, on its operands xg
    (M, g, I), v2 (I, R), u3 (g, R, D), each with the same leading client
    axis or none: per-group weights as one batched einsum, then one
    grouped contraction; with ``with_t`` also t = xg·v (M, g, R), the
    pair (y, t)."""
    w = torch.einsum("...ir,...arj->...aij", v2, u3)
    y = torch.einsum("...nai,...aij->...nj", xg, w)
    if not with_t:
        return y
    lead, (M, g, I) = xg.shape[:-3], xg.shape[-3:]
    return y, (xg.reshape(lead + (M * g, I)) @ v2).reshape(
        lead + (M, g, v2.shape[-1]))


# launch geometry of the compose_apply kernel (csrc/compose_apply.cu)
CA_BLOCKS = 128    # blocks a call aims at
CA_ROWS = 16       # rows a block owns at most: 16 rows x 8 column quads
CA_COLS = 32       # output columns at most: the kernel's 128 threads
CA_CHUNK_MIN = 16  # weight rows a chunk holds at least within 48 KB


def _compose_apply_smem(g: int, I: int, R: int, bm: int, bd: int,
                        kc: int) -> int:
    """Shared bytes of one compose_apply block (``compose_apply_smem_floats``
    in the kernel): v padded to 4 columns, the u3 column tile, the block's
    xg rows and kc rows of its weight tile."""
    return 4 * (I * round4(R) + g * R * bd + bm * round4(g * I) + kc * bd)


def _compose_apply_tiles(M: int, g: int, I: int, R: int, D: int,
                         C: int = 1) -> tuple[int, int, int, int]:
    """Rows and output columns one block owns, (bm, bd), the rows of its
    (g*I, bd) weight tile built at a time (kc), and its shared bytes.  bd
    is D rounded up to 4, at most ``CA_COLS``; bm halves from ``CA_ROWS``
    while the grid has fewer than ``CA_BLOCKS`` blocks over all ``C``
    clients, and while the block with its whole weight tile passes 48
    KB.  Where the whole tile
    still does not fit in 48 KB it is built in chunks of kc rows there, or,
    when not even ``CA_CHUNK_MIN`` rows fit beside the staged operands,
    in the largest chunk that fits in 227 KB.  The blocks tile the (M, D)
    output exactly, the last row and column tiles ragged."""
    gI = g * I
    bd = min(round4(D), CA_COLS)
    n_cols = -(-D // bd)
    bm = CA_ROWS
    while bm > 1 and (C * -(-M // bm) * n_cols < CA_BLOCKS
                      or _compose_apply_smem(g, I, R, bm, bd, gI)
                      > SMEM_DEFAULT):
        bm //= 2
    kc = gI
    staged = _compose_apply_smem(g, I, R, bm, bd, 0)
    if staged + 4 * bd * gI > SMEM_DEFAULT:
        fits_default = (staged + 4 * bd * min(gI, CA_CHUNK_MIN)
                        <= SMEM_DEFAULT)
        room = (SMEM_DEFAULT if fits_default else SMEM_MAX) - staged
        kc = min(gI, room // (4 * bd))
    if kc < 1:
        raise ValueError(f"compose_apply: v ({I}, {R}), one row of xg and "
                         "one weight row do not fit in shared memory")
    return bm, bd, kc, _compose_apply_smem(g, I, R, bm, bd, kc)


def compose_apply_kernel(xg: Tensor, v2: Tensor, u3: Tensor, *,
                         with_t: bool = False):
    """Fused compose+apply: xg (M, g, I) x v2 (I, R) x u3 (g, R, D) ->
    (M, D); each ``W_a = v2 @ u3[a]`` exists only in shared memory.  With
    ``with_t`` also returns t = xg·v2 (M, g, R), the residual of the
    rank-space backward: the pair (y, t).  With a leading client axis C
    on all three operands (and the results), one launch for the cohort;
    the unbatched call is its C = 1 case."""
    if not use_kernel(xg):
        return _compose_apply_math(xg, v2, u3, with_t)
    C, M, g, I, R, D = _dense_operands("compose_apply", xg, v2, u3, 3)
    bm, bd, kc, _ = _compose_apply_tiles(M, g, I, R, D, C)
    lead = (C,) if xg.dim() == 4 else ()
    y = torch.empty((*lead, M, D), device=xg.device, dtype=xg.dtype)
    t = (torch.empty((*lead, M, g, R), device=xg.device, dtype=xg.dtype)
         if with_t else None)
    launch("compose_apply", (xg, v2, u3, y, t), C, M, g, I, R, D, bm, bd,
           kc)
    return (y, t) if with_t else y


def _compose_args(x2: Tensor, v2: Tensor, u: Tensor, p: int, mode: str):
    """compose_apply's operands for a dense layer: xg (M, g, I), v2, u3
    (g, R, D), each with the leading client axis of x2 (M, g*I) or
    none."""
    g = 1 if mode == "grow_out" else p
    *lead, M, _ = x2.shape
    u3 = _u2_layout(u, p, mode).reshape(*lead, g, u.shape[-2], -1)
    return (x2.reshape(*lead, M, g, -1).contiguous(), v2.contiguous(),
            u3.contiguous())


class _ComposeDense(_DenseFunction):
    """compose_apply kernel forward, the shared rank-space backward
    (reference ``_compose_dense_fn``)."""

    @staticmethod
    def _kernel(x2, v2, u, p, mode, with_t):
        return compose_apply_kernel(*_compose_args(x2, v2, u, p, mode),
                                    with_t=with_t)


class _ComposeDenseVmap(ClientVmap):
    """``compose_dense_apply`` under ``torch.func.vmap``: one launch for
    the cohort, with or without a graph."""

    real = staticmethod(_dense_real)
    rank = 2  # x2 (M, g*I)


def compose_dense_apply(x: Tensor, basis: Tensor, reduced_coeff: Tensor,
                        p: int, mode: str = "square") -> Tensor:
    """Fused compose+apply dense application (materialize-path fusion).

    Same arguments and result as :func:`rank_dense_apply`; the forward
    associates ``x·(v·û)`` with the composed weight living only in shared
    memory, and the backward is the shared rank-space one.  Used by
    ``auto`` dispatch when ``fused_compose_gain < 1``.
    """
    return _dense_apply(_ComposeDense, _ComposeDenseVmap, x, basis,
                        reduced_coeff, p, mode)
