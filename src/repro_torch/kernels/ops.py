"""Public wrappers over the port's kernels, in the model layer's layouts.

Each op takes the layouts :mod:`repro_torch.models` and
:mod:`repro_torch.fl.models` use and reaches a hand-written kernel for
tensors on a CUDA device, or its plain PyTorch version for tensors on the
CPU (the platform gate :func:`repro_torch.kernels.use_kernel`): the four
composition ops, ``flash_attention``, ``decode_attention``, ``ssd_chunk``
and ``rmsnorm``.  Oracles live in :mod:`repro_torch.kernels.ref`.

``flash_attention``, ``ssd_chunk`` and ``rmsnorm`` are differentiable,
so the model zoo trains through them: the forward runs the kernel (or,
on the CPU, its plain version).  Attention on bf16 tensors on the card
takes its backward from the kernel pair ``flash_attention_bwd``
(:class:`_FlashAttention`, the forward writing each row's log-sum-exp for
it); every other backward, attention's in f32 or on the CPU included,
recomputes the plain version and takes its gradient
(:class:`_PlainBackward`).  The choice follows the tensors' device and
type.  The kernel wrappers themselves stay forward-only, as the
reference's ``pallas_call`` is, and raise under autograd.

On a device mesh (DTensor operands) each op runs its kernel, or on the
CPU its plain version, on the local shard: the call is wrapped in
``local_map`` with placements that keep it local (:func:`_on_shards`),
and inputs laid out otherwise are redistributed first.  Attention takes
the batch over the data-parallel axes and the heads over ``"model"``
(under the context's ``attn_qseq``, the query sequence over ``"model"``
and k/v whole); rmsnorm the rows as they come and the feature dim whole;
the SSD block the batch and the heads; the factorized linear the basis
whole and the coefficient's output columns over ``"model"``.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import SMEM_DEFAULT, is_dtensor, use_kernel
from repro_torch.kernels.compose import (RA_COLS, RA_ROWS, _rank_apply_smem,
                                         compose, compose_dense_apply,
                                         rank_dense_apply)
from repro_torch.kernels.conv_rank import conv_rank_apply
from repro_torch.kernels.decode_attention import (
    decode_attention as decode_attention_kernel)
from repro_torch.kernels.flash_attention import (_flash_math,
                                                 flash_attention_bwd)
from repro_torch.kernels.flash_attention import (
    flash_attention as flash_attention_kernel)
from repro_torch.kernels.rmsnorm import _rmsnorm_math
from repro_torch.kernels.rmsnorm import rmsnorm as rmsnorm_kernel
from repro_torch.kernels.ssd_chunk import _ssd_math
from repro_torch.kernels.ssd_chunk import ssd_chunk as ssd_chunk_kernel
from repro_torch.obs.spans import span

__all__ = [
    "compose", "rank_dense_apply", "conv_rank_apply", "compose_dense_apply",
    "flash_attention", "decode_attention", "ssd_chunk", "rmsnorm",
    "ssd_chunk_blocks", "factorized_shards", "factorized_linear",
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
    matrix) for the backward's duration.  While a torch profiler records,
    the backward runs in the span ``plain_backward.<kernel's name>``
    (:mod:`repro_torch.obs.spans`)."""

    @staticmethod
    def forward(ctx, kernel, plain, kw, *tensors):
        ctx.plain, ctx.kw = plain, kw
        ctx.span_name = "plain_backward." + kernel.__name__
        ctx.save_for_backward(*tensors)
        return kernel(*tensors, **kw)

    @staticmethod
    def backward(ctx, grad):
        with span(ctx.span_name, grad.device):
            need = ctx.needs_input_grad[3:]
            tensors = [t.detach().requires_grad_(n)
                       for t, n in zip(ctx.saved_tensors, need)]
            with torch.enable_grad():
                out = ctx.plain(*tensors, **ctx.kw)
            grads = iter(torch.autograd.grad(
                out, [t for t in tensors if t.requires_grad], grad))
            return (None, None, None,
                    *(next(grads) if n else None for n in need))


class _FlashAttention(torch.autograd.Function):
    """Attention on bf16 tensors on the card with a kernel backward: the
    forward launches the flash kernel with its row log-sum-exp and saves
    q, k, v, the output and the log-sum-exp; the backward launches
    ``flash_attention_bwd`` (dq, dk, dv from two kernels, deterministic).
    The backward runs in the span ``plain_backward.flash_attention``, the
    name :class:`_PlainBackward` gives attention's replay, so a reader of
    that span times attention's backward whichever computes it."""

    @staticmethod
    def forward(ctx, kw, q, k, v):
        out, lse = flash_attention_kernel(q, k, v, with_lse=True, **kw)
        ctx.kw = kw
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, grad):
        with span("plain_backward.flash_attention", grad.device):
            q, k, v, out, lse = ctx.saved_tensors
            return (None, *flash_attention_bwd(q, k, v, out,
                                               grad.contiguous(), lse,
                                               **ctx.kw))


# ---------------------------------------------------------------------------
# local shards on a device mesh
# ---------------------------------------------------------------------------


def _dp(mesh):
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else "data"


def _placements(mesh, spec, shape) -> tuple:
    """``spec`` fitted to ``shape`` on ``mesh``, as DTensor placements."""
    from repro_torch.sharding.rules import (_fit_to_shape, mesh_axes,
                                            to_placements)
    return to_placements(_fit_to_shape(spec, shape, mesh_axes(mesh)), mesh)


def _on_shards(fn, mesh, out_placements, in_placements, *tensors):
    """``fn(*local shards)`` through ``local_map``: each input (a plain
    tensor taken as replicated) is redistributed to its placements first,
    and the output is the DTensor of the local results laid out by
    ``out_placements`` (the placements of one output, or a tuple of them
    for several).  An input whole over a mesh dim that another operand or
    the output is split over gets a partial gradient there (each device's
    gradient covers its own part), summed over that dim."""
    from torch.distributed.tensor import Partial, Placement, Replicate
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.sharding.context import as_dtensor
    single = all(isinstance(p, Placement) for p in out_placements)
    outs = [out_placements] if single else list(out_placements)
    split = [any(not isinstance(p[i], Replicate)
                 for p in (*in_placements, *outs))
             for i in range(mesh.ndim)]
    grads = tuple(tuple(Partial() if split[i] and isinstance(p, Replicate)
                        else p for i, p in enumerate(ps))
                  for ps in in_placements)
    # local_map reads a tuple as one entry per output, a list as the
    # placements of one output
    out_placements = (list(out_placements) if single
                      else tuple(list(p) for p in out_placements))
    return local_map(fn, out_placements=out_placements,
                     in_placements=in_placements,
                     in_grad_placements=grads, device_mesh=mesh,
                     redistribute_inputs=True)(
        *(as_dtensor(t, mesh) for t in tensors))


def _head_specs(mesh, KV, G):
    """Attention's (q, k/v) specs in model layout: the batch over the
    data-parallel axes, the KV heads over ``"model"`` where they divide,
    else the query group, else heads whole."""
    from repro_torch.sharding.rules import _axis_size, mesh_axes
    dp = _dp(mesh)
    m = _axis_size(mesh_axes(mesh), "model")
    if KV % m == 0:
        return ((dp, None, "model", None, None), (dp, None, "model", None))
    if G % m == 0:
        return ((dp, None, None, "model", None), (dp, None, None, None))
    return ((dp, None, None, None, None), (dp, None, None, None))


def _flash_on_shards(q, k, v, causal, window, kv_len):
    """:func:`flash_attention` on DTensors, each device on its shard."""
    from repro_torch.sharding.context import get_context
    mesh = q.device_mesh
    _, Sq, KV, G, _ = q.shape
    Sk = k.shape[1]
    qseq = get_context()["attn_qseq"] and Sq > 1 and kv_len is None
    if qseq:
        qp = _placements(mesh, (_dp(mesh), "model", None, None, None),
                         q.shape)
        qseq = any(getattr(p, "dim", None) == 1 for p in qp)
    if not qseq:
        qs, ks = _head_specs(mesh, KV, G)
        qp = _placements(mesh, qs, q.shape)
    else:
        ks = (_dp(mesh), None, None, None)
    kp = _placements(mesh, ks, k.shape)
    tensors, placements = [q, k, v], [qp, kp, kp]
    if kv_len is not None:
        tensors.append(kv_len)
        placements.append(_placements(mesh, (ks[0],), kv_len.shape))

    def local(ql, kl, vl, *lens):
        if qseq and (causal or window):
            # this device's queries are rows [j*c, (j+1)*c) of Sq: the
            # keys past the last of them are masked, and cutting them
            # aligns the local queries to the end of the local keys
            c = ql.shape[1]
            n = (mesh.get_local_rank("model") + 1) * c + Sk - Sq
            kl, vl = kl[:, :n], vl[:, :n]
        return flash_attention(ql, kl, vl, causal=causal, window=window,
                               kv_len=lens[0] if lens else None)

    return _on_shards(local, mesh, qp, tuple(placements), *tensors)


def _decode_on_shards(q, k_cache, v_cache, lengths):
    mesh = q.device_mesh
    _, _, KV, G, _ = q.shape
    qs, ks = _head_specs(mesh, KV, G)
    qp = _placements(mesh, qs, q.shape)
    kp = _placements(mesh, ks, k_cache.shape)
    lp = _placements(mesh, (ks[0],), lengths.shape)
    return _on_shards(decode_attention, mesh, qp, (qp, kp, kp, lp), q,
                      k_cache, v_cache, lengths)


def _rows_placements(x):
    """x's placements with its last dim made whole (and partial sums
    reduced): the rows stay where they are."""
    from torch.distributed.tensor import Replicate, Shard
    last = x.dim() - 1
    return tuple(p if isinstance(p, Shard) and p.dim != last else Replicate()
                 for p in x.placements)


def causal_conv_on_shards(conv, x: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """``conv(x, w, b)``, a depthwise causal conv over (B, T, C) with
    kernel (W, C), on DTensors: each rank convolves its own rows and
    channels (the batch over the data-parallel axes, the channels over
    ``"model"``; the card's torch has no plan for ``F.pad`` on a 2x16x16
    mesh)."""
    mesh = x.device_mesh
    xp = _placements(mesh, (_dp(mesh), None, "model"), x.shape)
    return _on_shards(conv, mesh, xp, (
        xp, _placements(mesh, (None, "model"), w.shape),
        _placements(mesh, ("model",), b.shape)), x, w, b)


def cumsum(x: Tensor, dim: int) -> Tensor:
    """``torch.cumsum(x, dim)``.  On a DTensor that no rank splits along
    ``dim`` each rank sums its own shard (the card's torch has no sharding
    rule for the ``flip`` of cumsum's backward)."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard
        d = dim % x.dim()
        if all(isinstance(p, Replicate) or (isinstance(p, Shard)
                                            and p.dim != d)
               for p in x.placements):
            return _on_shards(lambda t: torch.cumsum(t, d), x.device_mesh,
                              x.placements, (x.placements,), x)
    return torch.cumsum(x, dim)


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    window: int = 0,
                    kv_len: Optional[Tensor] = None) -> Tensor:
    """Model layout: q (B, Sq, KV, G, D), k/v (B, Sk, KV, D) -> (B, Sq,
    KV, G, D); queries align to the end of the keys.  ``kv_len`` (B,)
    keeps batch row ``b`` to its first ``kv_len[b]`` keys (every KV head
    of the row: expanded to the kernel's (B * KV,) rows, as
    :func:`decode_attention` expands ``lengths``)."""
    if is_dtensor(q):
        return _flash_on_shards(q, k, v, causal, window, kv_len)
    B, Sq, KV, G, D = q.shape
    Sk = k.shape[1]
    qf = q.permute(0, 2, 3, 1, 4).reshape(B * KV * G, Sq, D).contiguous()
    kf = k.permute(0, 2, 1, 3).reshape(B * KV, Sk, D).contiguous()
    vf = v.permute(0, 2, 1, 3).reshape(B * KV, Sk, D).contiguous()
    kw = dict(causal=causal, window=window, q_per_kv=G)
    if kv_len is not None:
        kw["kv_len"] = torch.repeat_interleave(
            kv_len.to(device=q.device, dtype=torch.int32), KV)
    if qf.dtype == torch.bfloat16 and use_kernel(qf) and \
            torch.is_grad_enabled() and any(
                t.requires_grad for t in (qf, kf, vf)):
        out = _FlashAttention.apply(kw, qf, kf, vf)
    else:  # a forward alone (no log-sum-exp written), f32, or the CPU
        out = _PlainBackward.apply(flash_attention_kernel, _flash_math, kw,
                                   qf, kf, vf)
    return out.reshape(B, KV, G, Sq, D).permute(0, 3, 1, 2, 4)


def decode_attention(q: Tensor, k_cache: Tensor, v_cache: Tensor,
                     lengths: Tensor) -> Tensor:
    """Model layout: q (B, 1, KV, G, D), caches (B, S, KV, D), lengths
    (B,) -> (B, 1, KV, G, D).  The kernel reads the caches as they are
    (no copy)."""
    if is_dtensor(q):
        return _decode_on_shards(q, k_cache, v_cache, lengths)
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
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate
        xp = _rows_placements(x)
        whole = (Replicate(),) * len(xp)
        return _on_shards(lambda xl, sl: rmsnorm(xl, sl, eps=eps),
                          x.device_mesh, xp, (xp, whole), x, scale)
    return _PlainBackward.apply(rmsnorm_kernel, _rmsnorm_math,
                                dict(eps=eps), x.contiguous(), scale)


def ssd_chunk_blocks(cc: Tensor, bc: Tensor, xc: Tensor, cum: Tensor,
                     h_in: Tensor) -> Tensor:
    """:func:`ssd_chunk` on the blocks of
    :func:`repro_torch.models.ssm.ssd_chunked`: cc/bc (B, nc, Q, N) (one
    group shared by the heads), xc (B, nc, Q, H, P), cum (B, nc, Q, H)
    f32, h_in (B, nc, H, N, P) -> y (B, nc, Q, H, P).  On a device mesh
    the batch goes over the data-parallel axes and the heads over
    ``"model"``."""
    if is_dtensor(xc):
        mesh = xc.device_mesh
        dp = _dp(mesh)
        xp = _placements(mesh, (dp, None, None, "model", None), xc.shape)
        return _on_shards(ssd_chunk_blocks, mesh, xp, (
            _placements(mesh, (dp, None, None, None), cc.shape),
            _placements(mesh, (dp, None, None, None), bc.shape), xp,
            _placements(mesh, (dp, None, None, "model"), cum.shape),
            _placements(mesh, (dp, None, "model", None, None), h_in.shape)),
            cc, bc, xc, cum, h_in)
    Bsz, nc, Q, H, P = xc.shape
    N = cc.shape[-1]
    # rows (b, c, h); B and C once per (b, c), shared by its H heads
    y = ssd_chunk(
        cc.reshape(Bsz * nc, Q, N), bc.reshape(Bsz * nc, Q, N),
        xc.permute(0, 1, 3, 2, 4).reshape(Bsz * nc * H, Q, P),
        cum.permute(0, 1, 3, 2).reshape(Bsz * nc * H, Q),
        h_in.reshape(Bsz * nc * H, N, P), heads=H)
    return y.reshape(Bsz, nc, H, Q, P).permute(0, 1, 3, 2, 4)


def _rank_chunks(I: int, R: int, g: int) -> tuple:
    """(I, R) chunk sizes whose rank_apply block keeps its full row tile
    within the default shared memory (the kernel holds the basis chunk
    whole, and every block of a launch loads it): halved from the whole
    basis, the larger first."""
    i, r = I, R
    while _rank_apply_smem(g, i, r, RA_ROWS, RA_COLS) > SMEM_DEFAULT:
        if r >= i and r % 2 == 0:
            r //= 2
        elif i % 2 == 0:
            i //= 2
        else:
            raise ValueError(f"rank_apply: basis ({I}, {R}) has no chunk "
                             "that fits shared memory")
    return i, r


def _rank_apply_chunked(x: Tensor, basis: Tensor, coeff: Tensor,
                        p: int) -> Tensor:
    """``rank_dense_apply`` of x (..., p*I), basis (I, R) and coeff
    (p*p, R, O) as a sum over basis chunks that fit the kernel's shared
    memory: y = sum over I chunks c and R chunks r of (x_c . v_cr) . u_r,
    the product being linear in each."""
    I, R = basis.shape
    ci, cr = _rank_chunks(I, R, p)
    xa = x.reshape(*x.shape[:-1], p, I)
    y = None
    for i0 in range(0, I, ci):
        xc = xa[..., i0:i0 + ci].reshape(*x.shape[:-1], -1)
        for r0 in range(0, R, cr):
            part = rank_dense_apply(xc, basis[None, i0:i0 + ci, r0:r0 + cr],
                                    coeff[:, r0:r0 + cr], p)
            y = part if y is None else y + part
    return y


def factorized_shards(x: Tensor, basis: Tensor, coeff: Tensor,
                      p: int) -> Tensor:
    """The zoo's factorized linear ``y[(b,o)] = sum_a (x_a . v) . u_ab``
    (:func:`repro_torch.models.module.linear`) through the rank_apply
    kernel on the local shards of a device mesh: x with its batch over
    the data-parallel axes and its features whole, the basis (I, R)
    whole, the coefficient (p*p, R, O) with O over ``"model"``.  Returns
    y as (..., p, O), laid out as the batch and the coefficient's O: each
    device holds its rows' O columns of every block, no collective."""
    mesh = x.device_mesh
    from torch.distributed.tensor import Replicate
    whole = (Replicate(),) * mesh.ndim
    lead = x.dim() - 1
    dp = _dp(mesh)
    xp = _placements(mesh, (dp,) + (None,) * lead, x.shape)
    cp = _placements(mesh, (None, None, "model"), coeff.shape)
    yshape = tuple(x.shape[:-1]) + (p, coeff.shape[2])
    yp = _placements(mesh, (dp,) + (None,) * lead + ("model",), yshape)

    def local(xl, bl, cl):  # the kernel computes in f32
        y = _rank_apply_chunked(xl.float(), bl.float(), cl.float(), p)
        return y.to(xl.dtype).reshape(*y.shape[:-1], p, -1)

    return _on_shards(local, mesh, yp, (xp, whole, cp), x, basis, coeff)


def factorized_linear(x: Tensor, basis: Tensor, coeff: Tensor,
                      p: int) -> Tensor:
    """:func:`factorized_shards`, its output (..., p*O) gathered over
    ``"model"`` (its p blocks of O columns interleave) with its batch
    left split.  The kernel takes the operands in f32 and rounds y once to
    x's type, where the one-device einsum rounds x.v too."""
    mesh = x.device_mesh
    dp = _dp(mesh)
    y = factorized_shards(x, basis, coeff, p)
    y = y.redistribute(mesh, _placements(
        mesh, (dp,) + (None,) * (x.dim() - 1) + (None,), y.shape))
    return y.reshape(*x.shape[:-1], -1)
