"""Minimal functional module system, in PyTorch.

Parameters are plain nested dicts of tensors.  Layers are functions
``apply(params, x, ...)``; initialisers are functions ``init(gen, ...) ->
params`` that draw from an explicit :class:`torch.Generator` (on the
device the parameters are made on).  Stacked-layer models store every
layer's params with a leading ``L`` axis, as the reference does for its
``lax.scan``; the port walks that axis with a Python loop.

Factorized linears (Heroes neural composition) are supported as in the
reference: a linear's params are either ``{"w": (din, dout)}`` (dense) or
``{"basis": (I, R), "coeff": (m, R, O)}`` (factorized, m = p^2 blocks at
width p).  The factorized forward never materialises the composed
weight::

    y[(b,o)] = sum_a (x_a @ v) @ u_{ab}

It is the reference's einsum (no Pallas kernel there), so it stays plain
PyTorch here; on a device mesh (DTensor params) it runs the rank_apply
kernel on the local shards instead (:func:`repro_torch.kernels.ops.
factorized_linear`), as no einsum reaches a kernel there.  The paper's own forward, composing the weight first and
multiplying by it, is a switch (:func:`set_compose_then_matmul`); on a
CUDA tensor it composes through the port's compose kernel.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict

import torch

from repro_torch.core.composition import CompositionSpec, init_factors
from repro_torch.core.estimator import tree_leaves, tree_map
from repro_torch.kernels import ops

Tensor = torch.Tensor
Params = Dict[str, Any]


# the most elements one f32 draw of :func:`normal` makes (256 MB)
DRAW_CHUNK = 1 << 26


def normal(gen: torch.Generator, shape, dtype, std: float = 1.0) -> Tensor:
    """``std`` * standard normal draws from ``gen``, on its device.  A
    tensor of more than ``DRAW_CHUNK`` elements is filled in flat chunks
    of that many draws, so its peak is itself and one f32 chunk: a bf16
    expert stack of 5.6e9 elements never holds an f32 copy (22.5 GB)."""
    n = math.prod(shape)
    if n <= DRAW_CHUNK:
        t = torch.randn(shape, generator=gen, device=gen.device,
                        dtype=torch.float32)
        return (std * t).to(dtype)
    out = torch.empty(n, dtype=dtype, device=gen.device)
    for i in range(0, n, DRAW_CHUNK):
        out[i:i + DRAW_CHUNK] = normal(gen, (min(DRAW_CHUNK, n - i),), dtype,
                                       std)
    return out.view(shape)


# ---------------------------------------------------------------------------
# dense linear
# ---------------------------------------------------------------------------


def init_linear(gen, d_in: int, d_out: int, dtype) -> Params:
    return {"w": normal(gen, (d_in, d_out), dtype, 1.0 / math.sqrt(d_in))}


def init_embedding(gen, vocab: int, d: int, dtype) -> Params:
    # d^-0.5 keeps tied-unembed logits O(1) at init
    return {"table": normal(gen, (vocab, d), dtype, d ** -0.5)}


# ---------------------------------------------------------------------------
# factorized linear (Heroes)
# ---------------------------------------------------------------------------


def comp_spec_for(d_in: int, d_out: int, max_width: int,
                  rank: int) -> CompositionSpec:
    """Spec of a factorized linear whose *full-width* (p=P) weight is
    (d_in, d_out): base_in = d_in / P, base_out = d_out / P."""
    if d_in % max_width or d_out % max_width:
        raise ValueError(f"dims ({d_in},{d_out}) not divisible by "
                         f"P={max_width}")
    return CompositionSpec(max_width=max_width, rank=rank,
                           base_in=d_in // max_width,
                           base_out=d_out // max_width, ksq=1)


def init_factorized_linear(gen, d_in: int, d_out: int, max_width: int,
                           rank: int, width: int, dtype) -> Params:
    """Init at active width ``width`` (p^2 leading blocks)."""
    spec = comp_spec_for(d_in, d_out, max_width, rank)
    v, u = init_factors(gen, spec, gen.device)
    m = width * width
    return {"basis": v[0].to(dtype), "coeff": u[:m].to(dtype)}


# Paper-faithful forward: materialise w_p = compose(v, u) then x @ w_p.
# Default (False) is the factorized forward x@v@u, as in the reference.
_COMPOSE_THEN_MATMUL = False


def set_compose_then_matmul(value: bool) -> None:
    global _COMPOSE_THEN_MATMUL
    _COMPOSE_THEN_MATMUL = value


def composed_weight(basis: Tensor, coeff: Tensor, p: int) -> Tensor:
    """The composed p-width weight ``w[(a,i),(b,o)] = sum_r v[i,r]
    u[(a,b),r,o]`` (paper Fig. 1; the reference's einsum
    ``ir,abro->aibo``), (p*I, p*O) in f32: the compose kernel's (1, I,
    p^2*O) product of the basis and the blocks on a CUDA tensor (its
    plain version on the CPU), rearranged; differentiable through the
    compose wrapper's backward.  The kernel composes in f32, so the
    factors are taken in f32 whatever their type."""
    I, R = basis.shape
    O = coeff.shape[2]
    if ops.is_dtensor(basis):  # a mesh: compose the whole weight locally
        from torch.distributed.tensor import Replicate
        whole = (Replicate(),) * basis.device_mesh.ndim
        w = ops._on_shards(lambda b, c: ops.compose(b.float()[None],
                                                    c.float()),
                           basis.device_mesh, whole, (whole, whole), basis,
                           coeff)
    else:
        w = ops.compose(basis.float()[None], coeff.float())  # (1, I, p*p*O)
    return (w.reshape(I, p, p, O).permute(1, 0, 2, 3)
            .reshape(p * I, p * O))


def linear(params: Params, x: Tensor, width: int = 0) -> Tensor:
    """Apply dense or factorized linear.  ``x``: (..., d_in).  With
    :func:`set_compose_then_matmul` on, a factorized linear composes its
    weight first (:func:`composed_weight`, rounded to x's type) and
    multiplies by it."""
    if "w" in params:
        return x @ params["w"].to(x.dtype)
    basis, coeff = params["basis"], params["coeff"]
    p = width or math.isqrt(coeff.shape[0])
    if p * p != coeff.shape[0]:
        raise ValueError("coeff blocks must be a square count")
    I = basis.shape[0]
    R, O = coeff.shape[1], coeff.shape[2]
    *lead, d_in = x.shape
    if d_in != p * I:
        raise ValueError(f"x dim {d_in} != p*I = {p}*{I}")
    if _COMPOSE_THEN_MATMUL:
        return x @ composed_weight(basis, coeff, p).to(x.dtype)
    if ops.is_dtensor(x):
        return ops.factorized_linear(x, basis, coeff, p)
    u = coeff.to(x.dtype).reshape(p, p, R, O)
    xa = x.reshape(*lead, p, I)
    z = torch.einsum("...ai,ir->...ar", xa, basis.to(x.dtype))
    y = torch.einsum("...ar,abro->...bo", z, u)
    return y.reshape(*lead, p * O)


def linear_out_dim(params: Params, width: int = 0) -> int:
    if "w" in params:
        return params["w"].shape[1]
    p = width or math.isqrt(params["coeff"].shape[0])
    return p * params["coeff"].shape[2]


def maybe_factorized(gen, d_in: int, d_out: int, cfg, dtype) -> Params:
    """Init a linear honouring cfg.composition (every projection of the
    zoo, so Heroes composition is a first-class switch)."""
    c = cfg.composition
    if not c.enabled:
        return init_linear(gen, d_in, d_out, dtype)
    return init_factorized_linear(gen, d_in, d_out, c.max_width,
                                  cfg.comp_rank, cfg.comp_width, dtype)


# ---------------------------------------------------------------------------
# stacked init: an initialiser run ``num`` times, stacked on a leading axis
# ---------------------------------------------------------------------------


def stacked_init(init_fn: Callable, gen, num: int, *args, **kwargs):
    """``num`` draws of ``init_fn``, each leaf stacked ``(num, ...)``.
    Each layer is written into the stack as soon as it is drawn, so the
    peak is the stack and one layer; one layer is stacked without a
    copy."""
    first = init_fn(gen, *args, **kwargs)
    if num == 1:
        return tree_map(lambda x: x.unsqueeze(0).detach(), first)
    out = tree_map(lambda x: x.new_empty((num, *x.shape)), first)
    tree_map(lambda o, x: o[0].copy_(x), out, first)
    del first
    for i in range(1, num):
        tree_map(lambda o, x: o[i].copy_(x), out,
                 init_fn(gen, *args, **kwargs))
    return out


def count_params(params) -> int:
    return sum(x.numel() for x in tree_leaves(params))


def param_bytes(params) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(params))
