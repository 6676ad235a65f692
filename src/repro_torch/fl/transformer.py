"""Federated composed transformer: the LLM stack as an ``FLModelDef``.

Heroes' neural composition is low-rank adaptation — every weight is a sum
of shared rank-R basis tensors and per-width coefficient blocks — so a
decoder-only transformer maps onto :class:`~repro_torch.fl.models.
ComposedLayer` directly:

  =================  =========  =======================================
  layer              spec mode  shape at width p
  =================  =========  =======================================
  embed              grow_out   (vocab, p*d_base) — vocab-anchored
  l{i}.wq/wk/wv/wo   square     (p*d_base, p*d_base), p^2 blocks
  l{i}.up            square     (p*d_base, p*ff_base)
  l{i}.down          square     (p*ff_base, p*d_base)
  head               grow_in    (p*d_base, vocab) — vocab-anchored
  =================  =========  =======================================

Width p scales the model dimension (``d_p = p * d_base``) by scaling the
head count (``H_p = p * heads_base``) at fixed head_dim, so RoPE angles
and the attention kernels are width-independent.  Training attention is
the plain chunked streaming softmax
(:func:`repro_torch.models.attention.flash_attention`, differentiable);
norms are parameter-free RMSNorm, so every parameter lives in a
composition spec.

Serving: :func:`serving_weights` composes the per-width dense weights
once, then :func:`greedy_decode` runs token-by-token greedy decode with a
per-layer KV cache through the decode-attention kernel
(:func:`repro_torch.kernels.decode_attention.decode_attention`).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.fl.models import (ComposedLayer, CompositionSpec,
                                   FLModelDef, LayerHint, register_model)
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.ref import decode_attention_ref
from repro_torch.models.attention import (apply_rotary, flash_attention,
                                          rope_angles)

Tensor = torch.Tensor

ROPE_THETA = 10000.0
RMS_EPS = 1e-6
DECODE_BACKENDS = ("kernel", "inline")


class TransformerArch(NamedTuple):
    """Static geometry the decode path needs back out of a model def."""

    d_base: int
    heads_base: int
    head_dim: int
    n_layers: int
    ff_base: int
    vocab: int
    seq_ref: int


# keyed by model identity (FLModelDef hashes by identity and the factory
# is memoized, so instances persist for the process lifetime)
_ARCH: Dict[FLModelDef, TransformerArch] = {}


def arch_of(model: FLModelDef) -> TransformerArch:
    try:
        return _ARCH[model]
    except KeyError:
        raise ValueError(
            f"model {model.name!r} was not built by make_transformer") from None


def _rms(x: Tensor) -> Tensor:
    """Parameter-free RMSNorm (keeps all params inside composition specs)."""
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + RMS_EPS)


def _gelu(x: Tensor) -> Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


@functools.lru_cache(maxsize=None)
def make_transformer(max_width: int = 3, d_base: int = 16,
                     heads_base: int = 2, n_layers: int = 2,
                     ff_mult: int = 2, rank: int = 8, vocab: int = 64,
                     seq_ref: int = 32) -> FLModelDef:
    """Decoder-only transformer as composed rank-R blocks.

    ``head_dim = d_base // heads_base`` must be even (RoPE rotates
    half-pairs); width scales heads, not head_dim.
    """
    if d_base % heads_base != 0:
        raise ValueError(f"d_base={d_base} not divisible by "
                         f"heads_base={heads_base}")
    head_dim = d_base // heads_base
    if head_dim % 2 != 0:
        raise ValueError(f"head_dim={head_dim} must be even for RoPE")
    ff_base = ff_mult * d_base

    seq_len = lambda s: s[1]  # noqa: E731 — tokens (B, T)
    proj_hint = LayerHint(seq_ref, seq_len)

    layers: Dict[str, ComposedLayer] = {
        "embed": ComposedLayer(
            "embed",
            CompositionSpec(max_width, rank, vocab, d_base, ksq=1,
                            mode="grow_out"),
            kind="embed",
            hint=LayerHint(seq_ref, seq_len, dense_apply_free=True,
                           basis_gather=True)),
    }
    for i in range(n_layers):
        for proj in ("wq", "wk", "wv", "wo"):
            layers[f"l{i}.{proj}"] = ComposedLayer(
                f"l{i}.{proj}",
                CompositionSpec(max_width, rank, d_base, d_base, ksq=1),
                hint=proj_hint)
        layers[f"l{i}.up"] = ComposedLayer(
            f"l{i}.up",
            CompositionSpec(max_width, rank, d_base, ff_base, ksq=1),
            hint=proj_hint)
        layers[f"l{i}.down"] = ComposedLayer(
            f"l{i}.down",
            CompositionSpec(max_width, rank, ff_base, d_base, ksq=1),
            hint=proj_hint)
    layers["head"] = ComposedLayer(
        "head",
        CompositionSpec(max_width, rank, d_base, vocab, ksq=1,
                        mode="grow_in"),
        hint=proj_hint)

    def forward(w: Dict[str, Any], width: int, batch) -> Tensor:
        tokens = batch["tokens"]  # (B, T)
        B, T = tokens.shape
        heads = width * heads_base
        x = layers["embed"].apply(w["embed"], tokens, width)  # (B,T,pD)
        pos = torch.arange(T, dtype=torch.int32, device=x.device)[None, :]
        cos, sin = rope_angles(pos, head_dim, ROPE_THETA)
        for i in range(n_layers):
            h = _rms(x)
            q = layers[f"l{i}.wq"].apply(w[f"l{i}.wq"], h, width)
            k = layers[f"l{i}.wk"].apply(w[f"l{i}.wk"], h, width)
            v = layers[f"l{i}.wv"].apply(w[f"l{i}.wv"], h, width)
            q = apply_rotary(q.reshape(B, T, heads, head_dim), cos, sin)
            k = apply_rotary(k.reshape(B, T, heads, head_dim), cos, sin)
            v = v.reshape(B, T, heads, head_dim)
            # flash layout (B, S, KV, G, D) with one query head per KV head
            att = flash_attention(q[:, :, :, None, :], k, v, causal=True)
            att = att.reshape(B, T, heads * head_dim)
            x = x + layers[f"l{i}.wo"].apply(w[f"l{i}.wo"], att, width)
            h2 = _rms(x)
            u = _gelu(layers[f"l{i}.up"].apply(w[f"l{i}.up"], h2, width))
            x = x + layers[f"l{i}.down"].apply(w[f"l{i}.down"], u, width)
        x = _rms(x)
        return layers["head"].apply(w["head"], x, width)  # (B,T,V)

    def flops(width: int, seq: int = seq_ref) -> int:
        p = width
        d, ff = p * d_base, p * ff_base
        # per token: 4 square attn projections + QK^T/AV over the
        # sequence + MLP up/down + LM head (embedding is a gather)
        per_tok = n_layers * (8 * d * d + 4 * seq * d + 4 * d * ff)
        per_tok += 2 * d * vocab
        return 3 * per_tok * seq

    model = FLModelDef.from_layers("transformer", layers, forward, flops,
                                   vocab, input_key="tokens")
    _ARCH[model] = TransformerArch(d_base, heads_base, head_dim, n_layers,
                                   ff_base, vocab, seq_ref)
    return model


@register_model("transformer", modality="text")
def _build_transformer(max_width: int, meta: Dict[str, Any],
                       **kw) -> FLModelDef:
    return make_transformer(max_width=max_width, vocab=meta["vocab"], **kw)


# ---------------------------------------------------------------------------
# serving: compose once, decode through the decode-attention kernel
# ---------------------------------------------------------------------------


def serving_weights(model: FLModelDef, params, width: int, *,
                    factorized: bool = True) -> Dict[str, Tensor]:
    """Per-width dense weights for serving, composed once.

    ``factorized=True`` takes server-side (basis, coeff) params — the
    Heroes state — reduces the width-p leading blocks (the ids the
    aggregators evaluate with) and composes every layer.
    ``factorized=False`` takes dense params and slices the width-p
    sub-model (HeteroFL-style).
    """
    if not factorized:
        return model.slice_dense(params, width)
    square = next(s for s in model.specs.values() if s.mode == "square")
    hidden = np.arange(square.blocks_for_width(width))
    anchored = np.arange(min(width, square.max_width))
    reduced = model.reduce(params, width, hidden, anchored)
    return model.compose_all(reduced, width)


def _decode_step(weights: Dict[str, Tensor], ck: List[Tensor],
                 cv: List[Tensor], tok: Tensor, t: int, *,
                 model: FLModelDef, width: int,
                 backend: str) -> Tuple[Tensor, Tensor]:
    """One greedy decode step.

    tok (B,) tokens, t the number of tokens already cached.  Caches are
    per-layer ``(B*H, Smax, head_dim)`` in the decode kernel's layout.
    Where the reference returns caches updated by ``dynamic_update_slice``,
    this writes the step's keys and values into ``ck[i]``/``cv[i]`` in
    place (``ck[i][:, t] = ...``): no per-step copy of the cache.
    Returns (next_token (B,), logits (B, V)).
    """
    arch = _ARCH[model]
    B = tok.shape[0]
    heads = width * arch.heads_base
    hd = arch.head_dim
    x = weights["embed"][0][tok.long()][:, None, :]  # (B,1,pD)
    pos = torch.full((1, 1), t, dtype=torch.int32, device=x.device)
    cos, sin = rope_angles(pos, hd, ROPE_THETA)
    lengths = torch.full((B * heads,), t + 1, dtype=torch.int32,
                         device=x.device)
    for i in range(arch.n_layers):
        h = _rms(x)
        q = (h @ weights[f"l{i}.wq"][0]).reshape(B, 1, heads, hd)
        k = (h @ weights[f"l{i}.wk"][0]).reshape(B, 1, heads, hd)
        v = (h @ weights[f"l{i}.wv"][0]).reshape(B, 1, heads, hd)
        q = apply_rotary(q, cos, sin)
        k = apply_rotary(k, cos, sin)
        # cache rows (B*H, S, D): batch-of-heads, the kernel's row axis
        ck[i][:, t] = k.reshape(B * heads, hd)
        cv[i][:, t] = v.reshape(B * heads, hd)
        q_row = q.reshape(B * heads, hd)
        if backend == "kernel":
            att = decode_attention(q_row, ck[i], cv[i], lengths)
        else:  # the reference's inline softmax: the kernel's oracle
            att = decode_attention_ref(q_row, ck[i], cv[i], lengths)
        att = att.to(x.dtype).reshape(B, 1, heads * hd)
        x = x + att @ weights[f"l{i}.wo"][0]
        h2 = _rms(x)
        u = _gelu(h2 @ weights[f"l{i}.up"][0])
        x = x + u @ weights[f"l{i}.down"][0]
    x = _rms(x)
    logits = (x @ weights["head"][0])[:, 0, :]  # (B, V)
    return torch.argmax(logits, dim=-1), logits


def greedy_decode(model: FLModelDef, weights: Dict[str, Tensor], width: int,
                  prompt, steps: int, *, backend: str = "kernel",
                  max_len: int | None = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Token-by-token greedy decode over composed width-p weights.

    prompt (B, T0) ints; generates ``steps`` tokens on the weights'
    device.  ``backend="kernel"`` streams the KV cache through the
    decode-attention wrapper (the CUDA kernel on the card, its plain
    version on the CPU); ``"inline"`` is the reference's inline softmax,
    the parity oracle.  The prompt is prefilled through the same decode
    step, so the kernel serves every position.

    Returns ``(tokens (B, steps) int32, last_logits (B, V))`` as numpy.
    """
    if backend not in DECODE_BACKENDS:
        raise ValueError(f"unknown decode backend {backend!r} "
                         f"(expected one of {DECODE_BACKENDS})")
    arch = arch_of(model)
    device = weights["embed"].device
    prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.int32,
                             device=device)
    B, t0 = prompt.shape
    if t0 < 1:
        raise ValueError("prompt must hold at least one token")
    total = t0 + steps
    smax = max_len or total
    if smax < total:
        raise ValueError(f"max_len={smax} < prompt+steps={total}")
    heads = width * arch.heads_base
    dtype = weights["embed"].dtype
    ck = [torch.zeros((B * heads, smax, arch.head_dim), dtype=dtype,
                      device=device) for _ in range(arch.n_layers)]
    cv = [torch.zeros_like(c) for c in ck]
    out = []
    logits = None
    nxt = prompt[:, 0]
    with torch.no_grad():
        for t in range(total - 1):
            tok = prompt[:, t] if t < t0 else nxt
            nxt, logits = _decode_step(weights, ck, cv, tok, t, model=model,
                                       width=width, backend=backend)
            if t >= t0 - 1:
                out.append(nxt)
    return (torch.stack(out, dim=1).to(torch.int32).cpu().numpy(),
            logits.float().cpu().numpy())
