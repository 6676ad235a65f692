"""Plain reference of the Heroes-composed StableLM training step.

Independent of the program under test: it imports neither ``repro_torch``
nor the JAX package.  From the benchmark's inputs (the initial
parameters and the token batches, made from the seed) it trains the
published architecture, with the configuration's ``as_run`` departures
(full rotary, LayerNorm epsilon 1e-6), in float32 with TF32 off:

- token embedding; per layer a pre-norm LayerNorm, causal self-attention
  with rotary position angles on every head dimension, a residual add, a
  second LayerNorm and a SwiGLU MLP with a residual add; a final
  LayerNorm and an untied output head; the mean next-token cross-entropy;
- every projection factorized as Heroes composes it at the full width p
  of P blocks (Eq. 4 applied without materialising the weight): the
  input's p groups through the shared basis ``v`` (I x R), then the block
  ``u[a, b]`` (R x O) from group ``a`` to output group ``b``;
- AdamW (b1 0.9, b2 0.999, eps 1e-8, no weight decay) on the cosine
  schedule with linear warm-up.

Each layer runs under ``torch.utils.checkpoint`` and attention one batch
row at a time, so the whole step fits beside nothing else on the card.

``control=True`` computes every product (the projections, the attention
scores and values, the head) on operands rounded to FP8 with a scale per
tensor, E4M3 forward and E5M2 for the gradients in the backward: the
precision below the configuration's bfloat16 compute, which the limits
must reject.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def _fp8(x, dtype):
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = torch.finfo(dtype).max / amax
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


class _RoundIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundGradIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2)


def _product(fn, control, *operands):
    if not control:
        return fn(*operands)
    return _RoundGradIn.apply(fn(*[_RoundIn.apply(o) for o in operands]))


def layernorm(x, scale, bias, eps):
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, unbiased=False, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def factorized(x, basis, coeff, p, control):
    """x (..., p I) times the composed (p I, p O) weight, as (x v) u."""
    I, R = basis.shape
    O = coeff.shape[-1]
    xa = x.reshape(*x.shape[:-1], p, I)
    z = _product(lambda a, b: torch.einsum("...ai,ir->...ar", a, b),
                 control, xa, basis)
    u = coeff.reshape(p, p, R, O)
    y = _product(lambda a, b: torch.einsum("...ar,abro->...bo", a, b),
                 control, z, u)
    return y.reshape(*x.shape[:-1], p * O)


def rotary(x, cos, sin):
    """Rotate-half convention; x (S, H, D), cos/sin (S, D/2)."""
    d = x.shape[-1] // 2
    x1, x2 = x[..., :d], x[..., d:]
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def attention(q, k, v, control):
    """Causal softmax attention of one row; q, k, v (S, H, D)."""
    S, H, D = q.shape
    q, k, v = (t.transpose(0, 1) for t in (q, k, v))
    s = _product(lambda a, b: a @ b.transpose(-1, -2), control, q, k)
    s = s * D ** -0.5
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).triu(1)
    p = torch.softmax(s.masked_fill(mask, float("-inf")), dim=-1)
    return _product(lambda a, b: a @ b, control, p, v).transpose(0, 1)


def layer(lp, x, cos, sin, c, control):
    p = c["heroes_composition"]["width"]
    H = c["num_attention_heads"]
    eps = c["layer_norm_eps"]
    B, S, d = x.shape
    hd = d // H

    def lin(name, t):
        w = lp[name]
        return factorized(t, w["basis"], w["coeff"], p, control)

    h = layernorm(x, lp["ln1_scale"], lp["ln1_bias"], eps)
    outs = []
    for b in range(B):
        q = rotary(lin("wq", h[b]).reshape(S, H, hd), cos, sin)
        k = rotary(lin("wk", h[b]).reshape(S, H, hd), cos, sin)
        v = lin("wv", h[b]).reshape(S, H, hd)
        outs.append(attention(q, k, v, control).reshape(S, d))
    x = x + lin("wo", torch.stack(outs))
    h = layernorm(x, lp["ln2_scale"], lp["ln2_bias"], eps)
    return x + lin("down", F.silu(lin("gate", h)) * lin("up", h))


def angles(S, hd, theta, device):
    half = hd // 2
    inv = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                  device=device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=device)[:, None] * inv
    return torch.cos(ang), torch.sin(ang)


def loss_fn(params, tokens, labels, c, control):
    L = c["num_hidden_layers"]
    d = c["hidden_size"]
    cos, sin = angles(tokens.shape[1], d // c["num_attention_heads"],
                      float(c["rope_theta"]), tokens.device)
    x = params["embed"][tokens]
    for i in range(L):
        lp = {"ln1_scale": params["ln1_scale"][i],
              "ln1_bias": params["ln1_bias"][i],
              "ln2_scale": params["ln2_scale"][i],
              "ln2_bias": params["ln2_bias"][i]}
        for name in ("wq", "wk", "wv", "wo", "gate", "up", "down"):
            lp[name] = {"basis": params[name + ".basis"][i],
                        "coeff": params[name + ".coeff"][i]}
        x = checkpoint(layer, lp, x, cos, sin, c, control,
                       use_reentrant=False)
    x = layernorm(x, params["final_scale"], params["final_bias"],
                  c["layer_norm_eps"])
    logits = _product(lambda a, b: a @ b.t(), control, x, params["unembed"])
    logz = torch.logsumexp(logits, -1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return (logz - gold).mean()


def lr_at(traffic, s):
    """The cosine schedule with linear warm-up at step count ``s``."""
    base, warm_n = traffic["lr"], traffic["warmup_steps"]
    total = traffic["schedule_steps"]
    s = float(s)
    warm = min((s + 1) / max(warm_n, 1), 1.0)
    t = min(max((s - warm_n) / max(total - warm_n, 1), 0.0), 1.0)
    return base * warm * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi * t)))


def follow(params, batches, c, traffic, control=False, b1=0.9, b2=0.999,
           eps=1e-8):
    """Train ``len(batches)`` AdamW steps from ``params`` (name -> f32
    tensor, updated in place).  Returns each step's loss and the first
    step's gradient norm of each parameter, in ``params``' order.  The
    configuration's ``as_run`` values stand over the published ones."""
    c = {**c, **c.get("as_run", {})}
    if c["partial_rotary_factor"] != 1.0:
        raise ValueError("the reference rotates every head dimension")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    names = list(params)
    m = {n: torch.zeros_like(params[n]) for n in names}
    v = {n: torch.zeros_like(params[n]) for n in names}
    losses, grad_norms = [], None
    for step, (tokens, labels) in enumerate(batches, start=1):
        leaves = [params[n].requires_grad_() for n in names]
        loss = loss_fn(params, tokens, labels, c, control)
        grads = torch.autograd.grad(loss, leaves)
        losses.append(float(loss.detach()))
        if grad_norms is None:
            grad_norms = [float(torch.linalg.vector_norm(g)) for g in grads]
        lr = lr_at(traffic, step)
        with torch.no_grad():
            for n, g in zip(names, grads):
                params[n].requires_grad_(False)
                m[n].mul_(b1).add_((1 - b1) * g)
                v[n].mul_(b2).add_((1 - b2) * g * g)
                upd = (m[n] / (1 - b1 ** step)) / (
                    torch.sqrt(v[n] / (1 - b2 ** step)) + eps)
                params[n].sub_(lr * upd)
        del grads, leaves
    return {"losses": losses, "grad_norms": grad_norms}
