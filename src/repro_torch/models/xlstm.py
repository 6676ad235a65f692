"""xLSTM blocks: mLSTM (matrix memory, parallelizable) and sLSTM (scalar
memory, sequential recurrence)  [arXiv:2405.04517], in PyTorch.

mLSTM trains with the stabilized parallel (quadratic) form::

    D[t,s] = sum_{r=s+1..t} log sig(f_r) + i_s          (s <= t)
    m_t    = max_s D[t,s]
    Ctil   = exp(D - m_t) * (q_t . k_s) / sqrt(d)
    h_t    = (Ctil @ v) / max(|sum_s Ctil|, exp(-m_t))

and decodes with the O(1) recurrence carrying (C, n, m).  sLSTM is
inherently sequential: a host loop over time with per-head recurrent
weights, the form of the reference's ``lax.scan`` (the paper's own
structure; there is no parallel form).

Block layouts follow the xLSTM paper: mLSTM blocks are pre-LN residual
with an up-projection, causal conv on the q/k path and output gating;
sLSTM blocks are pre-LN residual followed by a gated feed-forward.  The
mLSTM's ``out_norm`` and the sLSTM's ``gn`` are RMSNorms, so they run
the RMSNorm kernel on a CUDA tensor (``layers.apply_norm``); the gate
arithmetic stays in f32 where the reference keeps it there (the
stabiliser ``m`` starts at -1e30).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import layers, module

Tensor = torch.Tensor
Params = Dict[str, Any]


def mlstm_dims(cfg) -> Tuple[int, int, int, int]:
    """(d_up, n_heads, d_qk per head, d_v per head)."""
    x = cfg.xlstm
    d_up = 2 * cfg.d_model
    H = cfg.num_heads
    dqk = int(d_up * x.qk_dim_factor) // H
    dv = int(d_up * x.v_dim_factor) // H
    return d_up, H, dqk, dv


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def init_mlstm(gen, cfg, dtype) -> Params:
    d = cfg.d_model
    d_up, H, dqk, dv = mlstm_dims(cfg)
    dev = gen.device
    return {
        "norm": layers.init_norm(d, cfg.norm, dtype, dev),
        "up": module.maybe_factorized(gen, d, 2 * d_up, cfg, dtype),
        "conv_w": module.normal(gen, (4, d_up), dtype, 0.1),
        "conv_b": torch.zeros((d_up,), dtype=dtype, device=dev),
        "wq": module.maybe_factorized(gen, d_up, H * dqk, cfg, dtype),
        "wk": module.maybe_factorized(gen, d_up, H * dqk, cfg, dtype),
        "wv": module.maybe_factorized(gen, d_up, H * dv, cfg, dtype),
        "wif": {"w": module.normal(gen, (d_up, 2 * H), torch.float32, 0.1)},
        "skip": torch.ones((d_up,), dtype=dtype, device=dev),
        "out_norm": layers.init_norm(H * dv, "rmsnorm", dtype, dev),
        "down": module.maybe_factorized(gen, H * dv, d, cfg, dtype),
    }


def _causal_conv(x: Tensor, w: Tensor, b: Tensor) -> Tensor:
    W, T = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = xp[:, 0:T] * w[0][None, None]
    for i in range(1, W):
        out = out + xp[:, i:i + T] * w[i][None, None]
    return out + b


def _logsigmoid(x: Tensor) -> Tensor:
    """``F.logsigmoid``; on a DTensor under autograd (a device mesh, where
    its backward has no sharding rule) as min(x, 0) - log1p(exp(-|x|)),
    the same function in operations that have one."""
    if ops.is_dtensor(x) and x.requires_grad:
        return torch.clamp(x, max=0) - torch.log1p(torch.exp(-torch.abs(x)))
    return F.logsigmoid(x)


def mlstm_parallel(q: Tensor, k: Tensor, v: Tensor, i_pre: Tensor,
                   f_pre: Tensor) -> Tensor:
    """Stabilized parallel mLSTM.  q/k (B,T,H,dqk), v (B,T,H,dv),
    i_pre/f_pre (B,T,H) pre-activations.  Returns (B,T,H,dv)."""
    T, dqk = q.shape[1], q.shape[3]
    logf = _logsigmoid(f_pre.float())  # (B,T,H)
    cf = torch.cumsum(logf, dim=1)
    # D[t,s] = F_t - F_s + i_s  for s<=t
    D = cf[:, :, None, :] - cf[:, None, :, :] + i_pre.float()[:, None, :, :]
    mask = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    D = torch.where(mask[None, :, :, None], D, float("-inf"))
    m = D.amax(2)  # (B,T,H)
    expD = torch.exp(D - m[:, :, None, :])
    scores = torch.einsum("bthd,bshd->btsh", q, k) * (dqk ** -0.5)
    C = scores.float() * expD
    norm = torch.maximum(C.sum(2).abs(), torch.exp(-m))  # (B,T,H)
    h = torch.einsum("btsh,bshd->bthd", C.to(v.dtype), v)
    return h / norm[..., None].to(v.dtype)


def apply_mlstm(params: Params, cfg, x: Tensor) -> Tensor:
    """Full mLSTM residual block.  x: (B,T,d)."""
    B, T, _ = x.shape
    d_up, H, dqk, dv = mlstm_dims(cfg)
    h = layers.apply_norm(params["norm"], x, cfg.norm)
    up = module.linear(params["up"], h)
    a, z = up[..., :d_up], up[..., d_up:]
    ac = F.silu(_causal_conv(a, params["conv_w"].to(x.dtype),
                             params["conv_b"].to(x.dtype)))
    q = module.linear(params["wq"], ac).reshape(B, T, H, dqk)
    k = module.linear(params["wk"], ac).reshape(B, T, H, dqk)
    v = module.linear(params["wv"], a).reshape(B, T, H, dv)
    if_pre = a @ params["wif"]["w"].to(x.dtype)  # (B,T,2H)
    ht = mlstm_parallel(q, k, v, if_pre[..., :H], if_pre[..., H:])
    ht = (ht.reshape(B, T, H * dv)
          + params["skip"][:H * dv].to(x.dtype) * ac[..., :H * dv])
    out = layers.apply_norm(params["out_norm"], ht, "rmsnorm")
    out = out * F.silu(z[..., :H * dv])
    return x + module.linear(params["down"], out)


def init_mlstm_cache(cfg, batch: int, dtype, device=None) -> Dict[str, Tensor]:
    d_up, H, dqk, dv = mlstm_dims(cfg)
    return {
        "C": torch.zeros((batch, H, dqk, dv), dtype=dtype, device=device),
        "n": torch.zeros((batch, H, dqk), dtype=dtype, device=device),
        "m": torch.full((batch, H), -1e30, dtype=torch.float32,
                        device=device),
        "conv": torch.zeros((batch, 3, d_up), dtype=dtype, device=device),
    }


def apply_mlstm_decode(params: Params, cfg, x: Tensor,
                       cache: Dict[str, Tensor]
                       ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One-token mLSTM step.  x: (B,1,d).  Returns (y, the new state)."""
    B = x.shape[0]
    d_up, H, dqk, dv = mlstm_dims(cfg)
    h = layers.apply_norm(params["norm"], x, cfg.norm)
    up = module.linear(params["up"], h)
    a, z = up[..., :d_up], up[..., d_up:]
    hist = torch.cat([cache["conv"], a], dim=1)  # (B,4,d_up)
    w = params["conv_w"].to(x.dtype)
    ac = F.silu(torch.einsum("bwc,wc->bc", hist, w)
                + params["conv_b"].to(x.dtype))[:, None]
    q = module.linear(params["wq"], ac).reshape(B, H, dqk)
    k = module.linear(params["wk"], ac).reshape(B, H, dqk)
    v = module.linear(params["wv"], a).reshape(B, H, dv)
    if_pre = (a @ params["wif"]["w"].to(x.dtype))[:, 0]
    i_pre, f_pre = if_pre[..., :H].float(), if_pre[..., H:].float()
    logf = _logsigmoid(f_pre)
    m_new = torch.maximum(logf + cache["m"], i_pre)
    fg = torch.exp(logf + cache["m"] - m_new)[..., None]  # (B,H,1)
    ig = torch.exp(i_pre - m_new)[..., None]
    C = cache["C"] * fg[..., None].to(cache["C"].dtype) + (
        ig.to(v.dtype)[..., None] * k[..., None] * v[:, :, None, :])
    n = cache["n"] * fg.to(cache["n"].dtype) + ig.to(k.dtype) * k
    qs = q * (dqk ** -0.5)
    num = torch.einsum("bhd,bhdv->bhv", qs, C)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", qs, n).abs(),
                        torch.exp(-m_new).to(qs.dtype))
    ht = (num / den[..., None]).reshape(B, 1, H * dv)
    ht = ht + params["skip"][:H * dv].to(x.dtype) * ac[..., :H * dv]
    out = layers.apply_norm(params["out_norm"], ht, "rmsnorm")
    out = out * F.silu(z[..., :H * dv])
    y = x + module.linear(params["down"], out)
    return y, {"C": C, "n": n, "m": m_new, "conv": hist[:, 1:]}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def init_slstm(gen, cfg, dtype) -> Params:
    d = cfg.d_model
    H = cfg.num_heads
    dh = d // H
    d_ff = 2 * int(d * cfg.xlstm.proj_factor)  # even: the gated split
    dev = gen.device
    return {
        "norm": layers.init_norm(d, cfg.norm, dtype, dev),
        # input weights for 4 gates (i, f, z, o)
        "wx": {"w": module.normal(gen, (d, 4 * d), dtype, d ** -0.5)},
        # per-head recurrent weights (H, dh, 4*dh)
        "r": module.normal(gen, (H, dh, 4 * dh), dtype, dh ** -0.5),
        "bias": torch.zeros((4 * d,), dtype=torch.float32, device=dev),
        "gn": layers.init_norm(d, "rmsnorm", dtype, dev),
        "ff_up": module.maybe_factorized(gen, d, d_ff, cfg, dtype),
        "ff_down": module.maybe_factorized(gen, d_ff // 2, d, cfg, dtype),
    }


def _slstm_cell(params, cfg, xg: Tensor, state):
    """One time step.  xg: (B, 4d) input-gate preactivations (no
    recurrent part yet).  state: dict(c, n, h, m) each (B, H, dh).
    Returns (the new state, h in f32)."""
    B = xg.shape[0]
    H = cfg.num_heads
    dh = cfg.d_model // H
    rec = torch.einsum("bhd,hdk->bhk", state["h"],
                       params["r"].to(xg.dtype))
    pre = (xg.reshape(B, H, 4 * dh) + rec
           + params["bias"].reshape(H, 4 * dh).float().to(xg.dtype))
    i_pre, f_pre, z_pre, o_pre = pre.split(dh, dim=-1)
    i_pre, f_pre = i_pre.float(), f_pre.float()
    logf = _logsigmoid(f_pre)
    m_new = torch.maximum(logf + state["m"], i_pre)
    ig = torch.exp(i_pre - m_new)
    fg = torch.exp(logf + state["m"] - m_new)
    c = fg * state["c"] + ig * torch.tanh(z_pre.float())
    n = fg * state["n"] + ig
    h = torch.sigmoid(o_pre.float()) * c / n.clamp(min=1e-6)
    new = {"c": c, "n": n, "h": h.to(state["h"].dtype), "m": m_new}
    return new, h


def init_slstm_state(cfg, batch: int, dtype,
                     device=None) -> Dict[str, Tensor]:
    H = cfg.num_heads
    shape = (batch, H, cfg.d_model // H)
    return {"c": torch.zeros(shape, dtype=torch.float32, device=device),
            "n": torch.zeros(shape, dtype=torch.float32, device=device),
            "h": torch.zeros(shape, dtype=dtype, device=device),
            "m": torch.full(shape, -1e30, dtype=torch.float32,
                            device=device)}


def _slstm_out(params: Params, x: Tensor, hs: Tensor) -> Tensor:
    """The block's gated feed-forward on the cell outputs ``hs`` (B,T,d)
    and the residual."""
    hs = layers.apply_norm(params["gn"], hs, "rmsnorm")
    up = module.linear(params["ff_up"], hs)
    a, b = up.chunk(2, dim=-1)
    return x + module.linear(params["ff_down"],
                             F.gelu(a, approximate="tanh") * b)


def apply_slstm(params: Params, cfg, x: Tensor) -> Tensor:
    """Full sLSTM residual block (a host loop over T).  x: (B,T,d)."""
    B, T, d = x.shape
    hin = layers.apply_norm(params["norm"], x, cfg.norm)
    xg = hin @ params["wx"]["w"].to(x.dtype)  # (B,T,4d)
    state = init_slstm_state(cfg, B, x.dtype, x.device)
    hs = []
    for t in range(T):
        state, h = _slstm_cell(params, cfg, xg[:, t], state)
        hs.append(h)
    hs = torch.stack(hs, dim=1).reshape(B, T, d).to(x.dtype)
    return _slstm_out(params, x, hs)


def apply_slstm_decode(params: Params, cfg, x: Tensor,
                       state: Dict[str, Tensor]
                       ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One-token sLSTM step.  x: (B,1,d).  Returns (y, the new state)."""
    B, _, d = x.shape
    hin = layers.apply_norm(params["norm"], x, cfg.norm)
    xg = (hin @ params["wx"]["w"].to(x.dtype))[:, 0]
    new, h = _slstm_cell(params, cfg, xg, state)
    return _slstm_out(params, x, h.reshape(B, 1, d).to(x.dtype)), new
