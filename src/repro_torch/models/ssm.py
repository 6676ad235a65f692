"""Mamba2 (SSD) block — the chunked, matmul-dominant formulation.

State space:  h_t = a_t * h_{t-1} + dt_t * (B_t x_t^T),  y_t = C_t h_t + D x_t
with a_t = exp(-dt_t * exp(A_log))  (scalar per head), h in R^{N x P}.

The chunked (SSD) algorithm splits the sequence into chunks of length Q.
:func:`ssd_chunked` first computes each chunk's summary state and runs
the short inter-chunk recurrence (a Python loop over the chunks in place
of the reference's ``lax.scan``), giving the state entering every chunk;
then ONE call of the SSD-chunk kernel
(:func:`repro_torch.kernels.ops.ssd_chunk`) computes, for every (batch,
chunk, head), the quadratic-in-Q intra-chunk block plus the carry-in of
that state — the sum of the reference's ``y_intra`` and ``y_inter``.

Decode: O(1) recurrent step carrying (conv_state, ssm_state); it never
reaches the chunked scan.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import layers, module

Tensor = torch.Tensor
Params = Dict[str, Any]


def dims(cfg) -> Tuple[int, int, int, int]:
    """(d_inner, n_heads, head_dim P, state_dim N)."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    if d_inner % s.head_dim:
        raise ValueError(f"d_inner {d_inner} is not a multiple of head_dim "
                         f"{s.head_dim}")
    return d_inner, d_inner // s.head_dim, s.head_dim, s.state_dim


def init_mamba2(gen, cfg, dtype) -> Params:
    s = cfg.ssm
    d = cfg.d_model
    d_inner, H, P, N = dims(cfg)
    conv_ch = d_inner + 2 * N  # x plus B and C go through the conv
    in_dim = 2 * d_inner + 2 * N + H  # z, x, B, C, dt
    dev = gen.device
    f32 = torch.float32
    return {
        "in_proj": module.maybe_factorized(gen, d, in_dim, cfg, dtype),
        "conv_w": module.normal(gen, (s.conv_width, conv_ch), dtype, 0.1),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, dtype=f32,
                                          device=dev)),
        "D": torch.ones((H,), dtype=f32, device=dev),
        "dt_bias": torch.log(torch.expm1(
            0.01 * torch.ones((H,), dtype=f32, device=dev))),
        "norm": layers.init_norm(d_inner, "rmsnorm", dtype, dev),
        "out_proj": module.maybe_factorized(gen, d_inner, d, cfg, dtype),
    }


def _split_proj(zxbcdt: Tensor, cfg):
    d_inner, H, P, N = dims(cfg)
    return torch.split(zxbcdt, [d_inner, d_inner, N, N, H], dim=-1)


def _causal_conv(x: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """Depthwise causal conv over (B, T, C) with kernel (W, C).  On a
    device mesh each rank convolves its own rows and channels (the batch
    over the data-parallel axes, the channels over ``"model"``)."""
    if ops.is_dtensor(x):
        mesh = x.device_mesh
        dp = ops._dp(mesh)
        xp = ops._placements(mesh, (dp, None, "model"), x.shape)
        return ops._on_shards(_causal_conv, mesh, xp, (
            xp, ops._placements(mesh, (None, "model"), w.shape),
            ops._placements(mesh, ("model",), b.shape)), x, w, b)
    W = w.shape[0]
    T = x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = sum(xp[:, i:i + T, :] * w[i][None, None, :] for i in range(W))
    return out + b[None, None, :]


def ssd_chunked(x: Tensor, dt: Tensor, A: Tensor, Bm: Tensor, Cm: Tensor,
                chunk: int, init_state: Optional[Tensor] = None
                ) -> Tuple[Tensor, Tensor]:
    """Chunked selective-state-space scan.

    x (B,T,H,P), dt (B,T,H) (post-softplus), A (H,) (positive decay
    rates), Bm/Cm (B,T,N) (single group shared by all heads).
    Returns (y (B,T,H,P), final_state (B,H,N,P)).
    """
    Bsz, T, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, T)
    pad = (-T) % Q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    Tp = T + pad
    nc = Tp // Q

    # log-decay per step: la_t = -dt_t * A  (shape B,T,H) — kept f32
    la = (-dt * A[None, None, :]).float()
    xw = x * dt[..., None].to(x.dtype)  # dt-weighted input, model dtype

    xc = xw.reshape(Bsz, nc, Q, H, P)
    bc = Bm.reshape(Bsz, nc, Q, N)
    cc = Cm.reshape(Bsz, nc, Q, N)
    cum = torch.cumsum(la.reshape(Bsz, nc, Q, H), dim=2)  # (B,nc,Q,H)
    total = cum[:, :, -1]  # (B,nc,H)

    # ---- chunk summary states ----------------------------------------
    # S_c = sum_j exp(total - cum_j) B_j (xw_j)^T   -> (B,nc,H,N,P)
    w = torch.exp(total[:, :, None] - cum)  # (B,nc,Q,H)
    S = torch.einsum("bcjn,bcjh,bcjhp->bchnp", bc, w.to(xc.dtype), xc)

    # ---- inter-chunk recurrence: the state entering each chunk ---------
    h = (torch.zeros((Bsz, H, N, P), dtype=x.dtype, device=x.device)
         if init_state is None else init_state)
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = h * torch.exp(total[:, c])[:, :, None, None].to(h.dtype) \
            + S[:, c]
    h_in = torch.stack(h_in, dim=1)  # (B,nc,H,N,P)

    # ---- intra-chunk block + carry-in: one kernel call ----------------
    y = ops.ssd_chunk_blocks(cc, bc, xc, cum, h_in)
    return y.reshape(Bsz, Tp, H, P)[:, :T], h


def apply_mamba2(params: Params, cfg, u: Tensor) -> Tensor:
    """Full-sequence Mamba2 block.  u: (B, T, d_model)."""
    s = cfg.ssm
    d_inner, H, P, N = dims(cfg)
    zxbcdt = module.linear(params["in_proj"], u)
    z, x, b, c, dt = _split_proj(zxbcdt, cfg)
    xbc = torch.cat([x, b, c], dim=-1)
    xbc = F.silu(_causal_conv(xbc, params["conv_w"].to(u.dtype),
                              params["conv_b"].to(u.dtype)))
    x, b, c = torch.split(xbc, [d_inner, N, N], dim=-1)
    dt = F.softplus(dt.float() + params["dt_bias"][None, None, :])
    A = torch.exp(params["A_log"])
    xh = x.reshape(*x.shape[:2], H, P)
    y, _ = ssd_chunked(xh, dt, A, b.float().to(u.dtype),
                       c.float().to(u.dtype), s.chunk)
    y = y + params["D"].to(u.dtype)[None, None, :, None] * xh
    y = y.reshape(*u.shape[:2], d_inner)
    y = layers.apply_norm(params["norm"], y, "rmsnorm") * F.silu(z)
    return module.linear(params["out_proj"], y)


# ---------------------------------------------------------------------------
# decode (single-token recurrent step)
# ---------------------------------------------------------------------------


def init_mamba2_cache(cfg, batch: int, dtype, device=None
                      ) -> Dict[str, Tensor]:
    s = cfg.ssm
    d_inner, H, P, N = dims(cfg)
    conv_ch = d_inner + 2 * N
    return {
        "conv": torch.zeros((batch, s.conv_width - 1, conv_ch), dtype=dtype,
                            device=device),
        "state": torch.zeros((batch, H, N, P), dtype=dtype, device=device),
    }


def apply_mamba2_decode(params: Params, cfg, u: Tensor,
                        cache: Dict[str, Tensor]
                        ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One token.  u: (B, 1, d_model).  Returns (out, new cache)."""
    d_inner, H, P, N = dims(cfg)
    zxbcdt = module.linear(params["in_proj"], u)
    z, x, b, c, dt = _split_proj(zxbcdt, cfg)
    xbc = torch.cat([x, b, c], dim=-1)  # (B,1,conv_ch)
    hist = torch.cat([cache["conv"], xbc], dim=1)  # (B,W,conv_ch)
    w = params["conv_w"].to(u.dtype)
    out = torch.einsum("bwc,wc->bc", hist, w) + params["conv_b"].to(u.dtype)
    xbc1 = F.silu(out)[:, None, :]
    new_conv = hist[:, 1:]
    x, b, c = torch.split(xbc1, [d_inner, N, N], dim=-1)
    dt = F.softplus(dt.float() + params["dt_bias"][None, None, :])
    A = torch.exp(params["A_log"])
    a = torch.exp(-dt[:, 0] * A[None, :])  # (B,H)
    xh = x.reshape(x.shape[0], H, P)
    dBx = torch.einsum("bn,bhp->bhnp", b[:, 0],
                       xh * dt[:, 0][..., None].to(u.dtype))
    state = cache["state"] * a[:, :, None, None].to(u.dtype) + dBx
    y = torch.einsum("bn,bhnp->bhp", c[:, 0], state)
    y = y + params["D"].to(u.dtype)[None, :, None] * xh
    y = y.reshape(u.shape[0], 1, d_inner)
    y = layers.apply_norm(params["norm"], y, "rmsnorm") * F.silu(z)
    return module.linear(params["out_proj"], y), {"conv": new_conv,
                                                  "state": state}
