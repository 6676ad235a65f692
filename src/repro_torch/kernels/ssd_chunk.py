"""The Mamba2 SSD intra-chunk block plus carry-in, on Hopper.

For one chunk of length Q of one (batch, chunk, head) row::

    y[i] = sum_{j<=i} (C_i . B_j) * exp(cum[i] - cum[j]) * xw[j]
         + exp(cum[i]) * (C_i . h_in)

the matmul core of the chunked selective-state-space scan
(:func:`repro_torch.models.ssm.ssd_chunked`).  ``ssd_chunk`` launches the
CUDA kernel (``csrc/ssd_chunk.cu``) for tensors on a CUDA device and takes
the plain PyTorch version (:func:`_ssd_math`) for tensors on the CPU.

Layouts (the kernel's):
  cb, bb  (R / heads, Q, N)  C and B; row r of the others reads row
                             r // heads (one B/C group shared by the
                             heads of a (batch, chunk), never repeated)
  xw      (R, Q, P)          dt-weighted inputs
  cum     (R, Q)             cumulative log-decay in the chunk, f32
  h_in    (R, N, P)          state entering the chunk
cb, bb, xw and h_in share one type (f32 or bf16); y comes back in it.
Model-layout callers with B and C replicated per head (the reference's
signature) go through :func:`repro_torch.kernels.ops.ssd_chunk`.

Forward only, as the reference's ``pallas_call`` is: the wrapper raises
when asked to record a gradient.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import (DTYPE_CODES, check_operands, launch,
                                 no_grad_guard, use_kernel)

Tensor = torch.Tensor

MAX_STATE = 128  # N
MAX_HEAD_DIM = 64  # P


def _ssd_math(cb: Tensor, bb: Tensor, xw: Tensor, cum: Tensor, h_in: Tensor,
              heads: int = 1) -> Tensor:
    """Plain version of the kernel: f32 scores per (batch, chunk) group,
    the causal decay per head, w rounded to xw's type, f32 sums.

    The scores are summed in n order, one rounding a step (for bf16
    inputs each product is exact in f32, so a step is one FMA): the
    order the kernel's scores follow, so that w rounds to bf16 the same
    way on both sides.  In another order a score that lands near a
    rounding boundary of w can round the other way, and one such w moves
    y by up to 2^-8 |w| |xw|, past the bf16 tolerance."""
    R, Q, P = xw.shape
    G, _, N = cb.shape
    cf, bf = cb.float(), bb.float()
    scores = torch.zeros((G, Q, Q), dtype=torch.float32, device=xw.device)
    for n in range(N):
        scores.addcmul_(cf[:, :, n, None], bf[:, None, :, n])
    c = cum.float().reshape(G, heads, Q)
    live = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xw.device))
    # exp only where the mask keeps the pair: the upper triangle may
    # overflow, and inf * 0 would be NaN
    diff = torch.where(live, c[..., :, None] - c[..., None, :], -torch.inf)
    w = scores[:, None] * torch.exp(diff)
    w = w.to(xw.dtype).float().reshape(R, Q, Q)
    carry = torch.einsum("gin,ghnp->ghip", cb.float(),
                         h_in.float().reshape(G, heads, N, P))
    y = (torch.einsum("rij,rjp->rip", w, xw.float())
         + torch.exp(cum.float())[..., None] * carry.reshape(R, Q, P))
    return y.to(xw.dtype)


def ssd_chunk(cb: Tensor, bb: Tensor, xw: Tensor, cum: Tensor, h_in: Tensor,
              *, heads: int = 1) -> Tensor:
    """cb/bb (R/heads, Q, N), xw (R, Q, P), cum (R, Q), h_in (R, N, P)
    -> y (R, Q, P) in xw's type.  f32 or bf16; N <= 128, P <= 64."""
    no_grad_guard("ssd_chunk", cb, bb, xw, h_in)
    if xw.dim() != 3 or cb.dim() != 3:
        raise ValueError(f"ssd_chunk: xw {tuple(xw.shape)} and cb "
                         f"{tuple(cb.shape)} must be 3-d")
    R, Q, P = xw.shape
    G, _, N = cb.shape
    if heads < 1 or G * heads != R or tuple(bb.shape) != (G, Q, N) \
            or tuple(cb.shape) != (G, Q, N) or tuple(cum.shape) != (R, Q) \
            or tuple(h_in.shape) != (R, N, P):
        raise ValueError(f"ssd_chunk: cb {tuple(cb.shape)}, bb "
                         f"{tuple(bb.shape)}, xw {tuple(xw.shape)}, cum "
                         f"{tuple(cum.shape)}, h_in {tuple(h_in.shape)} "
                         f"disagree with heads={heads}")
    if not use_kernel(xw):
        return _ssd_math(cb, bb, xw, cum, h_in, heads)
    check_operands("ssd_chunk", tuple(DTYPE_CODES), cb=cb, bb=bb, xw=xw,
                   h_in=h_in)
    check_operands("ssd_chunk", (torch.float32,), cum=cum)
    if cum.device != xw.device:
        raise ValueError("ssd_chunk: cum is on another device than xw")
    if N > MAX_STATE or P > MAX_HEAD_DIM:
        raise ValueError(f"ssd_chunk: state {N} > {MAX_STATE} or head_dim "
                         f"{P} > {MAX_HEAD_DIM}")
    out = torch.empty_like(xw)
    # the bf16 kernel's scores, once per (batch, chunk) group, Q rounded
    # up to the score tile of 64
    qs = -(-Q // 64) * 64 if xw.dtype == torch.bfloat16 else 0
    scores = torch.empty((G, qs, qs), dtype=torch.float32, device=xw.device)
    launch("ssd_chunk", (cb, bb, xw, cum, h_in, out, scores), R, Q, N, P,
           heads, DTYPE_CODES[xw.dtype])
    return out
