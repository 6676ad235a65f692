"""RMSNorm: per-row RMS normalisation with f32 statistics, on Hopper.

``rmsnorm`` launches the CUDA kernel (``csrc/rmsnorm.cu``) for tensors on
a CUDA device and takes the plain PyTorch version (:func:`_rmsnorm_math`)
for tensors on the CPU.  Every norm of the model zoo's rmsnorm configs
(:func:`repro_torch.models.layers.apply_norm`) comes here through
:func:`repro_torch.kernels.ops.rmsnorm`.

Layout: x ``(..., d)`` f32 or bf16, scale ``(d,)`` of any float type
(the kernel reads it in f32); the output has x's shape and type.

Forward only, as the reference's ``pallas_call`` is: the wrapper raises
when asked to record a gradient.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import (DTYPE_CODES, check_operands, launch,
                                 no_grad_guard, use_kernel)

Tensor = torch.Tensor


def _rmsnorm_math(x: Tensor, scale: Tensor, eps: float) -> Tensor:
    """Plain version of the kernel: f32 mean square, rsqrt, x scale, in
    x's type."""
    xf = x.float()
    ms = torch.mean(torch.square(xf), -1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


def rmsnorm(x: Tensor, scale: Tensor, *, eps: float = 1e-6) -> Tensor:
    """x (..., d), scale (d,) -> x's shape and type."""
    no_grad_guard("rmsnorm", x, scale)
    d = x.shape[-1]
    if tuple(scale.shape) != (d,):
        raise ValueError(f"rmsnorm: scale {tuple(scale.shape)} does not "
                         f"match x {tuple(x.shape)}")
    if not use_kernel(x):
        return _rmsnorm_math(x, scale, eps)
    check_operands("rmsnorm", tuple(DTYPE_CODES), x=x)
    s32 = scale.to(device=x.device, dtype=torch.float32).contiguous()
    out = torch.empty_like(x)
    launch("rmsnorm", (x, s32, out), x.numel() // d, d, DTYPE_CODES[x.dtype],
           float(eps))
    return out
