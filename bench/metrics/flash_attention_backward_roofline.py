"""Attention's backward kernel pair's share of its roofline, in %: the
least time its launches in the window could take
(``counts/attention_backward.py``: FLOPs over the bf16 peak, or bytes
over the memory rate, whichever is larger) over the device time of the
kernels whose names start ``flash_bwd_`` (``flash_bwd_dq_kernel`` and
``flash_bwd_dkdv_kernel``).  None where the pair did not run: a program
whose attention backward is a replay of the plain version."""

from counts.attention_backward import flash_attention_backward
from counts.peaks import PEAK_BF16_FLOPS, PEAK_F32_FLOPS, bound_s
from shares import kernel_share


def _bound(scalars):
    flops, nbytes, bf16 = flash_attention_backward(scalars)
    return bound_s(flops, nbytes, PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS)


def read(ctx):
    return kernel_share(ctx, "flash_attention_bwd", ("flash_bwd_",), _bound)
