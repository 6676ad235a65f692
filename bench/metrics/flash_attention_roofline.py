"""The flash-attention forward kernel's share of its roofline, in %: the
least time its launches in the window could take
(``counts/attention.py``: FLOPs over the bf16 or f32 peak, or bytes over
the memory rate, whichever is larger) over the device time of the
kernels named ``flash_mma_kernel`` and ``flash_ffma_kernel``."""

from counts.attention import flash_attention
from counts.peaks import PEAK_BF16_FLOPS, PEAK_F32_FLOPS, bound_s
from shares import kernel_share


def _bound(scalars):
    flops, nbytes, bf16 = flash_attention(scalars)
    return bound_s(flops, nbytes, PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS)


def read(ctx):
    return kernel_share(ctx, "flash_attention",
                        ("flash_mma_kernel", "flash_ffma_kernel"), _bound)
