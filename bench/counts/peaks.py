"""Published peaks of one NVIDIA H100 SXM (dense, no sparsity, 700 W) and
the least time a piece of work can take on it.

Copied from ``chip_smoke.py`` (``PEAK_BYTES_S``, ``PEAK_F32_FLOPS``,
``PEAK_BF16_FLOPS``, ``bound_ms``) so that the yardstick stays with the
benchmark.
"""

PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12


def bound_s(flops: float, nbytes: float,
            peak_flops: float = PEAK_F32_FLOPS) -> float:
    """Least seconds for the work: the larger of bytes over the memory rate
    and operations over the peak for their type."""
    return max(nbytes / PEAK_BYTES_S, flops / peak_flops)
