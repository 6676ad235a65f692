"""The whole training step's share of the card's bf16 peak, in %: the
model FLOPs of the window's steps (``counts/transformer.py``: the
factorized projections, attention and the head, forward and backward, no
recomputation) over the window's seconds on the host's clock and 989
TFLOP/s.  The window is the traced run's, which the profiler and a
synchronise after each step slow a little."""

from counts.peaks import PEAK_BF16_FLOPS
from counts.transformer import step_flops


def read(ctx):
    if not ctx["units"] or ctx["trace"] is None or ctx["trace"]["busy_s"] <= 0:
        return None
    t = ctx["traffic"]
    flops = ctx["units"] * step_flops(ctx["config"], t["batch"], t["seq"])
    return 100.0 * flops / (ctx["window_s"] * PEAK_BF16_FLOPS)
