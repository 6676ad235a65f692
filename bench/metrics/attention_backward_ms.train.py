"""Device time of attention's backward in a training step, in ms a step: the
port's span ``plain_backward.flash_attention``
(``kernels/ops.py::_PlainBackward.backward``: the f32 replay of the
attention's plain version and its gradient, in every layer)."""

from program_spans import per_unit


def read(ctx):
    return per_unit(ctx, "plain_backward.flash_attention")
