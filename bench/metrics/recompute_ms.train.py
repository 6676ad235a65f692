"""Device time of remat's replay of the layers in a training step's backward,
in ms a step: the port's span ``model.layer.recompute``
(``models/transformer.py::_run``, each layer's forward where autograd's
backward runs it again)."""

from program_spans import per_unit


def read(ctx):
    return per_unit(ctx, "model.layer.recompute")
