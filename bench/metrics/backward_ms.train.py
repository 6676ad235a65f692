"""Device time of a training step's backward, in ms a step: the port's span
``train.backward`` (``launch/steps.py::make_train_step``, around
``torch.autograd.grad``: remat's replay of the layers and the kernels'
plain backward included)."""

from program_spans import per_unit


def read(ctx):
    return per_unit(ctx, "train.backward")
