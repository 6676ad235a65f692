"""Device time of a training step's optimizer, in ms a step: the port's span
``train.optimizer`` (``launch/steps.py::make_train_step``: the gradient's
norm, AdamW's update and its application to the parameters)."""

from program_spans import per_unit


def read(ctx):
    return per_unit(ctx, "train.optimizer")
