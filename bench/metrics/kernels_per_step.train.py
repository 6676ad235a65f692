"""Device kernels and copies a training step runs: the trace's device
operations in the window, over the steps."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not ctx["units"] or not tr["kernels"]:
        return None
    return len(tr["kernels"]) / ctx["units"]
