"""Shares read from the device trace of the window."""


def idle_pct(ctx):
    tr = ctx["trace"]
    if tr is None or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def kernel_share(ctx, launch_name, kernel_names, bound_of):
    """A kernel's share of its roofline in %: the sum of ``bound_of(scalars)``
    over the launches of ``launch_name`` in the window, over the device
    time of the trace's kernels whose name holds one of ``kernel_names``.
    None where it did not run."""
    tr = ctx["trace"]
    recs = [sc for n, sc in ctx["launch_records"] if n == launch_name]
    if tr is None or not recs:
        return None
    t = sum(e - s for n, s, e in tr["kernels"]
            if any(k in n for k in kernel_names))
    if t <= 0:
        return None
    return 100.0 * sum(bound_of(sc) for sc in recs) / t
