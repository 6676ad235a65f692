"""Device time of the program's own spans in the traced window.

The port opens named spans while a torch profiler records
(``repro_torch.obs.spans``), each with its calls and the stream time
between a CUDA event at its entry and one at its exit.  The profiler
opens after set-up, so the totals cover the window's steps alone; a
version of the program without the spans reports nothing here."""


def per_unit(ctx, name):
    """``device_ms`` of span ``name`` over the window's units, in ms a
    unit.  None without a trace or a unit, where the program has no
    spans, where ``name`` never ran on a CUDA device, or where
    ``train.forward`` did not run exactly once a unit (the totals would
    then cover other work than the window's steps)."""
    if ctx["trace"] is None or not ctx["units"]:
        return None
    try:
        from repro_torch.obs import spans
    except ImportError:
        return None
    tot = spans.totals()
    anchor, mine = tot.get("train.forward"), tot.get(name)
    if anchor is None or anchor["calls"] != ctx["units"] or mine is None \
            or mine["device_ms"] is None:
        return None
    return mine["device_ms"] / ctx["units"]
