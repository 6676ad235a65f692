"""Share of the traced window in which no kernel or copy ran on the card
(one minus the union of their intervals over the window), in %."""

from shares import idle_pct


def read(ctx):
    return idle_pct(ctx)
