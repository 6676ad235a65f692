"""Per-tensor (per-block) training-coverage metrics.

Heroes' motivating observation (paper Fig. 2 / Sec. I) is that naive
neural composition trains some low-rank coefficient blocks with only a
small fraction of clients, starving the largest sub-model.  The
assignment policies record two dense tallies per block family:

``coverage.hidden_rounds`` / ``coverage.anchored_rounds``
    how many *assignment events* (rounds for the sync loop, dispatches
    for the semi-async loop) included each hidden-layer / anchored-layer
    block in at least one client's assignment — the Fig. 2 quantity
    once divided by ``coverage.events``;
``coverage.hidden_iters`` / ``coverage.anchored_iters``
    the tau-weighted training-iteration totals per block (the Heroes
    scheduler's own counter signal, mirrored into telemetry so every
    scheme reports it, not just Heroes).

This module turns a metrics snapshot into that normalized table.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

FAMILIES = ("hidden", "anchored")


def coverage_table(metrics: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    """Per-family coverage from a metrics snapshot.

    Returns ``{family: {"events": E, "rounds": [...], "iters": [...],
    "coverage": [r / E, ...], "min": ..., "max": ..., "mean": ...}}``
    for every block family with a recorded tally.  ``coverage[b]`` is
    the fraction of assignment events in which block ``b`` was trained
    by at least one client.
    """
    tallies = metrics.get("tallies", {})
    counters = metrics.get("counters", {})
    events = int(counters.get("coverage.events", 0))
    out: Dict[str, Dict[str, Any]] = {}
    for fam in FAMILIES:
        rounds: Optional[List[float]] = tallies.get(f"coverage.{fam}_rounds")
        if rounds is None:
            continue
        iters = tallies.get(f"coverage.{fam}_iters", [0] * len(rounds))
        cov = [(r / events if events else 0.0) for r in rounds]
        out[fam] = {
            "events": events,
            "rounds": [int(r) for r in rounds],
            "iters": [int(v) for v in iters],
            "coverage": cov,
            "min": min(cov) if cov else 0.0,
            "max": max(cov) if cov else 0.0,
            "mean": (sum(cov) / len(cov)) if cov else 0.0,
        }
    return out


def format_coverage(table: Dict[str, Dict[str, Any]],
                    bar_width: int = 24) -> str:
    """Render a coverage table as aligned text with unit-interval bars."""
    if not table:
        return "(no coverage tallies recorded — dense scheme or no " \
               "assignment events)"
    lines: List[str] = []
    for fam, t in table.items():
        lines.append(f"{fam} blocks — trained in fraction of "
                     f"{t['events']} assignment events "
                     f"(min {t['min']:.2f} / mean {t['mean']:.2f} / "
                     f"max {t['max']:.2f}):")
        for b, (c, it) in enumerate(zip(t["coverage"], t["iters"])):
            bar = "#" * int(round(c * bar_width))
            lines.append(f"  block {b:3d}  {c:6.2%}  "
                         f"|{bar:<{bar_width}}|  {it:6d} iters")
    return "\n".join(lines)
