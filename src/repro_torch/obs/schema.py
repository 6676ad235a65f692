"""JSONL event-log schema (version 1) + validator.

Every line of ``events.jsonl`` is one JSON object with a ``type``:

``meta``
    First line of a run.  ``{"type": "meta", "schema": 1, "scheme":
    str, "config": {...}, "provenance": {...}}`` — the config summary
    and environment fingerprint the run was produced under.
``span``
    ``{"type": "span", "name": str, "clock": "virtual"|"wall",
    "t0": num, "t1": num >= t0, "attrs": {...}}`` — an interval on the
    virtual clock (simulated seconds: per-client train/upload) or the
    wall clock (perf_counter seconds: merges, staging, device steps,
    checkpoint writes).
``event``
    ``{"type": "event", "name": str, "clock": ..., "t": num,
    "attrs": {...}}`` — a point on either clock.
``metrics``
    Last line of a clean run: the final registry snapshot —
    ``{"type": "metrics", "counters": {str: num}, "gauges":
    {str: num}, "histograms": {str: [num]}, "tallies": {str: [int]}}``.

The validator is deliberately dependency-free (no jsonschema): the CI
telemetry-smoke leg runs it over a real engine run's artifact.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List

_CLOCKS = ("virtual", "wall")


def _fail(i: int, msg: str) -> None:
    raise ValueError(f"event {i}: {msg}")


def _num(x: Any) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool)


def validate_event(obj: Dict[str, Any], i: int = 0) -> None:
    """Raise ``ValueError`` unless ``obj`` is a valid schema-1 event."""
    if not isinstance(obj, dict):
        _fail(i, f"not an object: {type(obj).__name__}")
    t = obj.get("type")
    if t == "meta":
        if obj.get("schema") != 1:
            _fail(i, f"unsupported schema version {obj.get('schema')!r}")
    elif t == "span":
        if not isinstance(obj.get("name"), str):
            _fail(i, "span without a string name")
        if obj.get("clock") not in _CLOCKS:
            _fail(i, f"bad clock {obj.get('clock')!r}")
        if not (_num(obj.get("t0")) and _num(obj.get("t1"))):
            _fail(i, "span t0/t1 must be numbers")
        if obj["t1"] < obj["t0"]:
            _fail(i, f"span ends before it starts ({obj['t0']}..{obj['t1']})")
        if not isinstance(obj.get("attrs"), dict):
            _fail(i, "span attrs must be an object")
    elif t == "event":
        if not isinstance(obj.get("name"), str):
            _fail(i, "event without a string name")
        if obj.get("clock") not in _CLOCKS:
            _fail(i, f"bad clock {obj.get('clock')!r}")
        if not _num(obj.get("t")):
            _fail(i, "event t must be a number")
        if not isinstance(obj.get("attrs"), dict):
            _fail(i, "event attrs must be an object")
    elif t == "metrics":
        for section, leaf in (("counters", _num), ("gauges", _num)):
            d = obj.get(section)
            if not isinstance(d, dict):
                _fail(i, f"metrics.{section} must be an object")
            for k, v in d.items():
                if not leaf(v):
                    _fail(i, f"metrics.{section}[{k!r}] is not a number")
        for section in ("histograms", "tallies"):
            d = obj.get(section)
            if not isinstance(d, dict):
                _fail(i, f"metrics.{section} must be an object")
            for k, v in d.items():
                if not isinstance(v, list) or not all(_num(x) for x in v):
                    _fail(i, f"metrics.{section}[{k!r}] is not a number list")
    else:
        _fail(i, f"unknown event type {t!r}")


def validate_events(events: List[Dict[str, Any]]) -> Dict[str, int]:
    """Validate a whole event list; returns per-type counts.

    Beyond per-event shape: the first event must be the ``meta`` header
    and at most one ``metrics`` snapshot may appear (as the last line).
    """
    if not events:
        raise ValueError("empty event log")
    if events[0].get("type") != "meta":
        raise ValueError("first event is not the meta header")
    counts: Dict[str, int] = {}
    for i, e in enumerate(events):
        validate_event(e, i)
        counts[e["type"]] = counts.get(e["type"], 0) + 1
    if counts.get("metrics", 0) > 1:
        raise ValueError(f"{counts['metrics']} metrics snapshots (expect <=1)")
    if counts.get("metrics") and events[-1].get("type") != "metrics":
        raise ValueError("metrics snapshot is not the final event")
    return counts


def validate_file(path: str | Path) -> Dict[str, int]:
    """Validate an ``events.jsonl`` artifact; returns per-type counts."""
    from repro_torch.obs.sinks import load_events

    return validate_events(load_events(path))
