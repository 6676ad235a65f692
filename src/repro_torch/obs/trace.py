"""Perfetto / Chrome ``trace_event`` export for recorded spans.

The recorder's span stream maps onto the Trace Event Format's complete
events (``"ph": "X"``), which both ``chrome://tracing`` and
https://ui.perfetto.dev open directly:

* **virtual-clock** spans land under pid 1 (``virtual-clock``), one
  track (tid) per client id — so a run renders as the paper's Gantt
  view: every sampled client's train→upload bar in simulated time;
* **wall-clock** spans land under pid 2 (``host``), one track per span
  name (merge latency, host staging, device steps, checkpoint writes).

Timestamps are microseconds (virtual seconds and perf_counter seconds
both scale by 1e6); point events become instants (``"ph": "i"``).

CLI::

    python -m repro_torch.obs.trace run_dir/events.jsonl trace.json
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List

_PID_VIRTUAL = 1
_PID_WALL = 2


def _meta_event(pid: int, tid: int, name: str, kind: str) -> Dict[str, Any]:
    return {"name": kind, "ph": "M", "pid": pid, "tid": tid,
            "args": {"name": name}}


class _Tracks:
    """Stable tid assignment per (pid, track-name)."""

    def __init__(self):
        self._ids: Dict[tuple, int] = {}
        self.meta: List[Dict[str, Any]] = []

    def tid(self, pid: int, name: str) -> int:
        key = (pid, name)
        if key not in self._ids:
            tid = len(self._ids) + 1
            self._ids[key] = tid
            self.meta.append(_meta_event(pid, tid, name, "thread_name"))
        return self._ids[key]


def to_trace_events(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Convert a recorded event list to a ``trace_event`` JSON object."""
    tracks = _Tracks()
    out: List[Dict[str, Any]] = [
        _meta_event(_PID_VIRTUAL, 0, "virtual-clock", "process_name"),
        _meta_event(_PID_WALL, 0, "host", "process_name"),
    ]
    meta_args: Dict[str, Any] = {}
    for e in events:
        t = e.get("type")
        if t == "meta":
            meta_args = {k: v for k, v in e.items() if k != "type"}
            continue
        if t not in ("span", "event"):
            continue
        virtual = e.get("clock") == "virtual"
        pid = _PID_VIRTUAL if virtual else _PID_WALL
        attrs = e.get("attrs", {})
        if virtual and "client" in attrs:
            track = f"client {attrs['client']}"
        else:
            track = e["name"]
        tid = tracks.tid(pid, track)
        if t == "span":
            out.append({"name": e["name"], "ph": "X", "pid": pid, "tid": tid,
                        "ts": e["t0"] * 1e6,
                        "dur": max(e["t1"] - e["t0"], 0.0) * 1e6,
                        "cat": e["clock"], "args": attrs})
        else:
            out.append({"name": e["name"], "ph": "i", "pid": pid, "tid": tid,
                        "ts": e["t"] * 1e6, "s": "t",
                        "cat": e["clock"], "args": attrs})
    return {"traceEvents": out + tracks.meta,
            "displayTimeUnit": "ms",
            "otherData": meta_args}


def export_trace(events: List[Dict[str, Any]], out_path: str | Path) -> Path:
    """Write the ``trace_event`` JSON for ``events``; returns the path."""
    out_path = Path(out_path)
    out_path.write_text(json.dumps(to_trace_events(events)) + "\n",
                        encoding="utf-8")
    return out_path


def main(argv=None) -> int:
    import argparse

    from repro_torch.obs.sinks import load_events

    ap = argparse.ArgumentParser(
        description="Export a telemetry JSONL log as Perfetto/Chrome "
                    "trace_event JSON")
    ap.add_argument("events", help="path to events.jsonl")
    ap.add_argument("out", help="output trace JSON path")
    args = ap.parse_args(argv)
    path = export_trace(load_events(args.events), args.out)
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
