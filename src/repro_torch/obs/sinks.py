"""Pluggable telemetry sinks.

A sink receives every event the :class:`~repro_torch.obs.recorder.Recorder`
emits — the ``meta`` header, ``span``/``event`` stream entries, and the
final ``metrics`` snapshot at close (see :mod:`repro_torch.obs.schema` for
the event shapes).  Sinks are called under the recorder's lock, so they
need no synchronisation of their own.

``MemorySink`` keeps everything in a list (tests, notebooks);
``JsonlSink`` appends one JSON object per line, write-through, so a run
killed mid-flight still leaves a readable prefix (only the final
``metrics`` line is lost).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Optional


class Sink:
    """Sink contract: ``emit`` every event, ``flush``/``close`` once."""

    def emit(self, obj: Dict[str, Any]) -> None:
        raise NotImplementedError

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


class MemorySink(Sink):
    """Everything in a list — the test/notebook sink.

    ``spans(name)`` / ``events_named(name)`` are the common query
    helpers; ``metrics`` holds the final snapshot after close.
    """

    def __init__(self):
        self.events: List[Dict[str, Any]] = []
        self.metrics: Optional[Dict[str, Any]] = None

    def emit(self, obj: Dict[str, Any]) -> None:
        self.events.append(obj)
        if obj.get("type") == "metrics":
            self.metrics = obj

    def spans(self, name: Optional[str] = None) -> List[Dict[str, Any]]:
        return [e for e in self.events if e.get("type") == "span"
                and (name is None or e["name"] == name)]

    def events_named(self, name: str) -> List[Dict[str, Any]]:
        return [e for e in self.events if e.get("type") == "event"
                and e["name"] == name]


class JsonlSink(Sink):
    """One JSON object per line, appended write-through.

    The file handle opens lazily on the first event and is line-buffered
    by explicit ``flush`` at close; a crashed run leaves every event up
    to the crash on disk (missing only the final metrics snapshot —
    :mod:`repro_torch.obs.report` degrades gracefully in that case).
    """

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._fh = None

    def emit(self, obj: Dict[str, Any]) -> None:
        if self._fh is None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = self.path.open("a", encoding="utf-8")
        self._fh.write(json.dumps(obj) + "\n")

    def flush(self) -> None:
        if self._fh is not None:
            self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.flush()
            self._fh.close()
            self._fh = None


def load_events(path: str | Path) -> List[Dict[str, Any]]:
    """Parse a JSONL event log back into a list of event dicts.

    Tolerates a truncated final line (a run killed mid-write) by
    dropping it — every complete line parses or the error propagates.
    """
    out: List[Dict[str, Any]] = []
    lines = Path(path).read_text(encoding="utf-8").splitlines()
    for i, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        try:
            out.append(json.loads(line))
        except json.JSONDecodeError:
            if i == len(lines) - 1:  # torn tail from a killed writer
                break
            raise
    return out
