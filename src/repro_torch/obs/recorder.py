"""Telemetry core: a metrics registry plus a span tracer.

One :class:`Recorder` serves a whole run.  It owns

* a **metrics registry** — counters (monotonic sums), gauges (last
  value), histograms (raw observation lists) and **tallies** (dense
  integer arrays indexed by block id — the per-tensor coverage
  primitive: Heroes' per-block training counts land here), and
* a **span stream** — interval events over either the run's *virtual*
  clock (simulated seconds: dispatch→train→upload per client) or the
  *wall* clock (``time.perf_counter``: merge latency, host staging,
  device steps, checkpoint writes) — fanned out to pluggable
  :mod:`~repro_torch.obs.sinks`.

The registry mutates under one lock (the cohort trainer's prefetch
worker records host-staging timings off the main thread); the event
stream is append-only through the same lock.

:class:`NoopRecorder` — the ``FLConfig.telemetry="off"`` default — is a
true no-op: every method is an empty override, ``enabled`` is False so
hot paths can skip even argument construction, and instrumented code
paths stay bitwise-identical to uninstrumented ones (telemetry never
draws RNG, never touches a tensor, only *reads* the quantities the
engine already computed).  Wall spans around device work are ended by
the engine after a synchronize of its CUDA device, and only when the
recorder is enabled.

Metric names are dotted strings; labels are folded into the registry
key as ``name[k=v,...]`` (sorted), so a labelled counter family needs
no separate declaration.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Iterable, List, Optional

import numpy as np

from repro_torch.obs.spans import span

SCHEMA_VERSION = 1


def metric_key(name: str, labels: Dict[str, Any]) -> str:
    """Canonical registry key: ``name`` or ``name[k=v,...]`` (sorted)."""
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}[{inner}]"


class _NullCtx:
    """Reusable do-nothing context manager (NoopRecorder.wall_span)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_CTX = _NullCtx()


class _WallSpan:
    """Context manager recording one wall-clock span on exit; while a
    torch profiler records, its body is also the span of the same name
    on the profiler's clock (:mod:`repro_torch.obs.spans`), a host range
    with no device time."""

    __slots__ = ("rec", "name", "attrs", "t0", "traced")

    def __init__(self, rec: "Recorder", name: str, attrs: Dict[str, Any]):
        self.rec = rec
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        self.traced = span(self.name, None)
        self.traced.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self.rec.span(self.name, self.t0, t1, clock="wall", **self.attrs)
        self.rec.observe(f"{self.name}_s", t1 - self.t0)
        self.traced.__exit__(*exc)
        return False


class Recorder:
    """Live telemetry: metrics registry + span stream over sinks."""

    enabled = True

    def __init__(self, sinks: Iterable[Any] = (),
                 meta: Optional[Dict[str, Any]] = None):
        self._lock = threading.Lock()
        self.sinks = list(sinks)
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.histograms: Dict[str, List[float]] = {}
        self.tallies: Dict[str, np.ndarray] = {}
        self._closed = False
        if meta is not None:
            self._emit({"type": "meta", "schema": SCHEMA_VERSION, **meta})

    # -- event stream -------------------------------------------------------

    def _emit(self, obj: Dict[str, Any]) -> None:
        with self._lock:
            for s in self.sinks:
                s.emit(obj)

    def span(self, name: str, t0: float, t1: float, *,
             clock: str = "virtual", **attrs) -> None:
        """One interval event.  ``clock="virtual"`` times are simulated
        seconds (the engine's virtual clock); ``"wall"`` times are
        ``time.perf_counter`` seconds."""
        self._emit({"type": "span", "name": name, "clock": clock,
                    "t0": float(t0), "t1": float(t1), "attrs": attrs})

    def event(self, name: str, t: float, *, clock: str = "virtual",
              **attrs) -> None:
        """One point event on the given clock."""
        self._emit({"type": "event", "name": name, "clock": clock,
                    "t": float(t), "attrs": attrs})

    def wall_span(self, name: str, **attrs):
        """``with rec.wall_span("aggregate.merge"): ...`` — records the
        span on the wall clock plus a ``<name>_s`` histogram entry."""
        return _WallSpan(self, name, attrs)

    # -- metrics registry ---------------------------------------------------

    def counter_add(self, name: str, value: float = 1.0, **labels) -> None:
        key = metric_key(name, labels)
        with self._lock:
            self.counters[key] = self.counters.get(key, 0.0) + float(value)

    def gauge_set(self, name: str, value: float, **labels) -> None:
        key = metric_key(name, labels)
        with self._lock:
            self.gauges[key] = float(value)

    def observe(self, name: str, value: float, **labels) -> None:
        key = metric_key(name, labels)
        with self._lock:
            self.histograms.setdefault(key, []).append(float(value))

    def tally_add(self, name: str, ids, amount=1) -> None:
        """Add ``amount`` (scalar or per-id array) at ``ids`` of the
        named dense tally, growing it as needed (``np.add.at`` handles
        repeated ids)."""
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        if ids.size == 0:
            return
        need = int(ids.max()) + 1
        amt = np.asarray(amount, np.int64)
        with self._lock:
            cur = self.tallies.get(name)
            if cur is None:
                cur = np.zeros(need, np.int64)
            elif cur.size < need:
                cur = np.concatenate(
                    [cur, np.zeros(need - cur.size, np.int64)])
            np.add.at(cur, ids, amt)
            self.tallies[name] = cur

    # -- lifecycle ----------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """JSON-ready view of the metrics registry."""
        with self._lock:
            return {
                "counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "histograms": {k: list(v)
                               for k, v in self.histograms.items()},
                "tallies": {k: v.tolist() for k, v in self.tallies.items()},
            }

    def flush(self) -> None:
        with self._lock:
            for s in self.sinks:
                s.flush()

    def close(self) -> None:
        """Emit the final metrics snapshot and close every sink.

        Idempotent — the engine runner calls it from ``close()`` and the
        context-manager exit."""
        if self._closed:
            return
        self._closed = True
        self._emit({"type": "metrics", **self.snapshot()})
        with self._lock:
            for s in self.sinks:
                s.close()


class NoopRecorder(Recorder):
    """The ``telemetry="off"`` recorder: every operation is a no-op.

    A singleton (:data:`NOOP`) shared by every disabled run — it holds
    no state, so sharing is safe.  ``enabled`` is False so hot loops can
    skip argument construction entirely."""

    enabled = False

    def __init__(self):  # no lock, no sinks, no registries
        self.sinks = []
        self.counters = {}
        self.gauges = {}
        self.histograms = {}
        self.tallies = {}

    def span(self, *a, **kw) -> None:
        pass

    def event(self, *a, **kw) -> None:
        pass

    def wall_span(self, *a, **kw):
        return _NULL_CTX

    def counter_add(self, *a, **kw) -> None:
        pass

    def gauge_set(self, *a, **kw) -> None:
        pass

    def observe(self, *a, **kw) -> None:
        pass

    def tally_add(self, *a, **kw) -> None:
        pass

    def snapshot(self) -> Dict[str, Any]:
        return {"counters": {}, "gauges": {}, "histograms": {},
                "tallies": {}}

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


NOOP = NoopRecorder()


def runtime_provenance(device=None) -> Dict[str, Any]:
    """Environment fingerprint stamped into telemetry metas: what
    machine and toolchain produced a number.

    ``device`` is the run's device (default: the CUDA card when there is
    one); ``device_kind`` and ``device_count`` describe it, so a CPU run
    says ``cpu`` and a card run names the card.  Never raises: every
    probe degrades to ``"unknown"``, so telemetry works outside a git
    checkout or without a CUDA device.
    """
    import os
    import platform
    import subprocess

    prov: Dict[str, Any] = {
        "python": platform.python_version(),
        "platform": platform.platform(),
        "cpu_count": os.cpu_count(),
    }
    try:
        import torch

        prov["torch"] = torch.__version__
        prov["cuda"] = torch.version.cuda or "none"
    except Exception:  # pragma: no cover - broken torch install
        prov["torch"] = prov["cuda"] = "unknown"
    try:
        import torch

        dev = torch.device(device) if device is not None else (
            torch.device("cuda") if torch.cuda.is_available() else None)
        if dev is None:
            prov["device_kind"], prov["device_count"] = "none", 0
        elif dev.type == "cuda":
            prov["device_kind"] = torch.cuda.get_device_name(dev)
            prov["device_count"] = torch.cuda.device_count()
        else:
            prov["device_kind"], prov["device_count"] = dev.type, 1
    except Exception:  # pragma: no cover - CUDA init failure
        prov["device_kind"] = prov["device_count"] = "unknown"
    try:
        sha = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            timeout=10, cwd=os.path.dirname(os.path.abspath(__file__)))
        prov["git_sha"] = sha.stdout.strip() if sha.returncode == 0 \
            else "unknown"
    except Exception:  # pragma: no cover - no git binary
        prov["git_sha"] = "unknown"
    return prov


def build_recorder(cfg, meta: Optional[Dict[str, Any]] = None,
                   device=None) -> Recorder:
    """Recorder per ``FLConfig.telemetry``:

    ``"off"``
        the shared :data:`NOOP` instance (default — zero overhead,
        instrumented paths bitwise-identical to uninstrumented ones);
    ``"memory"``
        a :class:`Recorder` over one in-memory sink (tests, notebooks);
    ``"jsonl"``
        a :class:`Recorder` appending every event to
        ``<cfg.telemetry_dir>/events.jsonl`` (``telemetry_dir``
        required), with the final metrics snapshot written at close.

    ``device`` is the run's device, which the meta's provenance names.
    """
    mode = getattr(cfg, "telemetry", "off") or "off"
    if mode == "off":
        return NOOP
    meta = dict(meta or {})
    meta.setdefault("provenance", runtime_provenance(device))
    if mode == "memory":
        from repro_torch.obs.sinks import MemorySink

        return Recorder([MemorySink()], meta=meta)
    if mode == "jsonl":
        from repro_torch.obs.sinks import JsonlSink

        tdir = getattr(cfg, "telemetry_dir", None)
        if not tdir:
            raise ValueError(
                "FLConfig.telemetry='jsonl' requires telemetry_dir")
        from pathlib import Path

        path = Path(tdir)
        path.mkdir(parents=True, exist_ok=True)
        return Recorder([JsonlSink(path / "events.jsonl")], meta=meta)
    raise ValueError(f"unknown telemetry mode {mode!r}; "
                     "expected 'off', 'memory' or 'jsonl'")
