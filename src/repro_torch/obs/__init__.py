"""repro_torch.obs — structured telemetry for the FL engine, and spans
on the profiler's clock.

A metrics registry (counters / gauges / histograms / per-block tallies)
plus a span tracer over the simulation's **virtual clock** and the host
wall clock, fanned out to pluggable sinks (in-memory, JSONL,
Perfetto/Chrome ``trace_event`` export).  Off by default
(``FLConfig.telemetry="off"`` routes every call to the no-op
:data:`NOOP` recorder); when enabled, instrumented runs stay
bitwise-identical to uninstrumented ones — telemetry only *reads*
quantities the engine already computed.  The event log is the JAX
package's schema 1, so a log written by either package validates and
renders in the other.

Entry points::

    python -m repro_torch.obs.report run_dir/events.jsonl   # run summary
    python -m repro_torch.obs.trace  run_dir/events.jsonl t.json  # Perfetto
    python -m repro_torch.obs.smoke [--device cpu]           # end-to-end

The metric catalog is the JAX package's (``docs/OBSERVABILITY.md``);
ROADMAP C.11 lists where the port's stream differs: wall spans around
device work end with a synchronize of the CUDA device, there is no
``trainer.jit_recompiles`` counter, ``trainer.cohort_shape`` counts the
unpadded group, and ``checkpoint.bytes`` counts the step directory's files.

:mod:`repro_torch.obs.spans` is the port's own: named ranges inside the
train step, the model's layers and the kernels' plain backward (and
around each wall span of the :class:`Recorder`), on while a torch
profiler records, each with its calls and its device time
(``spans.totals()``).
"""

from repro_torch.obs.coverage import coverage_table, format_coverage
from repro_torch.obs.recorder import (NOOP, NoopRecorder, Recorder, build_recorder,
                                metric_key, runtime_provenance)
from repro_torch.obs.schema import validate_event, validate_events, validate_file
from repro_torch.obs.sinks import JsonlSink, MemorySink, Sink, load_events
from repro_torch.obs import spans
from repro_torch.obs.trace import export_trace, to_trace_events

__all__ = [
    "Recorder", "NoopRecorder", "NOOP", "build_recorder", "metric_key",
    "runtime_provenance",
    "Sink", "MemorySink", "JsonlSink", "load_events",
    "validate_event", "validate_events", "validate_file",
    "to_trace_events", "export_trace",
    "coverage_table", "format_coverage",
    "spans",
]
