"""Named spans inside the port's own code, on the profiler's clock.

A span is on exactly while a torch profiler records
(``torch.autograd._profiler_enabled()``: ``torch.profiler.profile``, or
the autograd profiler); there is no flag of its own.  Off,
``span(name, device)`` costs that one check and hands back a shared no-op context: it opens no
range, records no event and takes no lock.  On, a span

- opens a host range named ``name`` in the profiler's trace, as a
  ``cpu_op`` (``torch._C._profiler._RecordFunctionFast``).  It is not a
  ``torch.profiler.record_function`` range: that is a user annotation,
  which kineto mirrors onto the device's timeline, where a trace reader
  would take it for a kernel as long as the span.  A ``cpu_op`` range
  stays on the host's timeline, and the kernels launched inside it fall
  inside its interval on the trace's one clock;
- for work on a CUDA device, records a timing event on the current
  stream at entry and another at exit; the stream time between them is
  the span's device time: idle time inside the span counts (where the
  host launches slower than the card runs, the host's pace is what it
  shows), and nested spans are inclusive;
- counts its call.

The device a span times is its caller's: the device of the work it
wraps, or ``None`` for a span around host work (the Recorder's wall
spans), which then has a range and a call count and no device time.
A span never synchronises: its pair of events is kept under a lock (the
backward's spans run on autograd's own device thread) and resolved into
device time by :func:`totals`, which waits for them.

The spans the port opens:

- ``train.forward``, ``train.backward``, ``train.optimizer``
  (:func:`repro_torch.launch.steps.make_train_step`);
- ``model.layer``, one layer's forward, and ``model.layer.recompute``,
  the same layer replayed by remat inside the backward
  (``repro_torch.models.transformer._run``);
- ``plain_backward.<kernel>`` (``flash_attention``, ``rmsnorm``,
  ``ssd_chunk``): a kernel's backward (``repro_torch.kernels.ops``): its
  plain replay and that replay's gradient (``_PlainBackward``), except
  ``plain_backward.flash_attention`` on bf16 tensors on the card, which
  times the backward kernel pair (``_FlashAttention``) under the same
  name, so its reader measures attention's backward whatever computes
  it;
- every wall span of the FL engine's :class:`~repro_torch.obs.Recorder`
  (``trainer.device_step``, ``aggregate.merge``, ...).

An operator reads them after a profiled region::

    from repro_torch.obs import spans

    spans.reset()
    with torch.profiler.profile(activities=[...]):
        for _ in range(n):
            params, opt_state, _ = train_step(params, opt_state, batch)
    t = spans.totals()
    backward_ms = t["train.backward"]["device_ms"] / n
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Optional, Tuple

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import _profiler_enabled

__all__ = ["span", "totals", "reset"]

_OFF = contextlib.nullcontext()
_lock = threading.Lock()
_calls: Dict[str, int] = {}
_device_ms: Dict[str, float] = {}
# (name, start, end) of every span on a CUDA device not yet in _device_ms
_pairs: List[Tuple[str, "torch.cuda.Event", "torch.cuda.Event"]] = []


def span(name: str, device):
    """A context that opens the span ``name`` while a profiler records,
    else does nothing.  ``device`` is where the span's work runs: on a
    CUDA device the span also takes its device time; ``None`` or another
    device, the range and the call alone."""
    if not _profiler_enabled():
        return _OFF
    return _Span(name, device)


class _Span:
    __slots__ = ("name", "stream", "range", "start")

    def __init__(self, name: str, device):
        self.name = name
        self.stream = None
        if device is not None and torch.device(device).type == "cuda":
            self.stream = torch.cuda.current_stream(device)

    def __enter__(self):
        self.range = _RecordFunctionFast(self.name)
        self.range.__enter__()
        if self.stream is not None:
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record(self.stream)
        return self

    def __exit__(self, *exc):
        end = None
        if self.stream is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(self.stream)
        with _lock:
            _calls[self.name] = _calls.get(self.name, 0) + 1
            if end is not None:
                _pairs.append((self.name, self.start, end))
        self.range.__exit__(*exc)
        return False


def totals() -> Dict[str, Dict[str, Optional[float]]]:
    """``{name: {"calls": n, "device_ms": t}}`` of every span since the
    last :func:`reset`, waiting for the device to pass each span's end;
    ``device_ms`` is ``None`` for a span that ran on no CUDA device."""
    with _lock:
        for name, start, end in _pairs:
            end.synchronize()
            _device_ms[name] = (_device_ms.get(name, 0.0)
                                + start.elapsed_time(end))
        _pairs.clear()
        return {n: {"calls": c, "device_ms": _device_ms.get(n)}
                for n, c in _calls.items()}


def reset() -> None:
    """Forget every span's calls and device time, unresolved ones too."""
    with _lock:
        _calls.clear()
        _device_ms.clear()
        _pairs.clear()
