"""Reduction of a ``torch.profiler`` trace to the numbers the benchmark
reports: the device's busy time as the union of kernel intervals (a sum
of kernel times would count work on overlapping streams twice), kernel
time by name, and the longest idle gaps named by the host activity that
covers them."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

Interval = Tuple[float, float]


def union_length(intervals: Sequence[Interval]) -> float:
    """Total length covered by ``intervals`` (each ``(start, end)``)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: Sequence[Interval], lo: float, hi: float
         ) -> List[Interval]:
    """The stretches of ``[lo, hi]`` that no interval covers."""
    out, t = [], lo
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


def by_name(kernels: Sequence[Tuple[str, float, float]]) -> Dict[str, float]:
    """Seconds of kernel time per kernel name."""
    out: Dict[str, float] = {}
    for name, s, e in kernels:
        out[name] = out.get(name, 0.0) + (e - s)
    return out


WINDOW = "bench.window"


def name_gap(gap: Interval, host: Sequence[Tuple[str, float, float]]) -> str:
    """The host activity during ``gap``: the shortest host event inside
    the window that covers the whole gap, else the one that overlaps it
    most."""
    s, e = gap
    host = [h for h in host if h[0] != WINDOW]
    covering = [(he - hs, n) for n, hs, he in host if hs <= s and he >= e]
    if covering:
        return min(covering)[1]
    best, name = 0.0, "host (no event)"
    for n, hs, he in host:
        ov = min(he, e) - max(hs, s)
        if ov > best:
            best, name = ov, n
    return name


def summarize(kernels: Sequence[Tuple[str, float, float]],
              host: Sequence[Tuple[str, float, float]],
              lo: float, hi: float, top: int = 10) -> dict:
    """``busy_s``, ``window_s`` and the ``breakdown`` of a traced result from
    kernel and host events ``(name, start_s, end_s)`` of one traced window
    ``[lo, hi]``."""
    ivs = [(max(s, lo), min(e, hi)) for _, s, e in kernels
           if e > lo and s < hi]
    busy = union_length(ivs)
    ops = sorted(by_name(kernels).items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(gaps(ivs, lo, hi), key=lambda g: g[0] - g[1])[:top]
    return {
        "busy_s": busy,
        "window_s": hi - lo,
        "breakdown": {
            "device_ops": [[n, t] for n, t in ops],
            "idle_gaps": [[name_gap(g, host), g[1] - g[0]] for g in idle],
        },
    }


def events(prof) -> Tuple[list, list]:
    """Kernel and host events of a finished ``torch.profiler.profile`` as
    ``(name, start_s, end_s)`` lists, on the profiler's clock."""
    from torch.autograd import DeviceType

    kernels, host = set(), []
    for ev in prof.profiler.kineto_results.events():
        s = ev.start_ns() * 1e-9
        e = s + ev.duration_ns() * 1e-9
        if ev.device_type() == DeviceType.CUDA:
            # the harness's own annotations also land on the device's
            # timeline; they are not device work
            if not ev.name().startswith("bench."):
                kernels.add((ev.name(), s, e))
        else:
            host.append((ev.name(), s, e))
    return sorted(kernels, key=lambda k: k[1]), host
