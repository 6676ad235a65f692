"""Run-summary CLI over a telemetry JSONL artifact.

::

    python -m repro_torch.obs.report run_dir/events.jsonl [--trace out.json]

Prints the quantities the baselines in PAPERS.md report but this repo
previously could not extract from a run: the per-block coverage table
(paper Fig. 2), the staleness histogram (semi-async), the up/down
traffic breakdown per assigned width, per-capacity-class participation,
jit-recompile counts (always 0 for a port run, which compiles nothing
per shape), and wall-time summaries of the instrumented host stages.
``--trace`` additionally writes the Perfetto/Chrome ``trace_event``
export of the span stream.  The text is the JAX package's report line
for line, its provenance line aside, so the two compare directly.
"""

from __future__ import annotations

import argparse
import re
from typing import Any, Dict, List, Optional

from repro_torch.obs.coverage import coverage_table, format_coverage

_LBL = re.compile(r"^(?P<name>[^\[]+)\[(?P<labels>.*)\]$")


def split_key(key: str):
    """``name[k=v,...]`` -> (name, {k: v}); plain names pass through."""
    m = _LBL.match(key)
    if not m:
        return key, {}
    labels = {}
    for part in m.group("labels").split(","):
        if "=" in part:
            k, v = part.split("=", 1)
            labels[k] = v
    return m.group("name"), labels


def labelled(counters: Dict[str, float], name: str) -> Dict[str, float]:
    """All ``name[...]`` counter values keyed by their label string."""
    out = {}
    for k, v in counters.items():
        base, labels = split_key(k)
        if base == name:
            out[",".join(f"{a}={b}" for a, b in sorted(labels.items()))] = v
    return out


def _fmt_bytes(b: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(b) < 1024.0 or unit == "TB":
            return f"{b:.1f} {unit}"
        b /= 1024.0
    return f"{b:.1f} TB"  # pragma: no cover


def histogram_lines(values: List[float], bins: int = 8,
                    bar_width: int = 24, integer: bool = False) -> List[str]:
    """Fixed-width text histogram of raw observations."""
    if not values:
        return ["  (no observations)"]
    lo, hi = min(values), max(values)
    if integer:
        edges = [lo + i for i in range(int(hi - lo) + 2)]
    elif lo == hi:
        edges = [lo, hi + 1e-12]
    else:
        step = (hi - lo) / bins
        edges = [lo + i * step for i in range(bins + 1)]
    counts = [0] * (len(edges) - 1)
    for v in values:
        for i in range(len(counts)):
            if v < edges[i + 1] or i == len(counts) - 1:
                counts[i] += 1
                break
    peak = max(counts)
    out = []
    for i, c in enumerate(counts):
        if integer:
            label = f"{int(edges[i])}"
        else:
            label = f"[{edges[i]:.3g}, {edges[i + 1]:.3g})"
        bar = "#" * (int(round(c / peak * bar_width)) if peak else 0)
        out.append(f"  {label:>16}  {c:6d}  |{bar}")
    return out


def _find_metrics(events: List[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    for e in reversed(events):
        if e.get("type") == "metrics":
            return e
    return None


def render_report(events: List[Dict[str, Any]]) -> str:
    """The full text report for one event log."""
    lines: List[str] = []
    meta = events[0] if events and events[0].get("type") == "meta" else {}
    scheme = meta.get("scheme", "?")
    cfg = meta.get("config", {})
    lines.append(f"== repro.obs run report — scheme={scheme} "
                 f"round_mode={cfg.get('round_mode', '?')} "
                 f"trainer={cfg.get('trainer', '?')} ==")
    prov = meta.get("provenance", {})
    if prov:
        # a log of the JAX package's names its framework "jax"
        fw = "torch" if "torch" in prov or "jax" not in prov else "jax"
        lines.append(f"   {fw} {prov.get(fw, '?')} on "
                     f"{prov.get('device_count', '?')}x "
                     f"{prov.get('device_kind', '?')} "
                     f"(git {str(prov.get('git_sha', '?'))[:12]})")

    metrics = _find_metrics(events)
    if metrics is None:
        spans = sum(1 for e in events if e.get("type") == "span")
        lines.append(f"\n{len(events)} events ({spans} spans); no final "
                     "metrics snapshot — run was killed before close(); "
                     "span stream only.")
        return "\n".join(lines)
    counters = metrics.get("counters", {})
    hists = metrics.get("histograms", {})

    lines.append("\n-- per-block coverage (paper Fig. 2 quantity) --")
    lines.append(format_coverage(coverage_table(metrics)))

    lines.append("\n-- traffic --")
    up = labelled(counters, "traffic.up")
    down = labelled(counters, "traffic.down")
    total_up, total_down = sum(up.values()), sum(down.values())
    lines.append(f"uplink   {_fmt_bytes(total_up):>12}")
    lines.append(f"downlink {_fmt_bytes(total_down):>12}")
    for lbl in sorted(set(up) | set(down)):
        lines.append(f"  {lbl or '(unlabelled)':>12}: "
                     f"up {_fmt_bytes(up.get(lbl, 0.0))}, "
                     f"down {_fmt_bytes(down.get(lbl, 0.0))}")

    lines.append("\n-- participation by capacity class --")
    tiers = labelled(counters, "participation.tier")
    if tiers:
        total = sum(tiers.values())
        for lbl, v in sorted(tiers.items(), key=lambda kv: -kv[1]):
            lines.append(f"  {lbl:>20}: {int(v):6d} ({v / total:6.2%})")
    else:
        lines.append("  (none recorded)")

    lines.append("\n-- staleness (semi-async merges) --")
    stale = hists.get("staleness", [])
    if stale:
        lines.append(f"  {len(stale)} merged results, "
                     f"{sum(1 for s in stale if s > 0)} stale")
        lines.extend(histogram_lines(stale, integer=True))
    else:
        lines.append("  (no staleness observations — synchronous run)")

    lines.append("\n-- compiled-step cache --")
    rec_map = labelled(counters, "trainer.jit_recompiles")
    rec = sum(rec_map.values()) + counters.get("trainer.jit_recompiles", 0)
    shapes = len(labelled(counters, "trainer.cohort_shape"))
    lines.append(f"  train-step recompiles: {int(rec)}"
                 + (f" over {shapes} distinct cohort shapes" if shapes
                    else ""))
    for lbl, v in sorted(rec_map.items()):
        lines.append(f"    {lbl}: {int(v)}")

    lines.append("\n-- host wall time (instrumented stages) --")
    stage_names = sorted(k for k in hists if k.endswith("_s"))
    if not stage_names:
        lines.append("  (none recorded)")
    for k in stage_names:
        v = hists[k]
        lines.append(f"  {k[:-2]:>24}: n={len(v):4d}  total="
                     f"{sum(v):8.3f}s  mean={sum(v) / len(v):8.4f}s  "
                     f"max={max(v):8.4f}s")

    ckpt = counters.get("checkpoint.bytes")
    if ckpt:
        lines.append(f"\ncheckpoints: "
                     f"{int(counters.get('checkpoint.saves', 0))} saves, "
                     f"{_fmt_bytes(ckpt)} written")
    return "\n".join(lines)


def main(argv=None) -> int:
    from repro_torch.obs.sinks import load_events

    ap = argparse.ArgumentParser(
        description="Summarize a repro_torch.obs telemetry JSONL artifact")
    ap.add_argument("events", help="path to events.jsonl")
    ap.add_argument("--trace", default=None,
                    help="also write the Perfetto trace_event export here")
    args = ap.parse_args(argv)
    events = load_events(args.events)
    print(render_report(events))
    if args.trace:
        from repro_torch.obs.trace import export_trace

        path = export_trace(events, args.trace)
        print(f"\nwrote trace_event export: {path}")
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
