"""Telemetry smoke: a real engine run end to end through the telemetry
stack.

::

    python -m repro_torch.obs.smoke [--out-dir DIR] [--rounds N] \\
        [--device cpu]

Runs two schemes with ``telemetry="jsonl"`` — one synchronous, one
semi-async, so both round loops are exercised — then, per run:

1. validates the ``events.jsonl`` artifact against the schema-1
   validator (:mod:`repro_torch.obs.schema`);
2. exports and re-loads the Perfetto/Chrome ``trace_event`` JSON;
3. renders the ``repro_torch.obs.report`` summary;
4. re-runs the identical config with ``telemetry="off"`` and asserts
   the histories and final weights are **identical** — telemetry must
   never change the simulation.

It runs on the CUDA device unless ``--device cpu`` is given, and never
falls back to the CPU.  On the card both runs take cuDNN's deterministic
algorithms (``torch.backends.cudnn.deterministic``), without which two
identical runs of the CNN already differ in the last bits.  Exits
non-zero on any failure; prints the report text so a log shows what a
run summary looks like.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile
from pathlib import Path

RUNS = (
    {"scheme": "heroes", "round_mode": "sync"},
    {"scheme": "fedavg", "round_mode": "semi_async"},
)


def _cfg(round_mode: str, **kw):
    from repro_torch.fl.types import FLConfig

    return FLConfig(num_clients=10, clients_per_round=4, eval_every=2,
                    tau_fixed=4, tau_max=15, estimate=True,
                    round_mode=round_mode, **kw)


def _run(scheme: str, cfg, rounds: int, device):
    """(history as dicts, final params) of ``rounds`` rounds on
    ``device``."""
    from repro_torch.fl.simulation import build_image_setup, build_runner

    model, px, py, test = build_image_setup(num_clients=cfg.num_clients,
                                            seed=0, device=device)
    with build_runner(scheme, model, px, py, test, cfg=cfg,
                      device=device) as runner:
        hist = runner.run(rounds)
        return [dataclasses.asdict(h) for h in hist], runner.params


def _same_params(a, b) -> bool:
    import torch

    from repro_torch.core.estimator import tree_leaves

    return all(torch.equal(x, y)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def smoke_one(scheme: str, round_mode: str, out_dir: Path,
              rounds: int, device) -> None:
    from repro_torch.obs.report import render_report
    from repro_torch.obs.schema import validate_file
    from repro_torch.obs.sinks import load_events
    from repro_torch.obs.trace import export_trace

    run_dir = out_dir / f"{scheme}_{round_mode}"
    print(f"\n=== smoke: scheme={scheme} round_mode={round_mode} "
          f"({rounds} rounds, {device}) ===")
    hist_on, params_on = _run(scheme, _cfg(
        round_mode, telemetry="jsonl", telemetry_dir=str(run_dir)),
        rounds, device)

    events_path = run_dir / "events.jsonl"
    counts = validate_file(events_path)
    print(f"schema OK: {counts}")
    if not counts.get("span"):
        raise AssertionError("telemetry run recorded no spans")
    if counts.get("metrics") != 1:
        raise AssertionError("missing final metrics snapshot")

    events = load_events(events_path)
    trace_path = export_trace(events, run_dir / "trace.json")
    trace = json.loads(trace_path.read_text(encoding="utf-8"))
    if not isinstance(trace.get("traceEvents"), list) \
            or not trace["traceEvents"]:
        raise AssertionError("trace_event export has no traceEvents")
    n_complete = sum(1 for e in trace["traceEvents"] if e.get("ph") == "X")
    print(f"trace_event OK: {len(trace['traceEvents'])} events "
          f"({n_complete} complete spans)")

    print(render_report(events))

    hist_off, params_off = _run(scheme, _cfg(round_mode, telemetry="off"),
                                rounds, device)
    if hist_on != hist_off:
        raise AssertionError(
            "telemetry=jsonl changed the run history vs telemetry=off")
    if not _same_params(params_on, params_off):
        raise AssertionError(
            "telemetry=jsonl changed the final weights vs telemetry=off")
    print("history parity OK: telemetry on == off "
          f"({len(hist_on)} rounds and the final weights, bitwise)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="End-to-end telemetry smoke over two engine runs")
    ap.add_argument("--out-dir", default=None,
                    help="artifact directory (default: a temp dir)")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="device to run on (default: the CUDA device)")
    args = ap.parse_args(argv)

    import torch

    from repro_torch import resolve_device

    device = resolve_device(args.device)
    out_dir = Path(args.out_dir) if args.out_dir \
        else Path(tempfile.mkdtemp(prefix="obs_smoke_"))
    out_dir.mkdir(parents=True, exist_ok=True)
    cudnn = torch.backends.cudnn
    was = cudnn.deterministic, cudnn.benchmark
    if device.type == "cuda":
        cudnn.deterministic, cudnn.benchmark = True, False
    try:
        for run in RUNS:
            smoke_one(run["scheme"], run["round_mode"], out_dir,
                      args.rounds, device)
    finally:
        cudnn.deterministic, cudnn.benchmark = was
    print(f"\ntelemetry smoke passed; artifacts under {out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
