"""One run of one benchmark cell of the PyTorch/CUDA port (``repro_torch``).

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell is an entry of ``workloads`` in
``BENCHMARK.json``; everything else is found by name under ``bench/``:

- ``bench/configs/<config>.json``: the configuration (its sizes);
- ``bench/traffic/<traffic>.json``: the traffic mix, whose ``kind``
  names the general generator ``bench/kinds/<kind>.py`` that reads it;
- ``bench/limits/<workload>.json``: the limits of the cell's correctness
  comparison, each set from the readings ``bench/calibrate.py`` gives;
- ``bench/reference/<config>.py``: the plain reference the comparison
  holds the program to;
- ``bench/metrics/<metric>.py``: the reader of each per-layer metric.

A run builds the cell (its inputs and weights made from ``--seed``),
warms it up, measures for ``--seconds`` seconds, then frees the program's
state and holds what the timed path produced to the reference.  The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace
0``, its per-layer metrics with ``--trace 1``), ``device``, with
``--trace 1`` the ``breakdown`` of the device trace, and last ``checks``:
each compared number beside its limit, which also end standard error.
Without a CUDA device, or with fewer than the cell asks for, it exits 2
and prints no result; if JAX or the JAX package was loaded, it exits 3.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "bench"
CACHE = ROOT / ".bench_cache"
# whatever the program or torch would cache stays inside the checkout, at
# fixed paths, so only a checkout's first run builds
os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
os.environ.setdefault("USE_FLAX", "0")
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_module(path: Path, name: str):
    """Import the Python file ``path`` as a module called ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _ident(name: str) -> str:
    return "".join(c if c.isalnum() else "_" for c in name)


def read_json(path: Path):
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload of ``BENCHMARK.json`` with its files resolved."""

    def __init__(self, bench: dict, workload: str, root: Path = ROOT):
        self.bench = bench
        self.root = root
        try:
            self.entry = next(w for w in bench["workloads"]
                              if w["name"] == workload)
        except StopIteration:
            raise SystemExit(f"unknown workload {workload!r}") from None
        self.name = workload
        conf = next(c for c in bench["configs"]
                    if c["name"] == self.entry["config"])
        self.config = read_json(root / conf["file"])
        self.traffic = read_json(
            root / "bench" / "traffic" / f"{self.entry['traffic']}.json")
        self.limits = read_json(root / "bench" / "limits" / f"{workload}.json")
        self.chips = int(self.entry["chips"])
        self.reference = load_module(
            root / "bench" / "reference" / f"{self.entry['config']}.py",
            f"bench_reference_{_ident(self.entry['config'])}")
        self.kind = load_module(
            root / "bench" / "kinds" / f"{self.traffic['kind']}.py",
            f"bench_kind_{_ident(self.traffic['kind'])}")

    def end_to_end(self):
        return [m for m in self.bench["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self):
        """The per-layer metrics this cell reports: those that list it,
        and those without a list that move one of its end-to-end
        metrics."""
        mine = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in mine)]


def forbidden_modules():
    return sorted({k.split(".")[0] for k in list(sys.modules)}
                  & set(FORBIDDEN))


class LaunchLog:
    """Every kernel launch of the port while installed: ``(name,
    scalars)``, through ``repro_torch.kernels.LAUNCH_HOOKS``."""

    def __init__(self):
        self.records = []

    def __call__(self, name, tensors, scalars):
        self.records.append((name, tuple(scalars)))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None,
             overrides: dict | None = None) -> dict:
    """Set up, measure and check one run; returns the result object.

    ``overrides`` (tests) updates the configuration and the traffic:
    ``{"config": {...}, "traffic": {...}}``."""
    import torch

    from repro_torch import kernels

    t_start = time.perf_counter() if t_start is None else t_start
    config = {**cell.config, **(overrides or {}).get("config", {})}
    traffic = {**cell.traffic, **(overrides or {}).get("traffic", {})}
    cuda = device.startswith("cuda")
    torch.set_num_threads(4)
    run = cell.kind.make(config, traffic, seed, device, trace,
                           cell.reference)
    run.setup()
    run.sync()
    setup_s = time.perf_counter() - t_start

    log = LaunchLog()
    prof = None
    if trace:
        kernels.LAUNCH_HOOKS.append(log)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    units, work = [], 0.0
    window = (torch.profiler.record_function("bench.window") if trace
              else None)
    if window is not None:
        window.__enter__()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        u0 = time.perf_counter()
        if trace:  # synchronised unit boundaries: a unit's range covers
            # its device work, and names the idle gaps inside it
            with torch.profiler.record_function("bench.unit"):
                work += run.step()
                run.sync()
        else:
            work += run.step()
        units.append((u0, time.perf_counter()))
    run.sync()
    t1 = time.perf_counter()
    if window is not None:
        window.__exit__(None, None, None)
    summary = None
    if trace:
        prof.__exit__(None, None, None)
        kernels.LAUNCH_HOOKS.remove(log)
        from devtrace import events, summarize
        kern, host = events(prof)
        win = [(s, e) for n, s, e in host if n == "bench.window"]
        lo, hi = win[0] if win else (t0, t1)
        kern = [k for k in kern if k[2] > lo and k[1] < hi]
        summary = summarize(kern, host, lo, hi)
        summary["kernels"] = kern
        del prof
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    ctx = {"units": len(units), "window_s": t1 - t0,
           "work": work, "launch_records": log.records,
           "run": run, "config": config, "traffic": traffic,
           "trace": summary}
    metrics = {}
    if trace:
        for m in cell.per_layer():
            reader = load_module(cell.root / "bench" / "metrics"
                                 / f"{m['name']}.py",
                                 f"bench_metric_{_ident(m['name'])}")
            value = reader.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end():
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": "s"}
            elif m["name"] == run.rate_metric:
                metrics[m["name"]] = {"value": work / (t1 - t0),
                                      "unit": m["unit"]}
    run.release()
    correct, checks = run.check(cell.limits)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": len(units),
           "failed": run.failed, "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        out["breakdown"] = summary["breakdown"]
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = Cell(read_json(ROOT / "BENCHMARK.json"), args.workload)

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"bench: the cell needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   "cuda", t_start=T_PROCESS)
    bad = forbidden_modules()
    if bad:
        print(f"bench: loaded {bad}; the port's run must not load JAX or "
              "the JAX package", file=sys.stderr)
        return 3
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
