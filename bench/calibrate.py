"""Readings that the correctness limits are set from.

    python3 bench/calibrate.py --workload <name> --seeds 11,12,13 \
        [--control 1] [--program 0] [--fault <name>]

For each seed, in one process: the cell's set-up (which drives the timed
path through its checked steps), the program's state freed, and the
numbers the run compares, as a run would compute them; with
``--control 1`` also the control's numbers (the reference computed in
the precision below the configuration's, in the program's place).  One
JSON line per seed and side on standard output.  A limit lies above the
largest program reading over a dozen seeds or more and below the
smallest control reading (``bench/limits/<workload>.json``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import run as harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--program", type=int, default=1)
    ap.add_argument("--fault", default=None,
                    help="plant this fault of the cell's kind in the "
                    "program for the set-up (the program's readings then "
                    "read the fault)")
    args = ap.parse_args(argv)
    cell = harness.Cell(harness.read_json(harness.ROOT / "BENCHMARK.json"),
                        args.workload)
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        run = cell.kind.make(cell.config, cell.traffic, seed, "cuda", False,
                               cell.reference)
        planted = (cell.kind.fault(args.fault) if args.fault
                   else contextlib.nullcontext())
        with planted:
            run.setup()
        run.sync()
        t1 = time.perf_counter()
        run.release()
        rows = []
        if args.program:
            rows.append((args.fault or "program", run.readings()))
        t2 = time.perf_counter()
        if args.control:
            rows.append(("control", run.control_readings()))
        t3 = time.perf_counter()
        for side, got in rows:
            print(json.dumps({"seed": seed, "side": side, "readings": got,
                              "setup_s": t1 - t0, "reference_s": t2 - t1,
                              "control_s": t3 - t2}), flush=True)
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
