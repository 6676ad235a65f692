#!/usr/bin/env python3
"""Run timing functions of the smoke on two trees in turns, on one NVIDIA GPU.

    python3 chip_compare.py OTHER_TREE FUNCTION [FUNCTION ...]

Run from the root of a checkout, on a machine with a CUDA device.
OTHER_TREE is another tree of this repository, for example its parent
commit unpacked with ``git archive`` into a git-ignored directory.  Each
FUNCTION names a function of this checkout's ``chip_smoke`` that takes
``(torch, rn)`` or ``(torch)`` and returns a dict, for example
``composition_times``, ``rank_kernel_times`` or ``calibration_record``.
In four processes, in the order other, this, this, other, each with TF32
off and that tree's ``src/`` first on its path (so each tree builds and
times its own kernels), it calls the functions in the order given and
prints each run's results as a JSON line.  Then, for every timing record
among the results (a dict with ``ms``, and the records under its
``more_shapes``), it prints a table row of ``ms`` and ``call_ms`` for the
four runs beside the first run of this tree's ``plain_ms``,
``library_ms`` and ``bound_ms``; for every other number a record or
result carries, a row of its four values; and the card's name and power
limit.  Exits 1 if a run fails.
"""

from __future__ import annotations

import inspect
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ORDER = ("other", "this", "this", "other")
TABLED = {"ms", "call_ms", "plain_ms", "library_ms", "bound_ms"}

RUN = """
import json, sys
sys.path.insert(0, {src!r})
sys.path.insert(1, {root!r})
import torch
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
gen = torch.Generator().manual_seed(0)
def rn(*shape, scale=0.5):
    return (scale * torch.randn(shape, generator=gen)).to("cuda")
out = {{}}
for name, takes_rn in {calls!r}:
    fn = getattr(cs, name)
    out[name] = fn(torch, rn) if takes_rn else fn(torch)
print("RECORD " + json.dumps(out))
"""


def rows_of(result: dict, where: str):
    """(label, record-or-number) pairs of one function's result, in order:
    each timing record (and those under its ``more_shapes``) and each other
    number, labelled by where it sits."""
    for key, val in result.items():
        here = f"{where}.{key}"
        if isinstance(val, dict) and "ms" in val:
            for rec in [val] + list(val.get("more_shapes", [])):
                yield f"{here} | {rec.get('shape', '')}", rec
            for k, x in val.items():
                if k not in TABLED and isinstance(x, (int, float)) \
                        and not isinstance(x, bool):
                    yield f"{here}.{k}", x
        elif isinstance(val, dict):
            yield from rows_of(val, here)
        elif isinstance(val, (int, float)) and not isinstance(val, bool):
            yield here, val


def main() -> int:
    if len(sys.argv) < 3:
        print(__doc__, file=sys.stderr)
        return 2
    other = Path(sys.argv[1]).resolve()
    if not (other / "src" / "repro_torch").is_dir():
        print(f"chip_compare: {other} holds no src/repro_torch",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_compare: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    calls = []
    for name in sys.argv[2:]:
        fn = getattr(cs, name, None)
        if not callable(fn):
            print(f"chip_compare: chip_smoke has no function {name}",
                  file=sys.stderr)
            return 2
        calls.append((name, len(inspect.signature(fn).parameters) > 1))

    trees = {"other": other, "this": ROOT}
    runs = []
    for label in ORDER:
        code = RUN.format(src=str(trees[label] / "src"), root=str(ROOT),
                          calls=calls)
        proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                              capture_output=True, text=True)
        line = next((ln for ln in proc.stdout.splitlines()
                     if ln.startswith("RECORD ")), None)
        if proc.returncode != 0 or line is None:
            print(proc.stdout[-4000:] + proc.stderr[-4000:])
            print(f"chip_compare: the {label} tree's run failed",
                  file=sys.stderr)
            return 1
        rec = json.loads(line[len("RECORD "):])
        print(f"{label} {json.dumps(rec)}")
        runs.append(dict(rows_of(rec, "")))

    print(f"record | shape | ms: {', '.join(ORDER)} | call_ms: "
          f"{', '.join(ORDER)} | plain_ms | library_ms | bound_ms")
    nan = float("nan")
    for label, first in runs[ORDER.index("this")].items():
        vals = [run.get(label) for run in runs]
        if isinstance(first, dict):
            vals = [r or {} for r in vals]
            ms = ", ".join(f"{r.get('ms', nan):.7f}" for r in vals)
            call = ", ".join(f"{r.get('call_ms', nan):.7f}" for r in vals)
            lib = first.get("library_ms")
            print(f"{label[1:]} | {ms} | {call} | "
                  f"{first.get('plain_ms', nan):.7f} | "
                  f"{'null' if lib is None else f'{lib:.7f}'} | "
                  f"{first.get('bound_ms', nan):.7f}")
        else:
            print(f"{label[1:]}: {', '.join(repr(v) for v in vals)}")
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
