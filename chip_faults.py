#!/usr/bin/env python3
"""Planted faults in the attention kernels: does the smoke's phase 2 see
them?

    python3 chip_faults.py

Run from the root of a checkout, on a machine with a CUDA device.  For
each fault below it copies ``src/`` and ``chip_smoke.py`` into a fresh
temporary directory, edits one line of one kernel source there (the
checkout is not touched), and runs ``chip_smoke.check_attention`` (the
attention kernels' phase 2, which builds the edited kernel) in a process
of its own.  Each fault must make phase 2 fail at the first case that
runs the edited kernel: the first bf16 flash case for the two faults of
the bf16 flash kernel, the first decode case for the merge's.  Prints
one line per fault (the case it failed at and its worst margin) and
exits 1 unless every fault did.
"""

from __future__ import annotations

import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# name: (kernel source, pattern, replacement, occurrences, the prefix of
# the first phase-2 case that runs the edited code)
FAULTS = {
    "flash: (m, l) correction skipped on the second KV tile": (
        "flash_attention.cu", r"corr\[h\] = fast_exp2\(m\[mt\]\[h\] - mx\);",
        "corr[h] = t == t_begin + 1 ? 1.f : fast_exp2(m[mt][h] - mx);", 1,
        "flash_attention bfloat16"),
    "flash: causal edge off by one": (
        "flash_attention.cu", r"if \(causal\) ok = ok && qpos >= kpos;",
        "if (causal) ok = ok && qpos + 1 >= kpos;", 1,
        "flash_attention bfloat16"),
    "decode: last split dropped in the merge": (
        "decode_attention.cu", r"s < splits;", "s < splits - 1;", 3,
        "decode_attention"),
}
RUN = ("import sys, torch; sys.path.insert(0, 'src'); import chip_smoke as cs;"
       " torch.backends.cuda.matmul.allow_tf32 = False;"
       " cs.check_attention(torch)")


def plant(workdir: Path, source: str, pattern: str, repl: str,
          count: int) -> None:
    shutil.copytree(ROOT / "src", workdir / "src",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(ROOT / "chip_smoke.py", workdir)
    path = workdir / "src" / "repro_torch" / "csrc" / source
    text, n = re.subn(pattern, repl, path.read_text(), count=count)
    if n != count:
        raise RuntimeError(f"{source}: {pattern!r} found {n} times, not "
                           f"{count}")
    path.write_text(text)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_faults: no CUDA device", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for i, (name, (source, pat, repl, count, _)) in enumerate(
                FAULTS.items()):
            work = Path(tmp) / f"fault{i}"
            plant(work, source, pat, repl, count)
            procs[name] = subprocess.Popen(
                [sys.executable, "-c", RUN], cwd=work, text=True,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        caught = 0
        for name, proc in procs.items():
            out, _ = proc.communicate()
            cases = [line.strip() for line in out.splitlines()
                     if "max_abs_err" in line]
            first = next((c for c in cases
                          if c.startswith(FAULTS[name][4])), None)
            failed = proc.returncode != 0 and "SmokeFailure" in out
            at_first = failed and bool(cases) and cases[-1] == first
            caught += at_first
            print(f"fault [{name}]: phase 2 "
                  + (f"failed at its first case ({len(cases)} cases run): "
                     f"{cases[-1]}" if at_first else
                     f"did not fail at its first case {first!r}: exit "
                     f"{proc.returncode}, last case "
                     f"{cases[-1] if cases else None!r}"))
    print(f"{caught} of {len(FAULTS)} planted faults failed phase 2 at "
          "their first case")
    return 0 if caught == len(FAULTS) else 1


if __name__ == "__main__":
    sys.exit(main())
