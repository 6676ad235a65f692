#!/usr/bin/env python3
"""Planted faults in the composition, attention, SSD-chunk and RMSNorm
kernels, in the merge over a cohort's shards, in the production mesh's
rules, context and local shards, and in the checkpoint codec and its
mesh save and restore: does the smoke see them?

    python3 chip_faults.py

Run from the root of a checkout, on a machine with a CUDA device.  For
each fault below it copies ``src/`` and ``chip_smoke.py`` into a fresh
temporary directory, edits one line of one kernel source (or of the
port's merge) there (the checkout is not touched), and runs that
kernel's phase 2 from ``chip_smoke`` (``check_kernels``,
``check_attention`` or ``check_ssd_rmsnorm``, which builds the edited
kernel), or path (v)'s first case (``check_mesh``: the merge over 8
logical shards of the card), in a process of its own.  Each fault must make
phase 2 fail at the first case that runs the edited code: the first
conv_rank case for a dropped tap, its first stride-2 case for the
padding's, the first rank_apply case for its column tiles', the first
compose_apply case for its column tiles', its first case built in chunks
for the chunks', compose's first case with m*O not a multiple of 4 for
its scalar tail's, its first case with a client axis for the client
offset's, the first client-batched case of conv_rank, rank_apply and
compose_apply with more than one client for their client offsets', the
first bf16 flash case for the two faults of the bf16 flash
kernel, the first flash case with per-row key counts for an ignored
``kv_len``, the first flash case with fewer queries than keys,
non-causal, for a launcher that aligns such a call as causal, the first
decode case for the merge's, the first bf16 ssd_chunk case for the bf16
SSD kernels', the first (f32) rmsnorm case for the one-pass rmsnorm's, and path (v)'s
first case for a shard fold that drops the last shard's partial and for a
trainer's stack passed through to the merge whatever rows it asked for;
and path (w)'s checks (``check_dryrun``, in a fake world of 256 of its
own) for the production mesh: its first case (the rules' projection
conventions) for a row-parallel rule with its axes swapped, its residual
layout case for a ``constrain_residual`` that drops the data-parallel
axis, its first local-shard flash case for a ``local_map`` that takes
flash's heads replicated, and its first factorized-linear case for a
chunked rank_apply that leaves the last basis chunk out; the codec's
check (``check_codec``) at its first case, a payload of 16 leaves, for a
writer that gives 16 keys a fixmap header instead of map16; and path
(w7)'s first cases (``check_mesh_ckpt``, a state of every placement
saved and restored as rank 0 of a fake world of 512 of its own): its
first (rank 0's block of each leaf in the file) for a mesh save that
leaves rank 0's own block uncopied, and its restore case for a restore
that takes the neighbouring block of a dim sharded over two mesh axes.
Prints one line per fault (the case it failed at and its worst margin)
and exits 1 unless every fault did.
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
# the first phase-2 case that runs the edited code, the phase-2 check)
FAULTS = {
    "conv_rank: the last tap dropped": (
        "conv_rank.cu", r"for \(int kx = 0; kx < K; \+\+kx\) \{",
        "for (int kx = 0; kx < K - (ky == K - 1); ++kx) {", 1,
        "conv_rank square p=1 s=1", "check_kernels"),
    "conv_rank: stride-2 low padding off by one": (
        "conv_rank.cu", r"const int h0 = ho0 \* stride - pad_h;",
        "const int h0 = ho0 * stride - pad_h - (stride == 2);", 1,
        "conv_rank square p=1 s=2", "check_kernels"),
    "rank_apply: the last column tile left unwritten": (
        "rank_apply.cu", r"if \(dq \* 4 >= cols\) continue;",
        "if (dq * 4 >= cols || blockIdx.y + 1 == gridDim.y) continue;", 1,
        "rank_apply square p=1", "check_kernels"),
    "compose_apply: the last column tile left unwritten": (
        "compose_apply.cu", r"const bool live = mm < rows && dq < DQ;",
        "const bool live = mm < rows && dq < DQ && "
        "blockIdx.y + 1 < gridDim.y;", 1,
        "compose_apply edge", "check_kernels"),
    "compose_apply: the second weight chunk built from the first's rows": (
        "compose_apply.cu", r"const int k = k0 \+ kk;",
        "const int k = kk;", 1,
        "compose_apply edge xg(5, 3, 512)", "check_kernels"),
    "compose: the scalar columns past the last quad's dropped": (
        "compose.cu", r"\*dst = acc;", "if (j < MO - MO % 4) *dst = acc;", 1,
        "compose fc p=1", "check_kernels"),
    "compose: the coefficient's client offset off by one": (
        "compose.cu", r"\(static_cast<long long>\(c\) \* m \+ b\)",
        "(static_cast<long long>(c > 0 ? c - 1 : 0) * m + b)", 1,
        "compose C=4", "check_kernels"),
    "conv_rank: every client reads client 0's basis": (
        "conv_rank.cu",
        r"basis \+= static_cast<long long>\(client\) \* K \* K \* I \* R;",
        "basis += 0 * static_cast<long long>(client) * K * K * I * R;", 1,
        "conv_rank cohort C=3", "check_kernels"),
    "rank_apply: every client reads client 0's basis": (
        "rank_apply.cu", r"v \+= client \* I \* R;",
        "v += 0 * client * I * R;", 1,
        "rank_apply cohort C=3", "check_kernels"),
    "compose_apply: every client reads client 0's basis": (
        "compose_apply.cu", r"v \+= client \* I \* R;",
        "v += 0 * client * I * R;", 1,
        "compose_apply cohort C=3", "check_kernels"),
    "flash: (m, l) correction skipped on the second KV tile": (
        "flash_attention.cu", r"corr\[h\] = fast_exp2\(m\[mt\]\[h\] - mx\);",
        "corr[h] = t == t_begin + 1 ? 1.f : fast_exp2(m[mt][h] - mx);", 1,
        "flash_attention bfloat16", "check_attention"),
    "flash: causal edge off by one": (
        "flash_attention.cu", r"if \(causal\) ok = ok && qpos >= kpos;",
        "if (causal) ok = ok && qpos + 1 >= kpos;", 1,
        "flash_attention bfloat16", "check_attention"),
    "flash: kv_len ignored (every row sees all Sk keys)": (
        "flash_attention.cu",
        r"kv_len \? max\(0, min\(Sk, kv_len\[b / q_per_kv\]\)\) : Sk;",
        "Sk;", 2,
        "flash_attention float32 kv_len", "check_attention"),
    "flash: a non-causal Sq != Sk call aligned as causal": (
        "flash_attention.cu", r"q_per_kv, causal, window, st\)\);",
        "q_per_kv, causal || Sq != Sk, window, st));", 2,
        "flash_attention float32 Sq!=Sk", "check_attention"),
    "decode: last split dropped in the merge": (
        "decode_attention.cu", r"s < splits;", "s < splits - 1;", 3,
        "decode_attention", "check_attention"),
    "ssd_chunk: causal edge off by one": (
        "ssd_chunk.cu", r"const bool live = kt < m \|\| j <= i;",
        "const bool live = kt < m || j <= i + 1;", 1,
        "ssd_chunk bfloat16", "check_ssd_rmsnorm"),
    "ssd_chunk: carry-in dropped for a warp's query tiles after its first": (
        "ssd_chunk.cu",
        r"const float e\[2\] = \{expf\(ci\[0\]\), expf\(ci\[1\]\)\};",
        "const float e[2] = {s > 0 ? 0.f : expf(ci[0]), "
        "s > 0 ? 0.f : expf(ci[1])};", 1,
        "ssd_chunk bfloat16", "check_ssd_rmsnorm"),
    "ssd_chunk: the scores' last state column left out": (
        "ssd_chunk.cu",
        r"n < N; \+\+n\) \{\n(    const float4 ca = \*reinterpret_cast"
        r"<const float4\*>\(Ct \+ n \* SC_LD)",
        r"n < N - 1; ++n) {\n\1", 1,
        "ssd_chunk bfloat16", "check_ssd_rmsnorm"),
    "merge: the shard fold drops the last shard's partial": (
        "core/aggregation.py", r"for p in partials\[1:\]:",
        "for p in partials[1:-1]:", 1,
        "(v0) merge over 8 logical shards", "check_mesh"),
    "merge: a stack passes through whatever its n_real": (
        "fl/engine/collective.py",
        r"rows == list\(range\(stack\.n_real\)\)",
        "rows == list(range(len(rows)))", 1,
        "(v0) merge over 8 logical shards", "check_mesh"),
    "rules: a row-parallel rule with its axes swapped": (
        "sharding/rules.py", r'wo\\\.w\$", \("model", "data"\)\)',
        r'wo\\.w$", ("data", "model"))', 1,
        "(w0) rules", "check_dryrun"),
    "context: constrain_residual drops the data-parallel axis": (
        "sharding/context.py", r'"d_sharded": \(dp, None, "model"\),',
        '"d_sharded": (None, None, "model"),', 1,
        "(w0) residual", "check_dryrun"),
    "ops: flash's local_map takes the heads replicated": (
        "kernels/ops.py",
        r'return \(\(dp, None, "model", None, None\), '
        r'\(dp, None, "model", None\)\)',
        'return ((dp, None, None, None, None), (dp, None, None, None))', 1,
        "(w6) flash heads", "check_dryrun"),
    "ops: the factorized linear's last basis chunk left out": (
        "kernels/ops.py", r"for i0 in range\(0, I, ci\):",
        "for i0 in range(0, I - ci, ci):", 1,
        "(w6) factorized linear float32", "check_dryrun"),
    "rmsnorm: the row's last vector left out of the sum": (
        "rmsnorm.cu", r"for \(int v = 0; v < VPT; \+\+v\) ss \+= "
        r"sum_sq<T>\(xv\[v\]\);",
        "for (int v = 0; v < VPT; ++v) ss += (v == VPT - 1 && t == tpr - 1) "
        "? 0.f : sum_sq<T>(xv[v]);", 1,
        "rmsnorm float32", "check_ssd_rmsnorm"),
    "restore: a dim over two mesh axes takes the neighbouring block": (
        "checkpoint/msgpack_ckpt.py",
        r"local\.copy_\(src\[_region\(shape, offset\)\]\)",
        "local.copy_(src[_region(shape, [o + n * (sum(getattr(p, 'dim', -1) "
        "== d for p in placements) > 1) for d, (o, n) in "
        "enumerate(zip(offset, shape))])])", 1,
        "(w7s) restored shards", "check_mesh_ckpt"),
    "save: rank 0's own block left uncopied": (
        "checkpoint/msgpack_ckpt.py",
        r"if r == 0:\n            part = local",
        "if r == 0:\n            continue", 1,
        "(w7s) fake world of 512: rank 0's block", "check_mesh_ckpt"),
    "codec: a map of 16 keys headed as a fixmap, not map16": (
        "checkpoint/msgpack_ckpt.py",
        r"return _sized\(n, 15, 0x80, \(0xDE",
        "return _sized(n, 16, 0x80, (0xDE", 1,
        "codec map16", "check_codec"),
}
# TF32 off for matmuls and convolutions, as chip_smoke.main sets it: the
# plain conv_rank runs F.conv2d, which cuDNN would take in TF32
RUN = ("import sys, torch; sys.path.insert(0, 'src'); import chip_smoke as cs;"
       " torch.backends.cuda.matmul.allow_tf32 = False;"
       " torch.backends.cudnn.allow_tf32 = False;"
       " cs.{check}(torch)")


def plant(workdir: Path, source: str, pattern: str, repl: str,
          count: int) -> None:
    shutil.copytree(ROOT / "src", workdir / "src",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(ROOT / "chip_smoke.py", workdir)
    pkg = workdir / "src" / "repro_torch"
    path = pkg / source if source.endswith(".py") else pkg / "csrc" / source
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
        for i, (name, (source, pat, repl, count, _, check)) in enumerate(
                FAULTS.items()):
            work = Path(tmp) / f"fault{i}"
            plant(work, source, pat, repl, count)
            procs[name] = subprocess.Popen(
                [sys.executable, "-c", RUN.format(check=check)], cwd=work,
                text=True,
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
            print(f"fault [{name}]: {FAULTS[name][5]} "
                  + (f"failed at its first case ({len(cases)} cases run): "
                     f"{cases[-1]}" if at_first else
                     f"did not fail at its first case {first!r}: exit "
                     f"{proc.returncode}, last case "
                     f"{cases[-1] if cases else None!r}"))
    print(f"{caught} of {len(FAULTS)} planted faults failed their check at "
          "its first case")
    return 0 if caught == len(FAULTS) else 1


if __name__ == "__main__":
    sys.exit(main())
