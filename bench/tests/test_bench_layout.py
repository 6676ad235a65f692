"""What the benchmark runs loads neither JAX nor the JAX package and
reads nothing of ``benchmarks/``; a cell, a configuration, a traffic mix
and a per-layer metric are added as new files alone."""

import ast
import json
import shutil
import subprocess
import sys

from conftest import LM, SMOKE, cell, harness

FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module.split(".")[0]


def test_sources_import_nothing_forbidden():
    for f in (harness.ROOT / "bench").rglob("*.py"):
        if "tests" in f.parts:
            continue
        assert not set(_imports(f)) & FORBIDDEN, f
        assert "benchmarks/" not in f.read_text(), f


def test_a_run_loads_nothing_forbidden():
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {str(harness.BENCH)!r})\n"
        "import run as h\n"
        f"c = h.Cell(h.read_json(h.ROOT / 'BENCHMARK.json'), {LM!r})\n"
        f"h.run_cell(c, 5, 0.2, False, 'cpu', overrides={SMOKE[LM]!r})\n"
        "print(json.dumps({k: getattr(m, '__file__', None) or '' "
        "for k, m in list(sys.modules.items())}))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    mods = json.loads(p.stdout.strip().splitlines()[-1])
    tops = {k.split(".")[0] for k in mods}
    assert "repro_torch" in tops
    assert not tops & FORBIDDEN
    bench_dir = str(harness.ROOT / "benchmarks")
    assert not [f for f in mods.values() if f.startswith(bench_dir)]


def test_new_cell_config_and_metric_are_new_files(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.ROOT / "bench", root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in (root / "bench").rglob("*")
              if p.is_file()}
    b = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    old = cell(LM)
    (root / "bench/configs/lm-narrow.json").write_text(
        json.dumps({**old.config, "name": "lm-narrow",
                    "intermediate_size": 384}))
    shutil.copy(harness.ROOT / "bench/reference/stablelm-3b-heroes.py",
                root / "bench/reference/lm-narrow.py")
    (root / "bench/traffic/train-512.json").write_text(
        json.dumps({**old.traffic, "batch": 16, "seq": 512}))
    (root / "bench/limits/lm-narrow.train-512.json").write_text(
        json.dumps(old.limits))
    (root / "bench/metrics/steps_per_window.train.py").write_text(
        "def read(ctx):\n    return float(ctx['units'])\n")
    b["configs"].append({"name": "lm-narrow", "source": "x",
                         "file": "bench/configs/lm-narrow.json",
                         "reduced": [], "why": "x"})
    b["workloads"].append({"name": "lm-narrow.train-512",
                           "config": "lm-narrow", "traffic": "train-512",
                           "chips": 1, "why": "x"})
    b["end_to_end"][0]["workloads"].append("lm-narrow.train-512")
    b["per_layer"].append({"name": "steps_per_window.train", "unit": "steps",
                           "better": "higher", "source": "host_clock",
                           "layer": "train step",
                           "moves": "train_tokens_per_s",
                           "workloads": ["lm-narrow.train-512"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    new = harness.Cell(b, "lm-narrow.train-512", root)
    assert new.config["intermediate_size"] == 384
    assert new.traffic["seq"] == 512
    over = {"config": {**SMOKE[LM]["config"], "intermediate_size": 384},
            "traffic": {**SMOKE[LM]["traffic"], "batch": 4, "seq": 32}}
    out = harness.run_cell(new, 9, 0.5, True, "cpu", overrides=over)
    assert out["correct"] and out["metrics"]["steps_per_window.train"][
        "value"] >= 1
    assert all(p.read_bytes() == v for p, v in before.items())
