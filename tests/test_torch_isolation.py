"""The port stands alone: no JAX, nothing of ``repro``, and no silent CPU.

* Importing every ``repro_torch`` module loads neither ``jax`` nor any
  ``repro`` module (checked in a fresh interpreter).
* No source file of the port, and not ``chip_smoke.py``, imports them.
* With no CUDA device, the entry points raise unless asked for the CPU.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts)


def test_importing_every_module_loads_no_jax_and_no_repro():
    mods = list(_modules())
    assert "repro_torch.fl.engine.runner" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("ok")


def _imported_names(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax_and_no_repro(path):
    for name in _imported_names(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "flax"), (path, name)


def test_entry_points_raise_without_cuda_unless_asked_for_cpu(monkeypatch):
    from repro_torch.fl import FLConfig, build_image_setup, run_scheme

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_image_setup(num_clients=4)
    model, px, py, tb = build_image_setup(num_clients=4, device="cpu")
    cfg = FLConfig(num_clients=4, clients_per_round=2, agg_backend="host",
                   tau_fixed=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_scheme("heroes", model, px, py, tb, 1, cfg=cfg)
    hist = run_scheme("heroes", model, px, py, tb, 1, cfg=cfg, device="cpu")
    assert len(hist) == 1
