"""The port stands alone: no JAX, nothing of ``repro``, and no silent CPU.

* Importing every ``repro_torch`` module loads neither ``jax`` nor any
  ``repro`` module (checked in a fresh interpreter).
* No source file of the port, and neither ``chip_smoke.py`` nor
  ``chip_faults.py``, imports them.
* The build cache keys every kernel library on its source and every
  shared header.
* With no CUDA device, the entry points (``init_factorized`` and
  ``init_dense``, the calibration entry points, and the model zoo's
  ``model.init`` / ``init_cache`` / ``launch.serve`` included) raise
  unless asked for the CPU.
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
    assert {"repro_torch.models.model", "repro_torch.models.ssm",
            "repro_torch.launch.serve", "repro_torch.configs",
            "repro_torch.kernels.ssd_chunk",
            "repro_torch.kernels.rmsnorm", "repro_torch.sharding.fl",
            "repro_torch.fl.engine.collective",
            "repro_torch.models.moe_shardmap"} <= set(mods)
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
                         + [ROOT / "chip_smoke.py", ROOT / "chip_faults.py"],
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
    for init in (model.init_factorized, model.init_dense):
        with pytest.raises(RuntimeError, match="CUDA"):
            init(0)
        leaves = init(0, device="cpu").values()
        assert all(t.device.type == "cpu" for leaf in leaves
                   for t in (leaf.values() if isinstance(leaf, dict)
                             else [leaf]))


def test_text_entry_points_raise_without_cuda_unless_asked_for_cpu(
        monkeypatch):
    from repro_torch.fl import (build_text_setup, greedy_decode,
                                serving_weights)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_text_setup(num_clients=4, model_name="transformer")
    model, _, _, tb = build_text_setup(num_clients=4,
                                       model_name="transformer",
                                       device="cpu")
    assert model.name == "transformer" and tb["tokens"].device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init_factorized(0)
    w = serving_weights(model, model.init_factorized(0, device="cpu"), 1)
    toks, _ = greedy_decode(model, w, 1, [[1, 2]], 2)
    assert toks.shape == (1, 2)


def test_calibration_entry_points_raise_without_cuda_unless_asked_for_cpu(
        monkeypatch):
    """The calibration measures where the run is: with no device given
    that is the CUDA card, as for every entry point, never a silent CPU
    measurement for a CUDA run."""
    from repro_torch.core import calibration as cal
    from repro_torch.core.composition import conv_rank_overhead
    from repro_torch.fl import FLConfig
    from repro_torch.fl.models import make_cnn

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    auto = FLConfig(forward_impl="auto")
    calls = {
        "measure": cal.measure,
        "get_calibration": cal.get_calibration,
        "from_config": lambda **kw: cal.from_config(auto, **kw),
        "for_dispatch": lambda **kw: cal.for_dispatch(auto, **kw),
        "conv_rank_overhead": lambda **kw: conv_rank_overhead(**kw),
    }
    for name, fn in calls.items():
        with pytest.raises(RuntimeError, match="CUDA"):
            fn()
        got = fn(device="cpu")
        assert got is not None, name
        if hasattr(got, "platform"):
            assert got.platform == "cpu" and got.measured, name
    # prepare_weights measures on the device of the parameters it is given
    model = make_cnn()
    params = model.init_factorized(0, device="cpu")
    batch = {"x": torch.zeros((4, 8, 8, 3)), "labels": torch.zeros(
        4, dtype=torch.long)}
    w = model.prepare_weights(params, 3, batch, "auto")
    assert set(w) == set(model.specs)


def test_zoo_entry_points_raise_without_cuda_unless_asked_for_cpu(
        monkeypatch):
    from repro_torch import configs
    from repro_torch.core.estimator import tree_leaves
    from repro_torch.launch import serve
    from repro_torch.models import model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_smoke("zamba2-2.7b")
    for fn in (lambda **kw: model.init(0, cfg, **kw),
               lambda **kw: model.init_cache(cfg, 2, 8, **kw)):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn()
        leaves = tree_leaves(fn(device="cpu"))
        assert leaves and all(t.device.type == "cpu" for t in leaves)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--smoke", "--requests", "1"])
    serve.main(["--smoke", "--requests", "1", "--device", "cpu"])


@pytest.mark.parametrize("name", ["flash_attention", "decode_attention",
                                  "rmsnorm"])
def test_build_key_covers_every_header(tmp_path, monkeypatch, name):
    """A kernel library is keyed on its source and every ``*.cuh`` beside
    it: adding or editing any header (a new MMA helper, say) gives every
    library a new key, so none is served stale; the same files give the
    same key."""
    import shutil

    from repro_torch import kernels as rt

    csrc = tmp_path / "csrc"
    shutil.copytree(rt.CSRC, csrc)
    orig = rt._lib_path(name)
    monkeypatch.setattr(rt, "CSRC", csrc)
    key = rt._lib_path(name)
    assert key == orig == rt._lib_path(name)
    (csrc / "zz_new.cuh").write_text("#pragma once\n")
    added = rt._lib_path(name)
    assert added != key
    with open(csrc / "mma.cuh", "a") as f:
        f.write("// an edit\n")
    assert rt._lib_path(name) not in (key, added)
