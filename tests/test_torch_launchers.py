"""The port's optimizers, step functions and zoo launchers against the
JAX package's.

* ``sgd``, ``sgdm`` (also Nesterov), ``sgdm_bf16`` and ``adamw`` (also
  with weight decay): the updates of 3 steps on the same gradients, each
  within 1e-6 of its leaf's largest entry of the reference's, the state
  too, under a constant rate and the cosine schedule (sgd reads the rate
  at the step before the update, adamw after);
* ``linear_warmup`` and ``cosine_schedule`` step by step;
* ``make_train_step`` on gemma's smoke config (f32 compute) against the
  reference's jitted step: loss, ``grad_norm`` and the parameters after
  3 steps;
* ``launch.train``: checkpoints written every ``--ckpt-every`` steps, a
  run resumed from its step-4 checkpoint equal bit for bit to the
  uninterrupted run, ``--composition``, and ``--mesh pod`` refused
  without a world of 256 ranks;
* ``launch.serve`` with no ``--arch`` serves gemma-2b.
"""

import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import optim as joptim
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import model as jmodel
from repro_torch import configs as tconfigs
from repro_torch import optim as toptim
from repro_torch.checkpoint.msgpack_ckpt import load_checkpoint
from repro_torch.convert import from_jax_params
from repro_torch.core.estimator import tree_leaves
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import make_train_step
from torch_threads import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
# f32 updates, each leaf relative to its own largest entry
UPD_TOL = 1e-6

SHAPES = {"a": {"w": (5, 7), "b": (7,)}, "c": (3, 4, 2)}


def _tree(rng, shapes=SHAPES, scale=1.0):
    if isinstance(shapes, dict):
        return {k: _tree(rng, v, scale) for k, v in shapes.items()}
    return (scale * rng.standard_normal(shapes)).astype(np.float32)


def _np_map(fn, t):
    return {k: _np_map(fn, v) for k, v in t.items()} if isinstance(
        t, dict) else fn(t)


def _at(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


def _check_tree(got, want, what):
    """Leaf by leaf, by path (jax orders dict keys, the port keeps the
    insertion order)."""
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        g = _at(got, path)
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(
            g.float().numpy(), w, rtol=0,
            atol=UPD_TOL * max(float(np.abs(w).max()), 1e-30), err_msg=what)


OPTIMIZERS = {
    "sgd": ("sgd", {}), "sgdm": ("sgdm", {}),
    "sgdm_nesterov": ("sgdm", {"nesterov": True}),
    "sgdm_bf16": ("sgdm_bf16", {}), "adamw": ("adamw", {}),
    "adamw_wd": ("adamw", {"weight_decay": 0.1}),
}


@pytest.mark.parametrize("schedule", ["constant", "cosine"])
@pytest.mark.parametrize("case", sorted(OPTIMIZERS))
def test_optimizer_updates_match_reference(case, schedule):
    name, kw = OPTIMIZERS[case]
    if schedule == "constant":
        jlr = tlr = 0.05
    else:
        jlr = joptim.cosine_schedule(0.05, 6, 2)
        tlr = toptim.cosine_schedule(0.05, 6, 2)
    jopt = joptim.make_optimizer(name, jlr, **kw)
    topt = toptim.make_optimizer(name, tlr, **kw)
    rng = np.random.default_rng(len(case))
    params = _tree(rng)
    jp = _np_map(jnp.asarray, params)
    tp = _np_map(torch.from_numpy, params)
    js, ts = jopt.init(jp), topt.init(tp)
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 0
    for step in range(3):
        grads = _tree(rng, scale=0.5 + step)
        jups, js = jopt.update(_np_map(jnp.asarray, grads), js, jp)
        tups, ts = topt.update(_np_map(torch.from_numpy, grads), ts, tp)
        _check_tree(tups, jups, f"{case} updates, step {step}")
        for key in ("mu", "nu"):
            if key in js:
                assert tree_leaves(ts[key])[0].dtype == getattr(
                    torch, str(jax.tree_util.tree_leaves(js[key])[0].dtype))
                _check_tree(ts[key], js[key], f"{case} {key}, step {step}")
        assert int(ts["step"]) == int(js["step"]) == step + 1
        jp = joptim.apply_updates(jp, jups)
        tp = toptim.apply_updates(tp, tups)
        _check_tree(tp, jp, f"{case} params, step {step}")


def test_schedules_match_reference():
    for jf, tf in ((joptim.linear_warmup(0.3, 4),
                    toptim.linear_warmup(0.3, 4)),
                   (joptim.cosine_schedule(3e-3, 20, 5),
                    toptim.cosine_schedule(3e-3, 20, 5)),
                   (joptim.cosine_schedule(1.0, 7, 0, 0.2),
                    toptim.cosine_schedule(1.0, 7, 0, 0.2))):
        for s in range(25):
            got = tf(torch.tensor(s, dtype=torch.int32))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), float(jf(jnp.int32(s))),
                                       rtol=1e-6)
    with pytest.raises(ValueError, match="unknown optimizer"):
        toptim.make_optimizer("lion", 0.1)


@pytest.mark.parametrize("name", ["adamw", "sgdm"])
def test_train_step_matches_reference(name):
    """3 steps of gemma's smoke config (f32 compute).  sgdm's parameters
    hold to 1e-6 of each leaf; adamw's m/sqrt(v) is about ±1 per entry
    whatever the gradient's size, so an entry whose gradient is rounding
    noise in either package may step the other way: adamw's parameters
    hold to twice the summed rates everywhere, and to 1e-5 in all but
    1e-3 of the entries."""
    jcfg = jconfigs.get_smoke("gemma-2b").replace(compute_dtype="float32")
    tcfg = tconfigs.get_smoke("gemma-2b").replace(compute_dtype="float32")
    jp = jmodel.init(jax.random.PRNGKey(0), jcfg)
    tp = from_jax_params(jax.device_get(jp), "cpu")
    jopt = joptim.make_optimizer(name, joptim.cosine_schedule(3e-3, 3, 5))
    sched = toptim.cosine_schedule(3e-3, 3, 5)
    topt = toptim.make_optimizer(name, sched)
    js, ts = jopt.init(jp), topt.init(tp)
    jstep = jax.jit(jmake_train_step(jcfg, jopt))
    tstep = make_train_step(tcfg, topt)
    rng = np.random.default_rng(0)
    for i in range(3):
        toks = rng.integers(0, jcfg.vocab, (2, 17)).astype(np.int32)
        if i == 0:  # the gradient's norm in f64, from the reference
            g = jax.grad(lambda p: jmodel.loss_fn(p, jcfg, {
                "tokens": jnp.asarray(toks[:, :-1]),
                "labels": jnp.asarray(toks[:, 1:])})[0])(jp)
            norm0 = np.sqrt(sum((np.asarray(x, np.float64) ** 2).sum()
                                for x in jax.tree_util.tree_leaves(g)))
        jp, js, jm = jstep(jp, js, {"tokens": jnp.asarray(toks[:, :-1]),
                                    "labels": jnp.asarray(toks[:, 1:])})
        tp, ts, tm = tstep(tp, ts, {"tokens": torch.from_numpy(toks[:, :-1]),
                                    "labels": torch.from_numpy(toks[:, 1:])})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        # XLA's jitted f32 vdot on the CPU reads up to 1.1e-3 below the
        # f64 norm here; the port's (and the reference's eager one) hold
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=2e-3)
        if i == 0:
            np.testing.assert_allclose(float(tm["grad_norm"]), norm0,
                                       rtol=1e-5)
    assert int(ts["step"]) == 3
    rates = sum(float(sched(torch.tensor(s))) for s in range(1, 4))
    for path, want in jax.tree_util.tree_leaves_with_path(jp):
        got = _at(tp, path)
        want = np.asarray(want)
        d = np.abs(got.detach().numpy() - want)
        what = jax.tree_util.keystr(path)
        if name == "sgdm":
            assert d.max() <= UPD_TOL * np.abs(want).max(), what
        else:
            assert d.max() <= 2 * rates and (d > 1e-5).mean() < 1e-3, what


# ---------------------------------------------------------------------------
# launchers
# ---------------------------------------------------------------------------

TRAIN = ["--arch", "gemma-2b", "--smoke", "--batch", "2", "--seq", "16",
         "--device", "cpu", "--ckpt-every", "2"]


def test_train_launcher_writes_checkpoints(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *TRAIN,
         "--steps", "4", "--ckpt-dir", str(tmp_path)],
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin"},
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    assert lines[0].startswith("gemma-2b: 1,246,464 params "
                               "(composition=off)"), lines[0]
    assert lines[1].startswith("step    0  loss ") and lines[-1] == "done."
    assert sorted(p.name for p in tmp_path.glob("step_*")) == [
        "step_00000002", "step_00000004"]
    state = load_checkpoint(tmp_path / "step_00000004")
    assert sorted(state) == ["opt", "params"]
    assert int(state["opt"]["step"]) == 4


def test_train_launcher_resumes_bit_for_bit(tmp_path, capsys):
    """A run stopped after its step-4 checkpoint and started again goes
    on from step 4 and ends where the uninterrupted run ends."""
    full, cut = tmp_path / "full", tmp_path / "cut"
    ttrain.main([*TRAIN, "--steps", "6", "--ckpt-dir", str(full)])
    cut.mkdir()
    for step in ("step_00000002", "step_00000004"):
        shutil.copytree(full / step, cut / step)
    capsys.readouterr()
    ttrain.main([*TRAIN, "--steps", "6", "--ckpt-dir", str(cut)])
    assert "resumed from step 4" in capsys.readouterr().out
    a = load_checkpoint(full / "step_00000006")
    b = load_checkpoint(cut / "step_00000006")
    leaves_a, leaves_b = tree_leaves(a), tree_leaves(b)
    assert len(leaves_a) == len(leaves_b) > 20
    for x, y in zip(leaves_a, leaves_b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_train_launcher_composition_and_mesh(capsys):
    ttrain.main(["--arch", "stablelm-3b", "--smoke", "--steps", "2",
                 "--batch", "2", "--seq", "16", "--composition",
                 "--device", "cpu"])
    out = capsys.readouterr().out
    assert "composition=on" in out and out.rstrip().endswith("done.")
    # the production mesh needs a world of 256 ranks (torchrun, or the
    # dry run's fake world: tests/test_torch_dryrun.py runs it there)
    with pytest.raises(RuntimeError, match="process group of 256 ranks"):
        ttrain.main(["--smoke", "--mesh", "pod", "--device", "cpu"])


def test_train_launcher_sgdm_bf16_resume_keeps_types(tmp_path):
    """The bf16 momentum comes back from the checkpoint as bf16."""
    argv = [*TRAIN, "--optimizer", "sgdm_bf16", "--ckpt-dir", str(tmp_path)]
    ttrain.main([*argv, "--steps", "2"])
    state = load_checkpoint(tmp_path / "step_00000002")
    assert tree_leaves(state["opt"]["mu"])[0].dtype == torch.bfloat16
    ttrain.main([*argv, "--steps", "4"])
    assert (tmp_path / "step_00000004").is_dir()


def test_serve_launcher_defaults_to_gemma(capsys, monkeypatch):
    seen = []
    real = tserve.configs.get_smoke
    monkeypatch.setattr(tserve.configs, "get_smoke",
                        lambda arch: (seen.append(arch), real(arch))[1])
    tserve.main(["--smoke", "--device", "cpu"])
    assert seen == ["gemma-2b"]
    out = capsys.readouterr().out
    assert out.startswith("served 8/8 requests, 128 tokens"), out
    tserve.main(["--smoke", "--device", "cpu", "--requests", "2",
                 "--batch", "2", "--max-new", "2", "--max-len", "32"])
    assert "served 2/2" in capsys.readouterr().out


def test_train_launcher_raises_without_cuda_unless_asked_for_cpu(
        monkeypatch, capsys):
    """As every entry point: the card by default, never a silent CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--smoke", "--steps", "1", "--batch", "1", "--seq", "8"]
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.main(argv)
    ttrain.main([*argv, "--device", "cpu"])
    assert "device=cpu" in capsys.readouterr().out
