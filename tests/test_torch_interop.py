"""Runs resumed across packages through the shared msgpack checkpoints.

Each package saves a run, the other restores it and continues, and the
continued run is held against the first package's uninterrupted run:

* heroes, synchronous rounds, and heroes semi-async with results in
  flight at the checkpoint: the reference's runner saves at round 2 and
  the port's runner continues to round 4, and the other way round.  The
  restored state is held bit for bit (the restoring package writes it
  again and the file is the same, byte for byte); the schedule, the
  assignments, participation, ``wall_time`` and ``traffic_bytes``
  exactly; accuracy within 2 test samples and the weights at the engine
  tests' parity tolerance (``tests/test_torch_engine.py``).
* ``launch/train.py --ckpt-dir`` on gemma-2b's smoke config (f32
  compute): a step-2 checkpoint built with the reference's
  ``make_train_step``, ``adamw`` and ``save_checkpoint`` resumes in the
  port's launcher to step 4; its loss and its gradient norm at steps 2
  and 3 hold to the reference's uninterrupted run (the loss) and to the
  f64 norm of the reference's gradient, at ``tests/test_torch_launchers.py``'s
  tolerance, since the resumed launcher draws the same batches 2 and 3.
"""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import optim as joptim
from repro.checkpoint import msgpack_ckpt as jckpt
from repro.data import SyntheticTextTask as JTextTask
from repro.data import lm_batches as j_lm_batches
from repro.fl import FLConfig as JConfig
from repro.fl import build_image_setup as j_setup
from repro.fl import build_runner as j_build
from repro.fl.engine import state as j_state
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import model as jmodel
from repro_torch.checkpoint import msgpack_ckpt as tckpt
from repro_torch.convert import from_jax_params
from repro_torch.fl import FLConfig as TConfig
from repro_torch.fl import build_image_setup as t_setup
from repro_torch.fl import build_runner as t_build
from repro_torch.fl.engine import state as t_state
from repro_torch.launch import train as ttrain
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

ROUNDS, STOP = 4, 2
MODES = {"sync": {}, "semi_async": dict(round_mode="semi_async", async_k=1)}
BASE = dict(num_clients=8, clients_per_round=3, eval_every=1,
            agg_backend="host", forward_impl="rank_space", tau_fixed=2,
            tau_max=6, checkpoint_every=1, checkpoint_keep=10)
# tests/test_torch_engine.py's parity tolerance for weights
W_ATOL, W_RTOL = 1e-5, 1e-4
SCHEDULE = ("round", "wall_time", "traffic_bytes", "makespan", "avg_wait",
            "mean_tau", "stale", "up_bytes", "down_bytes")


def _record(runner, log):
    """Log each call's assignments with the round it was made in (same
    wiring on both engines)."""
    assign = runner.assignment.assign

    def ids(a, key):
        return None if a.get(key) is None else [int(i) for i in a[key]]

    def rec(state, clients):
        state, assigns = assign(state, clients)
        log.append((int(state.round), {
            int(n): (int(a["width"]), int(a["tau"]), ids(a, "hidden_ids"),
                     ids(a, "anchored_ids")) for n, a in assigns.items()}))
        return state, assigns

    runner.assignment.assign = rec
    return log


def _j_runner(setup, mode, ckpt):
    return j_build("heroes", *setup, cfg=JConfig(
        **BASE, **MODES[mode], checkpoint_dir=str(ckpt)))


def _t_runner(setup, mode, ckpt, init=None):
    r = t_build("heroes", *setup, cfg=TConfig(
        **BASE, **MODES[mode], checkpoint_dir=str(ckpt)), device="cpu")
    if init is not None:
        r.state = dataclasses.replace(r.state, params=from_jax_params(
            init, "cpu"))
    return r


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each package's uninterrupted 4-round run of each mode, from the
    reference's initial weights, with a checkpoint every round."""
    base = tmp_path_factory.mktemp("interop")
    jsetup = j_setup(num_clients=8)
    tsetup = t_setup(num_clients=8, device="cpu")
    init = jax.device_get(jsetup[0].init_factorized(jax.random.PRNGKey(0)))
    out = {"jsetup": jsetup, "tsetup": tsetup, "base": base,
           "n_test": int(tsetup[3]["labels"].shape[0])}
    for mode in MODES:
        jr = _j_runner(jsetup, mode, base / mode / "j")
        tr = _t_runner(tsetup, mode, base / mode / "t", init)
        jlog, tlog = _record(jr, []), _record(tr, [])
        jr.run(ROUNDS)
        tr.run(ROUNDS)
        if mode == "semi_async":  # results in flight at the checkpoint
            for d in ("j", "t"):
                meta = tckpt.load_checkpoint(
                    base / mode / d / f"step_{STOP:08d}")["meta"]
                assert b'"in_flight": [{' in meta.tobytes()
        out[mode] = {"j": (jr, jlog), "t": (tr, tlog)}
    return out


def _host(params):
    """Either package's params as numpy arrays."""
    return {name: {k: v.detach().numpy() if isinstance(v, torch.Tensor)
                   else np.asarray(v) for k, v in layer.items()}
            for name, layer in params.items()}


def _same_file(a, b):
    assert (a / "state.msgpack").read_bytes() == \
        (b / "state.msgpack").read_bytes()


def _held(runs, cont, cont_log, want, want_log):
    """A continued run against the other package's uninterrupted run."""
    got_h, want_h = cont.history, want.history
    assert len(got_h) == len(want_h) == ROUNDS
    for a, b in zip(got_h, want_h):
        assert tuple(getattr(a, k) for k in SCHEDULE) == \
            tuple(getattr(b, k) for k in SCHEDULE)
        assert abs(a.accuracy - b.accuracy) <= 2.0 / runs["n_test"]
    assert cont_log and cont_log == [e for e in want_log if e[0] >= STOP]
    assert cont.state.participation == want.state.participation
    assert cont.state.rng.bit_generator.state == \
        want.state.rng.bit_generator.state
    got_p, want_p = _host(cont.params), _host(want.params)
    for name in want_p:
        for key in want_p[name]:
            np.testing.assert_allclose(np.asarray(got_p[name][key]),
                                       np.asarray(want_p[name][key]),
                                       atol=W_ATOL, rtol=W_RTOL,
                                       err_msg=f"{name}/{key}")


@pytest.mark.parametrize("mode", list(MODES))
def test_reference_checkpoint_resumes_in_port(runs, mode, tmp_path):
    src = runs["base"] / mode / "j" / f"step_{STOP:08d}"
    shutil.copytree(src, tmp_path / "ck" / src.name)
    tr = _t_runner(runs["tsetup"], mode, tmp_path / "ck")
    assert tr.restore_latest() and tr.round == STOP
    if mode == "semi_async":
        assert tr.state.in_flight
    # the restored state, bit for bit: written again, the same file
    again = tckpt.save_checkpoint(tmp_path / "again", STOP,
                                  t_state.state_to_payload(tr.state))
    _same_file(again, src)
    log = _record(tr, [])
    tr.run(ROUNDS - STOP)
    jr, jlog = runs[mode]["j"]
    _held(runs, tr, log, jr, jlog)


@pytest.mark.parametrize("mode", list(MODES))
def test_port_checkpoint_resumes_in_reference(runs, mode, tmp_path):
    src = runs["base"] / mode / "t" / f"step_{STOP:08d}"
    shutil.copytree(src, tmp_path / "ck" / src.name)
    jr = _j_runner(runs["jsetup"], mode, tmp_path / "ck")
    assert jr.restore_latest() and jr.round == STOP
    if mode == "semi_async":
        assert jr.state.in_flight
    again = jckpt.save_checkpoint(tmp_path / "again", STOP,
                                  j_state.state_to_payload(jr.state))
    _same_file(again, src)
    log = _record(jr, [])
    jr.run(ROUNDS - STOP)
    tr, tlog = runs[mode]["t"]
    _held(runs, jr, log, tr, tlog)


LR, STEPS, BATCH, SEQ = 3e-3, 4, 2, 16


def test_train_launcher_resumes_reference_checkpoint(tmp_path, monkeypatch):
    """gemma-2b's smoke config in f32: the reference's step-2 checkpoint,
    continued by the port's launcher, against the reference's 4 steps."""
    jcfg = jconfigs.get_smoke("gemma-2b").replace(compute_dtype="float32")
    opt = joptim.make_optimizer("adamw",
                                joptim.cosine_schedule(LR, STEPS, 5))
    params = jmodel.init(jax.random.PRNGKey(0), jcfg)
    opt_state = opt.init(params)
    step_fn = jax.jit(jmake_train_step(jcfg, opt))
    task = JTextTask(vocab=min(jcfg.vocab, 512), seq_len=SEQ)
    rng = np.random.default_rng(0)
    want = []
    for i in range(STEPS):
        toks, labels = j_lm_batches(task.train, BATCH, rng)
        batch = {"tokens": jnp.asarray(toks % jcfg.vocab),
                 "labels": jnp.asarray(labels % jcfg.vocab)}
        norm = None
        if i >= STOP:  # the f64 norm of the gradient the port resumes at
            grads = jax.grad(lambda p: jmodel.loss_fn(p, jcfg, batch)[0])(
                params)
            norm = np.sqrt(sum((np.asarray(g, np.float64) ** 2).sum()
                               for g in jax.tree_util.tree_leaves(grads)))
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        want.append((float(metrics["loss"]), norm))
        if i + 1 == STOP:
            jckpt.save_checkpoint(tmp_path, STOP,
                                  {"params": params, "opt": opt_state})
    assert jckpt.load_checkpoint(tmp_path / f"step_{STOP:08d}")[
        "opt"]["step"].dtype == np.int32

    got = []
    real_step = ttrain.make_train_step

    def recording(cfg, optimizer):
        step = real_step(cfg, optimizer)

        def run(p, s, b):
            p, s, m = step(p, s, b)
            got.append((float(m["loss"]), float(m["grad_norm"])))
            return p, s, m
        return run

    real_smoke = ttrain.configs.get_smoke
    monkeypatch.setattr(ttrain, "make_train_step", recording)
    monkeypatch.setattr(ttrain.configs, "get_smoke", lambda a: real_smoke(
        a).replace(compute_dtype="float32"))
    ttrain.main(["--arch", "gemma-2b", "--smoke", "--steps", str(STEPS),
                 "--batch", str(BATCH), "--seq", str(SEQ), "--device", "cpu",
                 "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"])
    assert len(got) == STEPS - STOP
    for (loss, norm), (jloss, jnorm) in zip(got, want[STOP:]):
        np.testing.assert_allclose(loss, jloss, rtol=1e-5)
        np.testing.assert_allclose(norm, jnorm, rtol=1e-5)
    # the port's step-4 checkpoint reads in the reference's reader, laid
    # out as the reference's state is
    back = jckpt.load_checkpoint(tmp_path / f"step_{STEPS:08d}")
    assert int(back["opt"]["step"]) == STEPS
    assert back["opt"]["step"].dtype == np.int32
    want_flat = jckpt._flatten(jax.device_get({"params": params,
                                               "opt": opt_state}))
    got_flat = jckpt._flatten(back)
    assert list(got_flat) == list(want_flat)
    for k, v in want_flat.items():
        assert (got_flat[k].dtype, got_flat[k].shape) == (v.dtype, v.shape)
