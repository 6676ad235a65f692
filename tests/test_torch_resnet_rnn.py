"""The port's residual net and RNN against the JAX package's.

The reference's own ``init_factorized`` / ``init_dense`` weights are
carried across with ``repro_torch.convert.from_jax_params``.  Logits must
agree within 2e-5 of max(1, max|ref|) (f32; 2e-4 where a conv runs in
rank space: conv_rank's k*k*I-term sums, as ``test_torch_kernels.py``
holds them), and gradients of the cross-entropy loss within 2e-4 of each
leaf's max(1, max|ref|), under every impl: materialize, rank_space and
fused_compose (the ``"fused"`` marker ``prepare_weights`` sets, which the
RNN's ``auto`` never picks at these shapes, so it is set here for its
``wx`` and ``out`` layers on ``(B, T, pI)`` inputs).

Then whole runs, as ``test_torch_engine.py`` holds the CNN's: heroes and
fedavg on ``cifar10`` (resnet) and ``shakespeare`` (rnn) from the
reference's initial weights, sequential and cohort trainer; and every
scheme for a round on both loaders, as ``tests/test_data.py`` runs them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.calibration import RankPathCalibration as JCal
from repro.fl import FLConfig as JConfig
from repro.fl import build_image_setup as j_image
from repro.fl import build_runner as j_build
from repro.fl import build_text_setup as j_text
from repro.fl import client as jclient
from repro.fl.models import make_resnet as j_make_resnet
from repro.fl.models import make_rnn as j_make_rnn
from repro_torch.convert import from_jax_params, to_numpy
from repro_torch.core.calibration import RankPathCalibration as TCal
from repro_torch.fl import FLConfig as TConfig
from repro_torch.fl import build_image_setup as t_image
from repro_torch.fl import build_runner as t_build
from repro_torch.fl import build_text_setup as t_text
from repro_torch.fl import client as tclient
from repro_torch.fl import run_scheme
from repro_torch.fl.engine import SCHEMES, CohortTrainer
from repro_torch.fl.models import make_resnet as t_make_resnet
from repro_torch.fl.models import make_rnn as t_make_rnn
from test_torch_engine import EST_TOL, _record, _rel
from test_torch_schemes import _check
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

TOL = 2e-5
CONV_TOL = 2e-4
GRAD_TOL = 2e-4
PIN = dict(conv_rank_overhead=1.0, fused_compose_gain=0.5)
IMPLS = ("materialize", "rank_space", "fused_compose")
MAKERS = {"resnet": (j_make_resnet, t_make_resnet),
          "rnn": (j_make_rnn, t_make_rnn)}
CIFAR = dict(train_size=240, test_size=60, hw=8)
SHAKE = dict(train_size=240, test_size=60, num_speakers=8)


def _batch(name, seed, B, hw=8, T=12):
    rng = np.random.default_rng(seed)
    if name == "resnet":
        x = rng.standard_normal((B, hw, hw, 3)).astype(np.float32)
        y = rng.integers(0, 10, B)
        return ({"x": jnp.asarray(x), "labels": jnp.asarray(y, jnp.int32)},
                {"x": torch.from_numpy(x), "labels": torch.from_numpy(y)})
    tok = rng.integers(0, 64, (B, T))
    y = rng.integers(0, 64, (B, T))
    return ({"tokens": jnp.asarray(tok, jnp.int32),
             "labels": jnp.asarray(y, jnp.int32)},
            {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(y)})


def _prepare(model, red, width, batch, impl, cal):
    """The weight dict ``forward`` takes under ``impl``; fused_compose
    marks every dense layer's factors as ``prepare_weights`` does for the
    layers ``auto`` fuses."""
    if impl != "fused_compose":
        return model.prepare_weights(red, width, batch, impl, cal)
    w = model.prepare_weights(red, width, batch, "rank_space", cal)
    return {n: ({**red[n], "fused": True}
                if model.layers[n].kind == "dense" and isinstance(v, dict)
                else v) for n, v in w.items()}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [np.asarray(tree)]


def _close(got, want, tol, what):
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} * {scale:.3g}"


def _check_model(name, width, impl, seed, B, hw=8):
    jmake, tmake = MAKERS[name]
    jm, tm = jmake(), tmake()
    params = jax.device_get(jm.init_factorized(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    hidden = np.sort(rng.choice(9, width * width, replace=False))
    anch = np.sort(rng.choice(3, width, replace=False))
    jred = jm.reduce(params, width, hidden, anch)
    tred = tm.reduce(from_jax_params(params, "cpu"), width, hidden, anch)
    jb, tb = _batch(name, seed, B, hw)
    jcal, tcal = JCal(**PIN), TCal(**PIN)
    jw = _prepare(jm, jred, width, jb, impl, jcal)
    tw = _prepare(tm, tred, width, tb, impl, tcal)
    kinds = {k: (isinstance(v, dict), isinstance(v, dict) and "fused" in v)
             for k, v in jw.items()}
    assert kinds == {k: (isinstance(v, dict),
                         isinstance(v, dict) and "fused" in v)
                     for k, v in tw.items()}
    if impl == "fused_compose":
        assert any(f for _, f in kinds.values())
    conv_rank = name == "resnet" and impl != "materialize" and any(
        d for k, (d, _) in kinds.items() if k != "fc")

    def jloss(p):
        logits = jm.forward(_prepare(jm, p, width, jb, impl, jcal), width, jb)
        return jclient._ce(logits, jb["labels"]), logits

    (_, want), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jred)
    with torch.no_grad():
        got = tm.forward(tw, width, tb).numpy()
    assert got.shape == want.shape
    _close(got, np.asarray(want), CONV_TOL if conv_rank else TOL, "logits")

    def tloss(p, batch):
        return tclient._ce(tm.forward(_prepare(tm, p, width, batch, impl,
                                               tcal), width, batch),
                           batch["labels"])

    tg = to_numpy(tclient._grad(tloss, tred, tb))
    for i, (a, b) in enumerate(zip(_leaves(tg),
                                   _leaves(jax.device_get(jg)))):
        _close(a, b, GRAD_TOL, f"grad leaf {i}")


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("width", [1, 3])
@pytest.mark.parametrize("name", ["resnet", "rnn"])
def test_logits_and_grads_match(name, width, impl):
    # batch 16 so the resnet's pinned auto fuses its head, as in training
    _check_model(name, width, impl, seed=width, B=16 if name == "resnet"
                 else 4)


@pytest.mark.parametrize("impl", ["materialize", "rank_space"])
def test_resnet_at_32x32_matches(impl):
    """The CIFAR-10 image size, at full width with a small batch."""
    _check_model("resnet", 3, impl, seed=7, B=2, hw=32)


def test_rnn_over_32_steps_matches():
    """The fallback's T = 32: the tanh chain over every step."""
    jm, tm = j_make_rnn(), t_make_rnn()
    params = jax.device_get(jm.init_dense(jax.random.PRNGKey(4)))
    jb, tb = _batch("rnn", 4, 3, T=32)
    want = np.asarray(jm.forward(params, 3, jb))
    with torch.no_grad():
        got = tm.forward(from_jax_params(params, "cpu"), 3, tb).numpy()
    _close(got, want, TOL, "rnn logits, T=32")


@pytest.mark.parametrize("name", ["resnet", "rnn"])
def test_dense_forward_and_grads_match(name):
    """FedAvg's dense parameterisation, and the leading slices the
    HeteroFL/ADP baselines take (the RNN's vocab-anchored embedding
    included), from the reference's ``init_dense``."""
    jmake, tmake = MAKERS[name]
    jm, tm = jmake(), tmake()
    full = jax.device_get(jm.init_dense(jax.random.PRNGKey(5)))
    jb, tb = _batch(name, 5, 4)
    for width in (2, 3):
        jp = jm.slice_dense(full, width)
        tp = tm.slice_dense(from_jax_params(full, "cpu"), width)
        for k in jp:
            assert tuple(tp[k].shape) == jp[k].shape

        def jloss(p):
            return jclient._ce(jm.forward(p, width, jb), jb["labels"])

        fns = tclient.ClientFns(tm, width, False, "materialize")
        want = np.asarray(jm.forward(jp, width, jb))
        with torch.no_grad():
            _close(tm.forward(tp, width, tb).numpy(), want, TOL, "logits")
        jg = jax.device_get(jax.grad(jloss)(jp))
        for a, b in zip(_leaves(to_numpy(fns.grad(tp, tb))), _leaves(jg)):
            _close(a, b, GRAD_TOL, f"{name} dense grad p={width}")
    for w in (1, 2, 3):
        assert jm.flops_per_sample(w) == tm.flops_per_sample(w)
        assert jm.factorized_bytes(w) == tm.factorized_bytes(w)
        assert jm.dense_bytes(w) == tm.dense_bytes(w)


@pytest.mark.parametrize("name", ["resnet", "rnn"])
def test_layer_impls_and_flops_equal(name):
    jmake, tmake = MAKERS[name]
    jm, tm = jmake(), tmake()
    for gain, overhead in ((0.5, 1.0), (2.0, 8.0), (0.5, 0.5)):
        jc, tc = JCal(overhead, gain), TCal(overhead, gain)
        for width in (1, 2, 3):
            for bs in (1, 16, 500):
                shape = (bs, 8, 8, 3) if name == "resnet" else (bs, 32)
                for impl in ("materialize", "rank_space", "auto"):
                    assert jm.layer_impls(width, bs, impl, shape, jc) == \
                        tm.layer_impls(width, bs, impl, shape, tc)
                    assert jm.apply_flops_per_sample(
                        width, bs, impl, shape, jc) == \
                        tm.apply_flops_per_sample(width, bs, impl, shape, tc)


def _setups(name):
    if name == "resnet":
        kw = dict(model_name="resnet", task="cifar10", num_clients=6,
                  task_kw=CIFAR)
        return j_image(**kw), t_image(device="cpu", **kw)
    kw = dict(task="shakespeare", num_clients=6, task_kw=SHAKE)
    return j_text(**kw), t_text(device="cpu", **kw)


# heroes and fedavg on both models with the sequential trainer, and heroes
# with the cohort trainer (the reference's cohort runs, as
# test_torch_cohort_runs.py holds the CNN's)
RUNS = [("resnet", "heroes", "rank_space", "sequential"),
        ("resnet", "fedavg", "materialize", "sequential"),
        ("resnet", "heroes", "materialize", "cohort"),
        ("rnn", "heroes", "rank_space", "sequential"),
        ("rnn", "fedavg", "materialize", "sequential"),
        ("rnn", "heroes", "rank_space", "cohort")]
# what the RNN's runs are held to beyond the schedule: its local SGD
# amplifies float rounding (the reference's own run from weights moved by
# 1e-7 relative is 3.6e-5 away after 2 steps and 6e-2 after 10, and its
# materialize and rank_space runs differ in L by 170 % after 2 rounds),
# so only what is evaluated at the shipped weights of round 1 is compared
AT_SHIPPED_WEIGHTS = ("loss_before", "sigma_sq", "grad_sq")


@pytest.mark.parametrize("name,scheme,impl,trainer", RUNS)
def test_run_scheme_matches_reference(name, scheme, impl, trainer):
    """2 rounds of 3 clients on 6 from the reference's initial weights:
    round logs and assignments equal, accuracy within 2 test samples;
    for the residual net, estimates within ``EST_TOL`` relative and final
    params within 1e-4; for the RNN, round 1's estimates at the shipped
    weights within ``EST_TOL`` (``AT_SHIPPED_WEIGHTS``)."""
    jsetup, tsetup = _setups(name)
    assert tsetup[0].name == name
    cfg = dict(num_clients=6, clients_per_round=3, agg_backend="host",
               eval_every=1, forward_impl=impl, trainer=trainer, **PIN)
    jr = j_build(scheme, *jsetup, cfg=JConfig(**cfg))
    init = jax.device_get(jr.params)
    jlog = _record(jr)
    jh = jr.run(2)
    tr = t_build(scheme, *tsetup, cfg=TConfig(**cfg), device="cpu")
    assert isinstance(tr.trainer, CohortTrainer) == (trainer == "cohort")
    tr.state = dataclasses.replace(tr.state,
                                   params=from_jax_params(init, "cpu"))
    tlog = _record(tr)
    th = tr.run(2)
    if name == "resnet":
        _check((init, jlog, jh, jax.device_get(jr.params)), (tr, tlog),
               tsetup, EST_TOL)
        return
    n_test = int(tsetup[3]["labels"].shape[0])
    assert len(th) == len(jh) == 2
    for a, b in zip(jh, th):
        assert (a.round, a.wall_time, a.traffic_bytes, a.makespan,
                a.avg_wait, a.mean_tau, a.stale, a.up_bytes,
                a.down_bytes) == \
            (b.round, b.wall_time, b.traffic_bytes, b.makespan,
             b.avg_wait, b.mean_tau, b.stale, b.up_bytes, b.down_bytes)
        assert abs(a.accuracy - b.accuracy) <= 2.0 / n_test
    assert [r["assign"] for r in jlog] == [r["assign"] for r in tlog]
    for n, ea in jlog[0]["est"].items():
        assert ea.keys() == tlog[0]["est"][n].keys()
        for k in AT_SHIPPED_WEIGHTS:
            if k in ea:
                assert _rel(ea[k], tlog[0]["est"][n][k]) <= EST_TOL, (n, k)


# tests/test_data.py's end-to-end config: the cohort trainer, 3 of 6
# clients, two local steps of 8
_E2E_CFG = TConfig(num_clients=6, clients_per_round=3, tau_fixed=2,
                   tau_max=6, eval_every=1, batch_size=8, lr=0.1,
                   trainer="cohort")


@pytest.fixture(scope="module")
def cifar_setup():
    return t_image(num_clients=6, seed=0, task="cifar10", max_width=2,
                   task_kw=CIFAR, device="cpu")


@pytest.fixture(scope="module")
def shakespeare_setup():
    return t_text(num_clients=6, seed=0, task="shakespeare", max_width=2,
                  task_kw=SHAKE, device="cpu")


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_all_schemes_on_cifar_loader(scheme, cifar_setup):
    hist = run_scheme(scheme, *cifar_setup, rounds=1, cfg=_E2E_CFG,
                      device="cpu")
    assert len(hist) == 1
    assert hist[0].accuracy is not None and np.isfinite(hist[0].accuracy)
    assert hist[0].traffic_bytes > 0


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_all_schemes_on_shakespeare_loader(scheme, shakespeare_setup):
    hist = run_scheme(scheme, *shakespeare_setup, rounds=1, cfg=_E2E_CFG,
                      device="cpu")
    assert len(hist) == 1
    assert hist[0].accuracy is not None and np.isfinite(hist[0].accuracy)


def test_default_text_setup_is_the_rnn_on_its_data():
    """``build_text_setup()`` with its defaults resolves the model as the
    reference does: the RNN, sized by the dataset's vocabulary."""
    jm = j_text()[0]
    tm = t_text(device="cpu")[0]
    assert tm.name == jm.name == "rnn"
    assert {k: dataclasses.astuple(s) for k, s in tm.specs.items()} == \
        {k: dataclasses.astuple(s) for k, s in jm.specs.items()}
    sm = t_text(task="shakespeare", device="cpu")[0]
    assert sm.name == "rnn" and sm.specs["out"].base_out == 64
