"""The port's training round against the JAX package's, end to end.

Both engines start from the reference's own initial weights (carried
across with ``from_jax_params``) and draw every minibatch from the same
numpy streams, so the control decisions must be identical: widths, τs,
block ids, traffic, makespan and average wait are compared for equality.
Float results carry tolerances: accuracy within 2 test samples, client
estimates (L, σ², G²) and losses within 1e-3 relative.  The pinned
``auto`` path is held end to end through ``local_train`` here and
through the CNN's logits and gradients in ``test_torch_models.py``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core.calibration import RankPathCalibration as JCal
from repro.fl import FLConfig as JConfig
from repro.fl import build_image_setup as j_setup
from repro.fl import build_runner as j_build
from repro.fl import client as jclient
from repro.fl.heterogeneity import HeterogeneityModel as JHet
from repro_torch.convert import from_jax_params, to_numpy
from repro_torch.core.calibration import RankPathCalibration as TCal
from repro_torch.data.streaming import ClientDataLoader
from repro_torch.fl import FLConfig as TConfig
from repro_torch.fl import build_image_setup as t_setup
from repro_torch.fl import build_runner as t_build
from repro_torch.fl import client as tclient
from repro_torch.fl import summarize
from repro_torch.fl.heterogeneity import HeterogeneityModel as THet

PIN = dict(conv_rank_overhead=1.0, fused_compose_gain=0.5)
EST_TOL = 1e-3


def _record(runner):
    """Wrap a runner's assignment and trainer to log each round's
    assignments and client results (same wiring on both engines)."""
    log = []
    assign, train_all = runner.assignment.assign, runner.trainer.train_all

    def ids(a, key):
        return None if a.get(key) is None else [int(i) for i in a[key]]

    def assign_rec(state, clients):
        state, assigns = assign(state, clients)
        log.append({"assign": {
            int(n): (a["width"], a["tau"], ids(a, "hidden_ids"),
                     ids(a, "anchored_ids")) for n, a in assigns.items()}})
        return state, assigns

    def train_rec(state, assigns):
        results = train_all(state, assigns)
        log[-1]["est"] = {int(n): dict(r.estimates, loss_before=r.loss_before,
                                       loss_after=r.loss_after)
                          for n, r in results.items()}
        return results

    runner.assignment.assign = assign_rec
    runner.trainer.train_all = train_rec
    return log


def _rel(a, b):
    return abs(a - b) / max(abs(a), 1e-12)


# the reference's own materialize and rank_space paths differ by 1.0e-3
# relative in one client's (sigma^2, G^2) in round 3 of this setup (the
# port agrees with its rank_space value to 1e-6), so the materialize run
# holds estimates to 2e-3
@pytest.mark.parametrize("scheme,impl,est_tol", [
    ("heroes", "materialize", 2e-3),
    ("heroes", "rank_space", EST_TOL),
    ("fedavg", "materialize", EST_TOL),
])
def test_run_scheme_matches_reference(scheme, impl, est_tol):
    kw = dict(num_clients=8, clients_per_round=3, agg_backend="host",
              forward_impl=impl, eval_every=1, **PIN)
    jm, jx, jy, jt = j_setup(num_clients=8)
    jr = j_build(scheme, jm, jx, jy, jt, cfg=JConfig(**kw))
    jlog = _record(jr)
    jh = jr.run(3)

    tm, tx, ty, tt = t_setup(num_clients=8, device="cpu")
    tr = t_build(scheme, tm, tx, ty, tt, cfg=TConfig(**kw), device="cpu")
    init = (jm.init_factorized if scheme == "heroes" else jm.init_dense)(
        jax.random.PRNGKey(0))
    tr.state = dataclasses.replace(
        tr.state, params=from_jax_params(jax.device_get(init), "cpu"))
    tlog = _record(tr)
    th = tr.run(3)

    n_test = int(tt["labels"].shape[0])
    assert len(th) == len(jh) == 3
    for a, b in zip(jh, th):
        assert (a.round, a.wall_time, a.traffic_bytes, a.makespan,
                a.avg_wait, a.mean_tau, a.up_bytes, a.down_bytes) == \
            (b.round, b.wall_time, b.traffic_bytes, b.makespan,
             b.avg_wait, b.mean_tau, b.up_bytes, b.down_bytes)
        assert abs(a.accuracy - b.accuracy) <= 2.0 / n_test
    for ra, rb in zip(jlog, tlog):
        assert ra["assign"] == rb["assign"]
        assert ra["est"].keys() == rb["est"].keys()
        for n, ea in ra["est"].items():
            for k, va in ea.items():
                assert _rel(va, rb["est"][n][k]) <= est_tol, (n, k)
    assert summarize(th)["traffic_gb"] == summarize(jh)["traffic_gb"]


@pytest.mark.parametrize("impl", ["rank_space", "auto"])
def test_local_train_matches_reference(impl):
    """τ SGD steps on the factors from the same numpy generator: params,
    losses and estimates agree."""
    jm, jx, jy, _ = j_setup(num_clients=8)
    tm, tx, ty, _ = t_setup(num_clients=8, device="cpu")
    params = jax.device_get(jm.init_factorized(jax.random.PRNGKey(1)))
    ids9, ids3 = np.arange(9), np.arange(3)
    jred = jm.reduce(params, 3, ids9, ids3)
    tred = tm.reduce(from_jax_params(params, "cpu"), 3, ids9, ids3)
    jcal, tcal = (JCal(**PIN), TCal(**PIN)) if impl == "auto" else (None,
                                                                    None)
    jres = jclient.local_train(jm, jred, 3, 5, jx[2], jy[2], 0.05,
                               np.random.default_rng(7), 16,
                               forward_impl=impl, calibration=jcal)
    tres = tclient.local_train(tm, tred, 3, 5, tx[2], ty[2], 0.05,
                               np.random.default_rng(7), 16,
                               forward_impl=impl, calibration=tcal)
    assert _rel(jres.loss_before, tres.loss_before) <= EST_TOL
    assert _rel(jres.loss_after, tres.loss_after) <= EST_TOL
    for k, v in jres.estimates.items():
        assert _rel(v, tres.estimates[k]) <= EST_TOL, k
    got = to_numpy(tres.params)
    want = jax.device_get(jres.params)
    for name in want:
        for key in ("basis", "coeff"):
            np.testing.assert_allclose(got[name][key], want[name][key],
                                       atol=1e-5, rtol=1e-4)


def test_setup_data_and_clock_match_reference():
    """Same synthetic arrays, Γ partition, test batch and time model."""
    jm, jx, jy, jt = j_setup(num_clients=10)
    tm, tx, ty, tt = t_setup(num_clients=10, device="cpu")
    assert len(jx) == len(tx) == 10
    for a, b in zip(jx, tx):
        np.testing.assert_array_equal(a.indices, b.indices)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(np.asarray(jt["x"]), tt["x"].numpy())
    np.testing.assert_array_equal(np.asarray(jt["labels"]),
                                  tt["labels"].numpy())
    jh, th = JHet(10, seed=0), THet(10, seed=0)
    for r in (1, 2):
        jh.round = th.round = r
        for n in range(10):
            assert jh.iter_time(n, 1e9) == th.iter_time(n, 1e9)
            assert jh.upload_time(n, 4e4) == th.upload_time(n, 4e4)
    loader = ClientDataLoader(tx, ty, "cpu")
    steps, est = loader.draw_round(3, seed=0, rnd=2, tau=4, batch_size=16,
                                   estimate=True)
    rng = np.random.default_rng((0, 2, 3))
    for batch in steps + est:
        idx = rng.integers(0, len(ty[3]), 16)
        np.testing.assert_array_equal(batch["x"].numpy(), tx[3][idx])
        np.testing.assert_array_equal(batch["labels"].numpy(), ty[3][idx])


def test_config_keeps_reference_defaults():
    assert dataclasses.asdict(JConfig()) == dataclasses.asdict(TConfig())


@pytest.mark.parametrize("knob,match", [
    (dict(trainer="cohort"), "trainer"),
    (dict(round_mode="semi_async"), "round_mode"),
    (dict(agg_backend="collective"), "collective"),
    (dict(checkpoint_every=1, checkpoint_dir="ckpt"), "checkpoint"),
    (dict(telemetry="memory"), "telemetry"),
    (dict(participation="availability"), "participation"),
    (dict(edge_groups=2), "edge_groups"),
    (dict(sample_weighted=True), "sample_weighted"),
])
def test_unported_knobs_raise(knob, match):
    tm, tx, ty, tt = t_setup(num_clients=4, device="cpu")
    cfg = TConfig(**{"num_clients": 4, "agg_backend": "host", **knob})
    with pytest.raises(NotImplementedError, match=match):
        t_build("heroes", tm, tx, ty, tt, cfg=cfg, device="cpu")


@pytest.mark.parametrize("scheme", ["adp", "heterofl", "flanc", "fedprox"])
def test_unported_schemes_raise(scheme):
    tm, tx, ty, tt = t_setup(num_clients=4, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_build(scheme, tm, tx, ty, tt,
                cfg=TConfig(num_clients=4, agg_backend="host"), device="cpu")


def test_streamed_eval_and_rank_aware_clock_match_reference():
    """``eval_batch_size`` slices give the full-batch accuracy, and the
    ``rank_aware`` clock charges what the reference charges."""
    kw = dict(num_clients=4, clients_per_round=2, agg_backend="host",
              clock_model="rank_aware", forward_impl="auto", **PIN)
    jm, jx, jy, jt = j_setup(num_clients=4)
    jr = j_build("heroes", jm, jx, jy, jt, cfg=JConfig(**kw))
    tm, tx, ty, tt = t_setup(num_clients=4, device="cpu")
    runners = [t_build("heroes", tm, tx, ty, tt, device="cpu",
                       cfg=TConfig(eval_batch_size=bs, **kw))
               for bs in (0, 64)]
    for p in (1, 2, 3):
        assert jr.flops_per_iter(p) == runners[0].flops_per_iter(p)
    for r in runners:
        r.state = dataclasses.replace(
            r.state, params=from_jax_params(jax.device_get(jr.params), "cpu"))
    full, sliced = (r.aggregator.evaluate(r.state) for r in runners)
    assert full == pytest.approx(sliced, abs=1e-6)  # an f32 mean vs count/n
    assert abs(full - jr.eval_accuracy()) <= 2.0 / int(tt["labels"].shape[0])


def test_results_stay_on_the_run_device():
    tm, tx, ty, tt = t_setup(num_clients=4, device="cpu")
    r = t_build("heroes", tm, tx, ty, tt, device="cpu",
                cfg=TConfig(num_clients=4, clients_per_round=2,
                            agg_backend="host", forward_impl="rank_space",
                            tau_fixed=2))
    r.run(1)
    assert r.device == torch.device("cpu")
    assert all(v.device.type == "cpu"
               for d in r.params.values() for v in d.values())
