"""Checkpoint/resume of the port's runs: kill a run at round 3, restore
the newest round-boundary checkpoint (round 2) in a fresh runner, and
continue — the history and the final weights must equal an uninterrupted
port run's bit for bit, for every scheme in both round modes and for
heroes under the cohort trainer.  The rng stream, Heroes scheduler
tallies, participation bookkeeping and (semi-async) in-flight dispatch
records all travel in the checkpointed ServerState.  Compared against
live runs of the port (the JAX package's golden fixtures are not used).
"""

import dataclasses

import jax
import pytest
import torch

from repro.fl import FLConfig as JConfig
from repro.fl import build_image_setup as j_setup
from repro.fl import build_runner as j_build
from repro_torch.convert import from_jax_params
from repro_torch.core.estimator import tree_leaves
from repro_torch.fl import FLConfig, build_image_setup, build_runner
from repro_torch.fl import build_setup
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

SCHEMES = ("fedavg", "adp", "heterofl", "flanc", "heroes")
ROUNDS = 5
KILL_AT = 3      # the interrupted run dies here...
CKPT_EVERY = 2   # ...so the newest checkpoint is at round 2


@pytest.fixture(scope="module")
def image_setup():
    return build_image_setup(num_clients=10, seed=0, device="cpu")


def _cfg(mode, ckpt_dir, **kw):
    """The JAX package's ``tests/test_resume.py`` configuration."""
    base = dict(num_clients=10, clients_per_round=4, eval_every=2,
                tau_fixed=4, tau_max=15, estimate=True, round_mode=mode,
                checkpoint_every=CKPT_EVERY, checkpoint_dir=str(ckpt_dir),
                checkpoint_keep=2, forward_impl="materialize")
    if mode == "semi_async":
        base.update(async_k=2, eval_every=4)
    base.update(kw)
    return FLConfig(**base)


def _history(runner):
    return [dataclasses.asdict(h) for h in runner.history]


def _same_params(a, b):
    return all(torch.equal(x, y)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _check_resume(scheme, mode, setup, tmp_path, **kw):
    with build_runner(scheme, *setup, cfg=_cfg(mode, tmp_path / "ref", **kw),
                      device="cpu") as ref:
        ref.run(ROUNDS)

    ckpt = tmp_path / "run"
    with build_runner(scheme, *setup, cfg=_cfg(mode, ckpt, **kw),
                      device="cpu") as interrupted:
        interrupted.run(KILL_AT)
        partial = _history(interrupted)
    del interrupted  # the process is gone; only the checkpoint survives

    with build_runner(scheme, *setup, cfg=_cfg(mode, ckpt, **kw),
                      device="cpu") as resumed:
        assert resumed.restore_latest(), "no checkpoint to resume from"
        assert resumed.round == KILL_AT - KILL_AT % CKPT_EVERY == 2
        assert _history(resumed) == partial[:resumed.round]
        if mode == "semi_async":
            # stragglers were in flight at the checkpoint
            assert resumed.state.in_flight
        resumed.run(ROUNDS - resumed.round)
    assert _history(resumed) == _history(ref)
    assert _same_params(resumed.params, ref.params)
    assert resumed.state.participation == ref.state.participation
    assert (resumed.state.rng.bit_generator.state
            == ref.state.rng.bit_generator.state)


@pytest.mark.parametrize("mode", ["sync", "semi_async"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_resume_bitwise_identical(scheme, mode, image_setup, tmp_path):
    _check_resume(scheme, mode, image_setup, tmp_path)


@pytest.mark.parametrize("mode", ["sync", "semi_async"])
def test_resume_bitwise_identical_cohort(mode, image_setup, tmp_path):
    _check_resume("heroes", mode, image_setup, tmp_path, trainer="cohort")


def test_restore_latest_false_on_empty_dir(image_setup, tmp_path):
    with build_runner("fedavg", *image_setup,
                      cfg=_cfg("sync", tmp_path / "empty"),
                      device="cpu") as runner:
        assert runner.restore_latest() is False


def test_checkpoint_dir_unset_raises(image_setup):
    cfg = FLConfig(num_clients=10, clients_per_round=4)
    with build_runner("fedavg", *image_setup, cfg=cfg,
                      device="cpu") as runner:
        with pytest.raises(ValueError, match="checkpoint_dir"):
            runner.save_checkpoint()
        with pytest.raises(ValueError, match="checkpoint_dir"):
            runner.restore_latest()


def test_checkpoint_every_keeps_newest(image_setup, tmp_path):
    with build_runner("heroes", *image_setup,
                      cfg=_cfg("sync", tmp_path, checkpoint_every=1),
                      device="cpu") as runner:
        runner.run(4)
    assert sorted(p.name for p in tmp_path.glob("step_*")) == [
        "step_00000003", "step_00000004"]


def test_participation_bookkeeping_survives_resume(tmp_path):
    """Virtual-population runs: the registry shares the ServerState's
    participation dict by identity, so last_participation survives."""
    m, px, py, tb = build_setup("synthetic_image", seed=0, population=500,
                                partition_kw={"samples_per_client": 16},
                                device="cpu")
    cfg = FLConfig(num_clients=500, clients_per_round=4, tau_fixed=2,
                   eval_every=10, checkpoint_every=1,
                   checkpoint_dir=str(tmp_path / "pop"))
    with build_runner("fedavg", m, px, py, tb, cfg=cfg, device="cpu") as r1:
        r1.run(2)
        seen = dict(r1.state.participation)
        assert seen and r1.population.participants() == len(seen)

    with build_runner("fedavg", m, px, py, tb, cfg=cfg, device="cpu") as r2:
        assert r2.restore_latest()
        assert r2.state.participation == seen
        assert r2.population._last_round is r2.state.participation
        for n, rnd in seen.items():
            assert r2.population.last_participation(n) == rnd


@pytest.mark.parametrize("budget_rounds", [1, 3])
def test_run_until_budget_matches_reference(budget_rounds):
    """Alg. 1's outer loop stops where the reference's does: the virtual
    wall after ``budget_rounds`` rounds of an unbounded run is the
    budget, so both engines run exactly that many rounds, on the same
    schedule."""
    kw = dict(num_clients=8, clients_per_round=3, agg_backend="host",
              forward_impl="materialize", eval_every=1)
    jm, jx, jy, jt = j_setup(num_clients=8)
    init = jax.device_get(jm.init_factorized(jax.random.PRNGKey(0)))
    probe = j_build("heroes", jm, jx, jy, jt, cfg=JConfig(**kw))
    budget = probe.run(budget_rounds)[-1].wall_time
    jr = j_build("heroes", jm, jx, jy, jt, cfg=JConfig(**kw))
    jh = jr.run_until_budget(time_budget=budget)

    tm, tx, ty, tt = build_image_setup(num_clients=8, device="cpu")
    with build_runner("heroes", tm, tx, ty, tt, cfg=FLConfig(**kw),
                      device="cpu") as tr:
        tr.state = dataclasses.replace(tr.state,
                                       params=from_jax_params(init, "cpu"))
        th = tr.run_until_budget(time_budget=budget)
        with pytest.raises(ValueError, match="budget"):
            tr.run_until_budget()
    assert len(th) == len(jh) == budget_rounds
    for a, b in zip(jh, th):
        assert (a.round, a.wall_time, a.traffic_bytes, a.makespan,
                a.mean_tau) == (b.round, b.wall_time, b.traffic_bytes,
                                b.makespan, b.mean_tau)
    # a traffic budget stops at the round that reaches it
    with build_runner("heroes", tm, tx, ty, tt, cfg=FLConfig(**kw),
                      device="cpu") as tr2:
        th2 = tr2.run_until_budget(traffic_budget=th[0].traffic_bytes)
    assert len(th2) == 1
