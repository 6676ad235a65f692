"""The port's population layer against the JAX package's.

Virtual partitions give bit-equal indices, the registry the same profiles
and states, every participation scheduler the same draws (uniform's exact,
exclude and rejection paths, availability with and without a period,
resource_gated, trace), edge groups the same split; the edge-group merge
is bit-equal to the flat merge and its partials agree with the
reference's; and virtual-population runs take the reference's schedule.
"""

import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fl import FLConfig as JConfig
from repro.fl import build_runner as j_build
from repro.fl import build_setup as j_build_setup
from repro.fl.heterogeneity import HeterogeneityModel as JHet
from repro.fl.population import PopulationRegistry as JRegistry
from repro.fl.population import VirtualPartition as JPartition
from repro.fl.population import assign_edge_groups as j_groups
from repro.fl.population import build_scheduler as j_scheduler
from repro.fl.population import grouped_ordered_fold as j_fold
from repro.fl.population import TraceParticipation as JTrace
from repro.fl.population.hierarchy import HierarchicalMerger as JMerger
from repro.fl.types import ServerState as JState
from repro_torch.convert import from_jax_params, to_numpy
from repro_torch.core.estimator import tree_leaves
from repro_torch.data.streaming import VirtualShardList
from repro_torch.fl import FLConfig, build_runner, build_setup
from repro_torch.fl.heterogeneity import HeterogeneityModel as THet
from repro_torch.fl.population import (HierarchicalMerger,
                                       PopulationRegistry,
                                       TraceParticipation, VirtualPartition,
                                       assign_edge_groups, build_scheduler,
                                       grouped_ordered_fold)
from repro_torch.fl.population.schedulers import _EXACT_POOL_MAX
from repro_torch.fl.types import ServerState as TState
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

W = (0.05, 0.15, 0.30, 0.50)


def _labels(n=600, classes=10, seed=0):
    return np.random.default_rng(seed).integers(0, classes, n)


# ---------------------------------------------------------------------------
# partition and registry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["dirichlet", "class_skew", "iid", "natural"])
def test_virtual_partition_bit_equal(kind):
    labels = _labels()
    for pop in (500, 1_000_000):
        jp = JPartition(labels, pop, seed=1, kind=kind, samples_per_client=40)
        tp = VirtualPartition(labels, pop, seed=1, kind=kind,
                              samples_per_client=40)
        assert len(tp) == pop
        for n in (0, 7, 499, pop - 1):
            got = tp.indices(n)
            assert got.dtype == np.int64 and got.shape == (40,)
            np.testing.assert_array_equal(got, jp.indices(n))


def test_virtual_partition_rejects_bad_args():
    with pytest.raises(ValueError):
        VirtualPartition(_labels(), 10, kind="nope")
    with pytest.raises(ValueError):
        VirtualPartition(_labels(), 0)
    with pytest.raises(ValueError):
        VirtualPartition(_labels(), 10, samples_per_client=0)
    with pytest.raises(IndexError):
        VirtualPartition(_labels(), 10, samples_per_client=8).indices(10)


def test_registry_profiles_and_states_match_reference():
    labels = _labels()
    tp = VirtualPartition(labels, 1000, seed=3, samples_per_client=32)
    jp = JPartition(labels, 1000, seed=3, samples_per_client=32)
    treg = PopulationRegistry(1000, seed=3, tier_weights=W, partition=tp)
    jreg = JRegistry(1000, seed=3, tier_weights=W, partition=jp)
    for n in (0, 42, 999):
        assert dataclasses.asdict(treg.profile(n)) == \
            dataclasses.asdict(jreg.profile(n))
        a, b = treg.state(n, rnd=5), jreg.state(n, rnd=5)
        assert a.rng_key == b.rng_key and a.last_round == b.last_round
        np.testing.assert_array_equal(a.data_indices, b.data_indices)
        np.testing.assert_array_equal(a.rng().integers(0, 100, 8),
                                      b.rng().integers(0, 100, 8))
    treg.note_participation([42, 17], rnd=5)
    assert treg.last_participation(42) == 5
    assert treg.state(42, rnd=9).last_round == 5
    assert treg.participants() == 2
    store = {17: 9}
    assert treg.bind_participation(store) is store
    assert store == {42: 5, 17: 9}  # entries already in the store win
    with pytest.raises(IndexError):
        treg.profile(1000)
    with pytest.raises(ValueError):
        PopulationRegistry(20, partition=VirtualPartition(
            labels, 10, samples_per_client=8))
    # the virtual heterogeneity model resolves through the same function
    het = treg.heterogeneity(seed=3, tier_weights=W)
    jhet = jreg.heterogeneity(seed=3, tier_weights=W)
    assert het.virtual and len(het.clients) == 1000
    for n in (0, 999):
        assert het.clients[n] == treg.profile(n)
        assert het.iter_time(n, 1e9) == jhet.iter_time(n, 1e9)


def test_make_shards_virtual_path():
    from repro_torch.data.streaming import make_shards

    x = np.arange(400, dtype=np.float32).reshape(100, 4)
    y = np.arange(100)
    vp = VirtualPartition(y % 10, 10_000, seed=0, kind="iid",
                          samples_per_client=16)
    px, py = make_shards(x, y, vp)
    assert isinstance(px, VirtualShardList) and len(px) == 10_000
    np.testing.assert_array_equal(np.asarray(px[123]), x[vp.indices(123)])
    np.testing.assert_array_equal(np.asarray(py[123]), y[vp.indices(123)])
    with pytest.raises(IndexError):
        px[10_000]
    # streaming=False materializes per-client copies of the same rows
    cx, cy = make_shards(x, y, [np.arange(3), np.arange(5, 9)],
                         streaming=False)
    assert isinstance(cx[1], np.ndarray)
    np.testing.assert_array_equal(cx[1], x[5:9])


# ---------------------------------------------------------------------------
# participation schedulers: the reference's draws, draw for draw
# ---------------------------------------------------------------------------


class _FakeEng:
    """Just enough runner surface for a scheduler, for either package."""

    def __init__(self, pkg, pop, seed=0, rnd=3, participation="uniform"):
        config, state, het = ((JConfig, JState, JHet) if pkg == "jax"
                              else (FLConfig, TState, THet))
        self.cfg = config(num_clients=pop, seed=seed,
                          participation=participation)
        self.state = state(rng=np.random.default_rng(seed),
                           bound_state=None, round=rnd)
        self.het = het(pop, seed=seed, tier_weights=W, virtual=True)


def _pair(pop, sampler=None, **kw):
    """(port draw fn, reference draw fn) over twin engines."""
    out = []
    for pkg, build in (("torch", build_scheduler), ("jax", j_scheduler)):
        eng = _FakeEng(pkg, pop, **kw)
        s = build(eng.cfg) if sampler is None else sampler(pkg)
        s.setup(eng)
        out.append((eng, s))
    return out


def _same_draws(pop, k, exclude=frozenset(), rounds=(3, 4, 5), **kw):
    (te, ts), (je, js) = _pair(pop, **kw)
    drawn = []
    for rnd in rounds:
        te.state.round = je.state.round = rnd
        got = ts.sample(te.state, k, exclude)
        assert got == js.sample(je.state, k, exclude)
        assert len(got) == len(set(got)) and not set(got) & set(exclude)
        drawn.append(got)
    assert te.state.rng.bit_generator.state == \
        je.state.rng.bit_generator.state
    return drawn


@pytest.mark.parametrize("pop,exclude", [
    (100, frozenset()),                       # the synchronous loop's draw
    (30, frozenset({1, 5, 9})),               # the semi-async pool
    (_EXACT_POOL_MAX + 5_000, frozenset()),   # rejection sampling
    (1_000_000, frozenset({0, 1, 2})),        # rejection, with exclusions
])
def test_uniform_matches_reference(pop, exclude):
    drawn = _same_draws(pop, 10, exclude, seed=9)
    assert all(len(d) == 10 for d in drawn)


def test_uniform_exhausted_pool_returns_empty():
    assert _same_draws(4, 3, frozenset({0, 1, 2, 3}), rounds=(3,)) == [[]]


@pytest.mark.parametrize("pop", [300, 1_000_000])
@pytest.mark.parametrize("participation", ["availability", "resource_gated"])
def test_gated_schedulers_match_reference(participation, pop):
    drawn = _same_draws(pop, 20, frozenset({7}), seed=2,
                        participation=participation)
    assert all(0 < len(d) <= 20 for d in drawn)


@pytest.mark.parametrize("pop", [300, 1_000_000])
def test_availability_period_matches_reference(pop):
    from repro.fl.population import AvailabilityParticipation as JAvail
    from repro_torch.fl.population import AvailabilityParticipation

    _same_draws(pop, 12, seed=4, rounds=(1, 2, 3, 4, 5, 6),
                sampler=lambda pkg: (JAvail if pkg == "jax" else
                                     AvailabilityParticipation)(period=4))


@pytest.mark.parametrize("trace", [
    {3: [5, 9, 12, 40, 41], 4: [], 5: [999, 3]},
    lambda rnd, n: n % 2 == rnd % 2,
])
def test_trace_matches_reference(trace):
    draws = _same_draws(100, 3, sampler=lambda pkg: (
        JTrace if pkg == "jax" else TraceParticipation)(trace),
        rounds=(3, 4, 5, 7))
    if isinstance(trace, dict):
        assert set(draws[0]) <= {5, 9, 12, 40, 41} and draws[1] == []
        assert draws[2] == [3] and len(draws[3]) == 3  # 7: uniform
    _same_draws(10_000, 5, sampler=lambda pkg: (
        JTrace if pkg == "jax" else TraceParticipation)(
            lambda rnd, n: n % 3 == 0))


def test_trace_without_a_trace_raises():
    eng = _FakeEng("torch", 10)
    bare = TraceParticipation()
    bare.setup(eng)
    with pytest.raises(ValueError, match="no trace"):
        bare.sample(eng.state, 2)
    eng.availability_trace = {3: [1, 2, 3]}
    s = TraceParticipation()
    s.setup(eng)
    assert set(s.sample(eng.state, 5)) == {1, 2, 3}


def test_trace_through_the_engine_sampler_hook():
    """A trace mapping reaches the runner through ``build_engine``'s
    ``sampler`` hook, and a round's cohort comes from it."""
    from repro_torch.fl.engine import build_engine
    from repro_torch.fl.heterogeneity import HeterogeneityModel

    m, px, py, tb = build_setup("synthetic_image", num_clients=12, seed=0,
                                device="cpu")
    cfg = _cfg(participation="trace", clients_per_round=3)
    het = HeterogeneityModel(12, seed=0, tier_weights=W)
    with build_engine("heroes", m, px, py, tb, het, cfg, device="cpu",
                      sampler=TraceParticipation({0: [2, 5, 7, 11]})) as r:
        r.run_round()
        assert set(r.state.participation) <= {2, 5, 7, 11}
        assert len(r.state.participation) == 3


def test_build_scheduler_rejects_unknown():
    with pytest.raises(ValueError):
        build_scheduler(FLConfig(participation="nope"))


# ---------------------------------------------------------------------------
# edge groups
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,groups", [(10, 3), (2, 5), (7, 2), (6, 1),
                                      (5, 5)])
def test_assign_edge_groups_matches_reference(k, groups):
    clients = list(range(100, 100 + k))
    assert assign_edge_groups(clients, groups) == j_groups(clients, groups)


@pytest.mark.parametrize("k,groups", [(7, 2), (10, 3), (24, 4)])
def test_grouped_ordered_fold_matches_reference(k, groups):
    rng = np.random.default_rng(k * 31 + groups)
    stacked = rng.normal(size=(k, 9, 4)).astype(np.float32)
    size, padded = HierarchicalMerger(groups)._grouping(k)
    assert (size, padded) == JMerger(edge_groups=groups)._grouping(k)
    pad = np.concatenate([stacked, np.zeros((padded - k, 9, 4),
                                            np.float32)])
    total, parts = grouped_ordered_fold(torch.from_numpy(pad), size)
    jt, jp = j_fold(jnp.asarray(pad), size)
    # the carry chain is the flat left fold, bit for bit
    flat = torch.zeros(9, 4)
    for row in torch.from_numpy(stacked):
        flat = flat + row
    assert torch.equal(total, flat)
    np.testing.assert_allclose(total.numpy(), np.asarray(jt), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(parts.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-6)
    with pytest.raises(ValueError):
        grouped_ordered_fold(torch.from_numpy(stacked), k + 1)


def _cfg(package=FLConfig, **kw):
    return package(**{"num_clients": 12, "clients_per_round": 6,
                      "tau_fixed": 2, "eval_every": 1, "estimate": True,
                      "forward_impl": "materialize", **kw})


@pytest.mark.parametrize("scheme,groups,rounds", [
    ("heroes", 3, 1), ("heterofl", 2, 2), ("fedavg", 4, 1)])
def test_edge_groups_merge_bit_equal_and_partials(scheme, groups, rounds):
    """The merged state with edge groups equals the flat merge's bit for
    bit; the partials match the reference's within 1e-5 and recombine to
    the merged totals."""
    jm, jx, jy, jt = j_build_setup("synthetic_image", num_clients=12,
                                   seed=0)
    init = (jm.init_factorized if scheme == "heroes" else jm.init_dense)(
        jax.random.PRNGKey(0))
    tm, tx, ty, tt = build_setup("synthetic_image", num_clients=12, seed=0,
                                 device="cpu")
    runs = {}
    for g in (0, groups):
        r = build_runner(scheme, tm, tx, ty, tt, cfg=_cfg(edge_groups=g),
                         device="cpu")
        r.state = dataclasses.replace(r.state, params=from_jax_params(
            jax.device_get(init), "cpu"))
        r.run(rounds)
        runs[g] = r
    flat, hier = runs[0], runs[groups]
    assert flat.merger is None and isinstance(hier.merger,
                                              HierarchicalMerger)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(flat.params),
                                                 tree_leaves(hier.params)))
    assert flat.history == hier.history

    jr = j_build(scheme, jm, jx, jy, jt, cfg=_cfg(JConfig, edge_groups=groups))
    jr.run(rounds)
    want = jax.device_get(jr.merger.last_partials)
    got = to_numpy(hier.merger.last_partials)
    assert jax.tree_util.tree_structure(want) == \
        jax.tree_util.tree_structure(got)
    for a, b in zip(jax.tree_util.tree_leaves(want),
                    jax.tree_util.tree_leaves(got)):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)

    if scheme == "heroes":
        for name, p in hier.merger.last_partials.items():
            k = 6
            basis = p["bases"].sum(0) / k
            np.testing.assert_allclose(basis, hier.params[name]["basis"],
                                       rtol=1e-5, atol=1e-6)
            cnt = p["mask"].sum(0)
            trained = cnt > 0
            coeff = p["dense"].sum(0)[trained] / cnt[trained][:, None, None]
            np.testing.assert_allclose(
                coeff, hier.params[name]["coeff"][trained], rtol=1e-5,
                atol=1e-6)


def test_edge_groups_host_backend_has_no_merger():
    tm, tx, ty, tt = build_setup("synthetic_image", num_clients=12, seed=0,
                                 device="cpu")
    with build_runner("heroes", tm, tx, ty, tt,
                      cfg=_cfg(edge_groups=3, agg_backend="host"),
                      device="cpu") as r:
        assert r.merger is None
        r.run(1)


# ---------------------------------------------------------------------------
# virtual-population runs against the reference's
# ---------------------------------------------------------------------------


def _schedule(history):
    return [(h.round, h.wall_time, h.traffic_bytes, h.makespan, h.avg_wait,
             h.mean_tau, h.stale) for h in history]


@pytest.mark.parametrize("scheme,pop,rounds,kw", [
    ("heroes", 5000, 2, dict(clients_per_round=6, tau_fixed=2,
                             eval_every=2)),
    ("fedavg", 2000, 3, dict(clients_per_round=6, tau_fixed=2,
                             eval_every=5, round_mode="semi_async",
                             participation="availability")),
])
def test_population_run_matches_reference(scheme, pop, rounds, kw):
    setup_kw = dict(seed=0, population=pop,
                    partition_kw={"samples_per_client": 32})
    jm, jx, jy, jt = j_build_setup("synthetic_image", **setup_kw)
    tm, tx, ty, tt = build_setup("synthetic_image", device="cpu",
                                 **setup_kw)
    assert isinstance(tx, VirtualShardList) and len(tx) == pop
    cfg = dict(num_clients=pop, forward_impl="materialize", **kw)
    jr = j_build(scheme, jm, jx, jy, jt, cfg=JConfig(**cfg), seed=0)
    jh = jr.run(rounds)
    with build_runner(scheme, tm, tx, ty, tt, cfg=FLConfig(**cfg),
                      device="cpu") as r:
        init = (jm.init_factorized if scheme == "heroes"
                else jm.init_dense)(jax.random.PRNGKey(0))
        r.state = dataclasses.replace(r.state, params=from_jax_params(
            jax.device_get(init), "cpu"))
        assert r.population is tx.registry and r.het.virtual
        assert r.het.clients[pop - 1] == r.population.profile(pop - 1)
        th = r.run(rounds)
        assert r.state.participation == jr.state.participation
        assert r.population.participants() == len(r.state.participation)
    assert _schedule(th) == _schedule(jh)
    n_test = int(tt["labels"].shape[0])
    for a, b in zip(jh, th):
        if a.accuracy is not None:
            assert abs(a.accuracy - b.accuracy) <= 2.0 / n_test


def test_population_num_clients_mismatch_rejected():
    m, px, py, tb = build_setup("synthetic_image", seed=0, population=1000,
                                partition_kw={"samples_per_client": 16},
                                device="cpu")
    with pytest.raises(ValueError, match="virtual population"):
        build_runner("fedavg", m, px, py, tb, cfg=FLConfig(num_clients=999),
                     device="cpu")


# ---------------------------------------------------------------------------
# the runner's lifetime: close releases the prefetch worker
# ---------------------------------------------------------------------------


def _prefetch_threads():
    return [t for t in threading.enumerate()
            if t.name == "client-data-prefetch" and t.is_alive()]


def _wait_no_prefetch():
    deadline = time.monotonic() + 5.0
    while _prefetch_threads() and time.monotonic() < deadline:
        time.sleep(0.01)
    return not _prefetch_threads()


def test_runner_context_manager_closes_prefetch():
    m, px, py, tb = build_setup("synthetic_image", num_clients=12, seed=0,
                                device="cpu")
    with build_runner("heroes", m, px, py, tb, cfg=_cfg(trainer="cohort"),
                      device="cpu") as r:
        # a worker abandoned mid-stream, as a failing round body leaves it
        gen = r.data.prefetch(list(range(16)), lambda i: np.zeros(32))
        next(gen)
        assert _prefetch_threads()
    assert _wait_no_prefetch()


def test_cohort_trainer_closes_prefetch_on_error(monkeypatch):
    m, px, py, tb = build_setup("synthetic_image", num_clients=12, seed=0,
                                device="cpu")
    r = build_runner("heroes", m, px, py, tb, cfg=_cfg(trainer="cohort"),
                     device="cpu")
    monkeypatch.setattr(type(r.trainer), "_train_group",
                        lambda *a, **k: (_ for _ in ()).throw(
                            RuntimeError("boom")))
    with pytest.raises(RuntimeError, match="boom"):
        r.run_round()
    assert _wait_no_prefetch()
    r.close()
    r.close()  # idempotent
